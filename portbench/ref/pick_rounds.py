"""All LOAM feature pick rounds in one kernel: ``csrc/pick_rounds.cu`` on a
CUDA tensor, the plain PyTorch version below on a CPU tensor.

Replaces the Pallas kernel ``msf_loam_tpu/ops/pick_rounds.py``
(``pick_rounds_pallas``). Semantics are the JAX package's greedy rounds
composed as in ``extract_features``: sharp (T=1) -> less-sharp (T=rest_T)
-> flat (T=1) with chained suppression; per sector, iterated masked
argmax with ties to the lowest index; a within-round dominance test; and
+-nsup gap-chain suppression. The kernel and the plain version agree bit
for bit (they only compare floats). The kernel gets the same picks another
way: it sorts each sector's columns once per score plane (a cluster of
blocks per ring row) and walks them from a per-sector cursor (see the
note at the head of the source).
"""

from __future__ import annotations

from typing import Tuple

import torch


Tensor = torch.Tensor

_BIG = 1.0e18


def _round_plain(score: Tensor, suppressed: Tensor, sector: Tensor,
                 cb0: Tensor, S: int, T: int, nsup: int):
    """One pick round over all rows (R, W). Returns (suppressed, picks
    (T, R, S))."""
    R, W = score.shape
    dev = score.device
    iota = torch.arange(W, device=dev)
    avail = torch.where(suppressed, torch.full_like(score, -_BIG), score)
    sec_oh = sector[:, None, :] == torch.arange(S, device=dev)[None, :, None]
    per_sec = torch.where(sec_oh, avail[:, None, :],
                          torch.full((), -_BIG, dtype=score.dtype, device=dev))
    fi, fv = [], []
    for _ in range(T):
        m, idx = per_sec.max(dim=2)         # (R, S); first index of the max
        fi.append(idx)
        fv.append(m)
        per_sec = torch.where(iota == idx[..., None],
                              torch.full((), -_BIG, dtype=score.dtype,
                                         device=dev), per_sec)
    FI = torch.stack(fi, dim=2).reshape(R, S * T)     # column p = s*T + t
    FV = torch.stack(fv, dim=2).reshape(R, S * T)
    FOK = FV > -0.5 * _BIG
    FCB = torch.gather(cb0, 1, FI)
    di = (FI[:, :, None] - FI[:, None, :]).abs()       # [p, q]
    near = (di > 0) & (di <= nsup)
    unbroken = FCB[:, :, None] == FCB[:, None, :]
    better = (FV[:, None, :] > FV[:, :, None]) | (
        (FV[:, None, :] == FV[:, :, None]) & (FI[:, None, :] < FI[:, :, None]))
    dominated = (near & unbroken & better & FOK[:, None, :]).any(dim=2)
    keep = FOK & ~dominated
    near_w = (iota[None, None, :] - FI[:, :, None]).abs() <= nsup
    chain_w = cb0[:, None, :] == FCB[:, :, None]
    hit = (near_w & chain_w & keep[:, :, None]).any(dim=1)
    picks = torch.where(keep, FI, -1).reshape(R, S, T).permute(2, 0, 1)
    return suppressed | hit, picks.to(torch.int32)


def pick_rounds_plain(score_c: Tensor, score_f: Tensor, sector: Tensor,
                      cb0: Tensor, *, S: int, nsup: int, n_sharp: int,
                      n_rest: int, rest_T: int, n_flat: int
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the fused pick rounds."""
    sup = torch.zeros(score_c.shape, dtype=torch.bool, device=score_c.device)
    sector = sector.long()
    cb0 = cb0.long()
    corner = []
    for _ in range(n_sharp):
        sup, p = _round_plain(score_c, sup, sector, cb0, S, 1, nsup)
        corner.append(p)
    for _ in range(-(-n_rest // rest_T)):
        sup, p = _round_plain(score_c, sup, sector, cb0, S, rest_T, nsup)
        corner.append(p)
    sup_corner = sup
    flat = []
    for _ in range(n_flat):
        sup, p = _round_plain(score_f, sup, sector, cb0, S, 1, nsup)
        flat.append(p)
    return torch.cat(corner), torch.cat(flat), sup_corner


def pick_rounds(score_c: Tensor, score_f: Tensor, sector: Tensor,
                cb0: Tensor, *, S: int, nsup: int, n_sharp: int, n_rest: int,
                rest_T: int, n_flat: int) -> Tuple[Tensor, Tensor, Tensor]:
    """All feature pick rounds fused.

    Args:
      score_c: (R, W) f32 gated max-curvature score (-1e18 where unpickable).
      score_f: (R, W) f32 gated, negated min-curvature score.
      sector: (R, W) int32 sector id (-1 ineligible).
      cb0: (R, W) int32 exclusive prefix count of broken gap links.

    Returns (corner_picks (n_sharp + ceil(n_rest/rest_T)*rest_T, R, S),
    flat_picks (n_flat, R, S)) int32 W-indices (-1 = none), and the (R, W)
    bool suppression after the corner phases.
    """
    return pick_rounds_plain(score_c, score_f, sector, cb0, S=S,
                             nsup=nsup, n_sharp=n_sharp, n_rest=n_rest,
                             rest_T=rest_T, n_flat=n_flat)

