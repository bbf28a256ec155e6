"""Trajectory evaluation CLI: ATE RMSE / RPE against ground truth.

The port's copy of the JAX package's ``apps/evaluate.py`` (numpy; the
same numbers from the same files), the quantitative replacement for the
reference's manual rviz inspection: loads a trajectory artifact (run_slam
output) and KITTI ground truth, reports ATE RMSE (raw + SE(3)-aligned) and relative pose
error over fixed segment lengths.

Usage:
  python -m msf_loam_tpu_torch.apps.evaluate --trajectory traj.npz \
      --kitti_root DIR --sequence 00
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def rpe(est_t: np.ndarray, gt_t: np.ndarray, delta: int = 10) -> float:
    """Relative pose (translation) error RMSE over a frame delta."""
    n = min(len(est_t), len(gt_t)) - delta
    if n <= 0:
        return float("nan")
    d_est = est_t[delta:delta + n] - est_t[:n]
    d_gt = gt_t[delta:delta + n] - gt_t[:n]
    err = np.linalg.norm(d_est - d_gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def _quat_wxyz_to_R(q: np.ndarray) -> np.ndarray:
    """Batch wxyz quaternion -> rotation matrices (N, 3, 3)."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty(q.shape[:1] + (3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


KITTI_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def kitti_drift(est_t: np.ndarray, gt_t: np.ndarray,
                est_R: np.ndarray, gt_R: np.ndarray,
                lengths=KITTI_LENGTHS, step: int = 10) -> dict:
    """KITTI odometry drift metric: average translation error (%) and
    rotation error (deg/100 m) of relative poses over trajectory segments
    of fixed arclengths, the devkit's evaluate_odometry convention.

    For each start frame (every ``step``) and each segment length L, the
    pose error is inv(delta_gt) @ delta_est where delta = inv(T_i) @ T_j
    and j is the first frame at arclength >= s_i + L.
    """
    n = min(len(est_t), len(gt_t))
    dist = np.concatenate(
        [[0.0], np.cumsum(np.linalg.norm(np.diff(gt_t[:n], axis=0), axis=1))])
    t_err, r_err, cnt = {}, {}, {}
    for i in range(0, n, step):
        for L in lengths:
            j = int(np.searchsorted(dist, dist[i] + L))
            if j >= n:
                break
            dR_gt = gt_R[i].T @ gt_R[j]
            dt_gt = gt_R[i].T @ (gt_t[j] - gt_t[i])
            dR_e = est_R[i].T @ est_R[j]
            dt_e = est_R[i].T @ (est_t[j] - est_t[i])
            E_R = dR_gt.T @ dR_e
            E_t = dR_gt.T @ (dt_e - dt_gt)
            ang = np.arccos(np.clip((np.trace(E_R) - 1.0) / 2.0, -1.0, 1.0))
            t_err[L] = t_err.get(L, 0.0) + np.linalg.norm(E_t) / L
            r_err[L] = r_err.get(L, 0.0) + ang / L
            cnt[L] = cnt.get(L, 0) + 1
    if not cnt:
        return {"t_pct": None, "r_deg_per_100m": None, "segments": 0,
                "per_length": {}}
    per_length = {
        int(L): {"t_pct": round(100.0 * t_err[L] / cnt[L], 3),
                 "r_deg_per_100m": round(
                     np.degrees(r_err[L] / cnt[L]) * 100.0, 4),
                 "n": cnt[L]}
        for L in cnt}
    tot = sum(cnt.values())
    return {
        "t_pct": round(100.0 * sum(t_err.values()) / tot, 3),
        "r_deg_per_100m": round(
            np.degrees(sum(r_err.values()) / tot) * 100.0, 4),
        "segments": tot,
        "per_length": per_length,
    }


def rpe_rot_deg(est_R: np.ndarray, gt_R: np.ndarray, delta: int = 10) -> float:
    """Relative rotation error RMSE (degrees) over a frame delta: the
    angle of (gt_i^T gt_j)^T (est_i^T est_j)."""
    n = min(len(est_R), len(gt_R)) - delta
    if n <= 0:
        return float("nan")
    rel_est = np.einsum("nij,nik->njk", est_R[:n], est_R[delta:delta + n])
    rel_gt = np.einsum("nij,nik->njk", gt_R[:n], gt_R[delta:delta + n])
    E = np.einsum("nij,nik->njk", rel_gt, rel_est)
    tr = np.clip((np.einsum("nii->n", E) - 1.0) / 2.0, -1.0, 1.0)
    ang = np.degrees(np.arccos(tr))
    return float(np.sqrt((ang ** 2).mean()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trajectory", required=True, help="run_slam .npz output")
    ap.add_argument("--kitti_root")
    ap.add_argument("--sequence", default="00")
    ap.add_argument("--gt_npz", help="alternative GT: npz with 'translation'")
    ap.add_argument("--rpe_delta", type=int, default=10)
    args = ap.parse_args(argv)

    from msf_loam_tpu_torch.dataio.artifacts import load_trajectory
    from msf_loam_tpu_torch.slam.pipeline import ate_rmse

    traj = load_trajectory(args.trajectory)
    est_t = traj["translation"]
    est_R = (_quat_wxyz_to_R(traj["rotation_wxyz"])
             if "rotation_wxyz" in traj else None)

    gt_R = None
    if args.gt_npz:
        gt = load_trajectory(args.gt_npz)
        gt_t = gt["translation"]
        if "rotation_wxyz" in gt:
            gt_R = _quat_wxyz_to_R(gt["rotation_wxyz"])
    elif args.kitti_root:
        from msf_loam_tpu_torch.dataio.kitti import KittiSequence
        seq = KittiSequence(args.kitti_root, args.sequence)
        if seq.gt_poses is None:
            print("error: no ground-truth poses found", file=sys.stderr)
            return 2
        gt_t = seq.gt_poses[:, :3, 3]
        gt_R = seq.gt_poses[:, :3, :3]
    else:
        print("error: --kitti_root or --gt_npz required", file=sys.stderr)
        return 2

    n = min(len(est_t), len(gt_t))
    est_t, gt_t = est_t[:n], gt_t[:n]
    gt_t = gt_t - gt_t[0]

    rpe_val = rpe(est_t, gt_t, args.rpe_delta)
    out = {
        "frames": n,
        "ate_rmse_m": round(ate_rmse(est_t, gt_t, align=False), 4),
        "ate_rmse_aligned_m": round(ate_rmse(est_t, gt_t, align=True), 4),
        f"rpe_{args.rpe_delta}_m": None if np.isnan(rpe_val) else round(rpe_val, 4),
        "trajectory_length_m": round(float(
            np.linalg.norm(np.diff(gt_t, axis=0), axis=1).sum()), 1),
    }
    if est_R is not None and gt_R is not None:
        rot_val = rpe_rot_deg(est_R[:n], gt_R[:n], args.rpe_delta)
        out[f"rpe_{args.rpe_delta}_rot_deg"] = (
            None if np.isnan(rot_val) else round(rot_val, 3))
        drift = kitti_drift(est_t, gt_t, est_R[:n], gt_R[:n])
        if drift["segments"]:
            out["kitti_t_pct"] = drift["t_pct"]
            out["kitti_r_deg_per_100m"] = drift["r_deg_per_100m"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
