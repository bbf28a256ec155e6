"""SE(3) / quaternion algebra on batched torch tensors.

Conventions are those of the JAX package's ``core/se3.py``:

* quaternions are ``[w, x, y, z]`` (Hamilton, scalar first);
* a pose is ``(t, q)`` with ``x_world = R(q) @ x_local + t``;
* tangent updates are right-multiplicative: ``t <- t + dt``,
  ``q <- q * exp(dtheta)``.

Every function broadcasts over leading batch dims and stays on the device
of its inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


def quat_identity(device=None, dtype=torch.float32) -> Tensor:
    # built by kernels on the device: a host tensor copy would synchronise
    q = torch.zeros(4, dtype=dtype, device=device)
    q[0] = 1.0
    return q


def cross(a: Tensor, b: Tensor) -> Tensor:
    """Cross product over the last axis (jnp.cross's component formula)."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def quat_multiply(q1: Tensor, q2: Tensor) -> Tensor:
    """Hamilton product q1 * q2, batched over leading dims."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conjugate(q: Tensor) -> Tensor:
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def quat_normalize(q: Tensor, eps: float = 1e-12) -> Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector(s) v by quaternion(s) q (15-multiply form)."""
    w = q[..., 0:1]
    u, v = torch.broadcast_tensors(q[..., 1:4], v)
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_matrix(q: Tensor) -> Tensor:
    """Quaternion -> rotation matrix: (..., 4) -> (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_exp(theta: Tensor) -> Tensor:
    """so(3) tangent -> unit quaternion exp([0, theta/2]), with the Taylor
    fallback of the reference's ``Utility::deltaQ`` for small angles."""
    sq = torch.sum(theta * theta, dim=-1, keepdim=True)
    small = sq < 1e-12
    safe_sq = torch.where(small, torch.ones_like(sq), sq)
    angle = torch.sqrt(safe_sq)
    half = 0.5 * angle
    sinc_half = torch.where(small, 0.5 - sq / 48.0 + sq * sq / 3840.0,
                            torch.sin(half) / angle)
    w = torch.where(small, 1.0 - sq / 8.0 + sq * sq / 384.0, torch.cos(half))
    return torch.cat([w, sinc_half * theta], dim=-1)


def quat_slerp(q0: Tensor, q1: Tensor, s: Tensor) -> Tensor:
    """Spherical interpolation q0 (s=0) -> q1 (s=1) along the shortest
    arc, falling back to lerp for nearly parallel quaternions; ``s`` is
    (...,) or (..., 1)."""
    if s.dim() == q0.dim() - 1:
        s = s[..., None]
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(dot.abs(), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    near = sin_theta < 1e-6
    den = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(near, 1.0 - s, torch.sin((1.0 - s) * theta) / den)
    w1 = torch.where(near, s, torch.sin(s * theta) / den)
    return quat_normalize(w0 * q0 + w1 * q1)


def skew(v: Tensor) -> Tensor:
    """Cross-product matrix: (..., 3) -> (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def _quat_lr(q: Tensor, sign: float) -> Tensor:
    w, v = q[..., 0], q[..., 1:4]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    top = torch.cat([w[..., None, None], -v[..., None, :]], dim=-1)
    bottom = torch.cat([v[..., :, None],
                        w[..., None, None] * eye + sign * skew(v)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def quat_left(q: Tensor) -> Tensor:
    """Left-multiplication matrix: quat_multiply(q, p) == quat_left(q) @ p."""
    return _quat_lr(q, 1.0)


def quat_right(q: Tensor) -> Tensor:
    """Right-multiplication matrix: quat_multiply(p, q) == quat_right(q) @ p."""
    return _quat_lr(q, -1.0)


class Pose(NamedTuple):
    """SE(3) pose: x_world = R(q) @ x_local + t."""

    t: Tensor  # (..., 3)
    q: Tensor  # (..., 4) [w, x, y, z]

    @staticmethod
    def identity(device=None, dtype=torch.float32,
                 batch_shape=()) -> "Pose":
        """The identity pose, or a ``batch_shape`` batch of them."""
        batch_shape = tuple(batch_shape)
        q = quat_identity(device, dtype)
        if batch_shape:
            q = q.expand(batch_shape + (4,)).contiguous()
        return Pose(torch.zeros(batch_shape + (3,), dtype=dtype,
                                device=device), q)

    def compose(self, other: "Pose") -> "Pose":
        """self * other (apply other first, then self), normalised."""
        return Pose(t=quat_rotate(self.q, other.t) + self.t,
                    q=quat_normalize(quat_multiply(self.q, other.q)))

    def inverse(self) -> "Pose":
        qinv = quat_conjugate(self.q)
        return Pose(t=-quat_rotate(qinv, self.t), q=qinv)

    def apply(self, points: Tensor) -> Tensor:
        """Transform points (N, 3) or (3,) by this pose, or (B, N, 3) by B
        poses (one per lane)."""
        if points.dim() >= 2 and self.q.dim() == 1:
            R = quat_to_matrix(self.q)
            return points @ R.T + self.t
        if points.dim() == 3 and self.q.dim() == 2:
            R = quat_to_matrix(self.q)
            return points @ R.transpose(1, 2) + self.t[:, None, :]
        return quat_rotate(self.q, points) + self.t

    def retract(self, delta: Tensor) -> "Pose":
        """Right-plus with a 6-vector [dt(3), dtheta(3)]."""
        return Pose(t=self.t + delta[..., 0:3],
                    q=quat_normalize(quat_multiply(self.q,
                                                   quat_exp(delta[..., 3:6]))))

    def to_vec7(self) -> Tensor:
        """[t(3), qx, qy, qz, qw] (Rigid3::ToVector7 layout)."""
        return torch.cat([self.t, self.q[..., 1:4], self.q[..., 0:1]], dim=-1)


def select_pose(cond: Tensor, a: Pose, b: Pose) -> Pose:
    """Elementwise ``a if cond else b`` for a 0-d boolean tensor, or per
    lane for (B,) conditions and poses, on the device (no host
    synchronisation)."""
    c = cond[..., None]
    return Pose(torch.where(c, a.t, b.t), torch.where(c, a.q, b.q))
