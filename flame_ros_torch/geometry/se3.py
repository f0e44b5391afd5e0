"""SE(3) rigid transforms as (quaternion, translation) torch tensors.

Counterpart of `flame_ros_tpu/geometry/se3.py`. Every op broadcasts over
leading axes. Quaternion convention: (w, x, y, z), unit norm, Hamilton
product. Poses map camera coordinates to world coordinates:
X_w = R X_c + t. The JAX package's HIGHEST-precision einsums are plain
f32 elementwise products and sums here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _t(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32)
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class SE3(NamedTuple):
    """Batchable rigid transform. q: [..., 4] (w,x,y,z); t: [..., 3]."""
    q: torch.Tensor
    t: torch.Tensor

    # ---- constructors -------------------------------------------------
    @staticmethod
    def identity(batch_shape=(), device=None) -> "SE3":
        q = torch.zeros((*batch_shape, 4), dtype=torch.float32,
                        device=device)
        q[..., 0] = 1.0
        return SE3(q, torch.zeros((*batch_shape, 3), dtype=torch.float32,
                                  device=device))

    @staticmethod
    def from_matrix(T, device=None) -> "SE3":
        T = _t(T, device)
        return SE3(quat_from_matrix(T[..., :3, :3]), T[..., :3, 3])

    @staticmethod
    def from_quat_trans(q, t, *, xyzw: bool = False, device=None) -> "SE3":
        q = _t(q, device)
        t = _t(t, device)
        if xyzw:  # ROS / TUM ordering (x,y,z,w) -> (w,x,y,z)
            q = torch.cat([q[..., 3:4], q[..., :3]], dim=-1)
        return SE3(quat_normalize(q), t)

    # ---- core ops -----------------------------------------------------
    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: apply `other` first, then `self`."""
        return SE3(quat_mul(self.q, other.q),
                   quat_rotate(self.q, other.t) + self.t)

    def __matmul__(self, other):
        if isinstance(other, SE3):
            return self.compose(other)
        return self.apply(other)

    def inverse(self) -> "SE3":
        qinv = quat_conj(self.q)
        return SE3(qinv, -quat_rotate(qinv, self.t))

    def apply(self, pts) -> torch.Tensor:
        """Transform points [..., 3]."""
        return quat_rotate(self.q, pts) + self.t

    def rotate(self, vecs) -> torch.Tensor:
        return quat_rotate(self.q, vecs)

    def matrix(self) -> torch.Tensor:
        R = matrix_from_quat(self.q)
        top = torch.cat([R, self.t[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                              device=R.device).expand(*top.shape[:-2], 1, 4)
        return torch.cat([top, bottom], dim=-2)

    # ---- manifold ops -------------------------------------------------
    @staticmethod
    def exp(tau, device=None) -> "SE3":
        """Exponential map from twist tau = [v, omega] ([..., 6])."""
        tau = _t(tau, device)
        v, omega = tau[..., :3], tau[..., 3:]
        theta = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)
        q = quat_exp(omega)
        t = _so3_left_jacobian_apply(omega, theta, v)
        return SE3(q, t)

    def log(self) -> torch.Tensor:
        omega = quat_log(self.q)
        theta = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)
        v = _so3_left_jacobian_inv_apply(omega, theta, self.t)
        return torch.cat([v, omega], dim=-1)

    # ---- misc ---------------------------------------------------------
    def normalize(self) -> "SE3":
        return SE3(quat_normalize(self.q), self.t)

    def as_array(self) -> torch.Tensor:
        """Pack to [..., 7] = (qw,qx,qy,qz,tx,ty,tz)."""
        return torch.cat([self.q, self.t], dim=-1)

    @staticmethod
    def from_array(a, device=None) -> "SE3":
        a = _t(a, device)
        return SE3(a[..., :4], a[..., 4:7])


# ---------------------------------------------------------------------------
# Quaternion algebra (Hamilton, (w,x,y,z))
# ---------------------------------------------------------------------------

def cross(a, b):
    """Cross product in the JAX package's term order (jnp.cross)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(a, b):
    aw, ax, ay, az = (a[..., i] for i in range(4))
    bw, bx, by, bz = (b[..., i] for i in range(4))
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v [..., 3] by quaternions q [..., 4]."""
    qv = q[..., 1:]
    uv = 2.0 * cross(qv, v)
    return v + q[..., :1] * uv + cross(qv, uv)


def matrix_from_quat(q):
    w, x, y, z = (q[..., i] for i in range(4))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    R = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return R.reshape(*q.shape[:-1], 3, 3)


def quat_from_matrix(R):
    """Shepperd's method, branchless for batching."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1 + tr, 1 + m00 - m11 - m22,
                      1 - m00 + m11 - m22, 1 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) / 2.0
    c0 = torch.stack([qw[..., 0], (m21 - m12) / (4 * qw[..., 0]),
                      (m02 - m20) / (4 * qw[..., 0]),
                      (m10 - m01) / (4 * qw[..., 0])], -1)
    c1 = torch.stack([(m21 - m12) / (4 * qw[..., 1]), qw[..., 1],
                      (m01 + m10) / (4 * qw[..., 1]),
                      (m02 + m20) / (4 * qw[..., 1])], -1)
    c2 = torch.stack([(m02 - m20) / (4 * qw[..., 2]),
                      (m01 + m10) / (4 * qw[..., 2]),
                      qw[..., 2], (m12 + m21) / (4 * qw[..., 2])], -1)
    c3 = torch.stack([(m10 - m01) / (4 * qw[..., 3]),
                      (m02 + m20) / (4 * qw[..., 3]),
                      (m12 + m21) / (4 * qw[..., 3]), qw[..., 3]], -1)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.take_along_dim(cands, idx[..., None, None], dim=-2)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)   # canonical sign: w >= 0
    return quat_normalize(q)


def quat_exp(omega):
    """so(3) -> unit quaternion."""
    sq = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(sq + 1e-24)
    half = 0.5 * theta
    small = sq < 1e-12
    th_safe = torch.where(small, torch.ones_like(theta), theta)
    k = torch.where(small, 0.5 - sq / 48.0,
                    torch.sin(0.5 * th_safe) / th_safe)
    w = torch.cos(half)
    return torch.cat([w, k * omega], dim=-1)


def quat_log(q):
    """Unit quaternion -> so(3)."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    sq = torch.sum(q[..., 1:] ** 2, dim=-1, keepdim=True)
    vn = torch.sqrt(sq + 1e-24)
    small = sq < 1e-12
    vn_safe = torch.where(small, torch.ones_like(vn), vn)
    theta = 2.0 * torch.atan2(vn, w)
    k = torch.where(small, 2.0 / torch.clamp(w, min=1e-6), theta / vn_safe)
    return k * q[..., 1:]


def _hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z],
                       dim=-1).reshape(*w.shape[:-1], 3, 3)


def _matvec(M, v):
    return torch.sum(M * v[..., None, :], dim=-1)


def _so3_left_jacobian_apply(omega, theta, v):
    W = _hat(omega)
    small = theta[..., 0] < 1e-5
    th = torch.where(small, torch.ones_like(theta[..., 0]), theta[..., 0])
    A = torch.where(small, torch.full_like(th, 0.5),
                    (1 - torch.cos(th)) / th ** 2)[..., None]
    B = torch.where(small, torch.full_like(th, 1.0 / 6.0),
                    (th - torch.sin(th)) / th ** 3)[..., None]
    Wv = _matvec(W, v)
    WWv = _matvec(W, Wv)
    return v + A * Wv + B * WWv


def _so3_left_jacobian_inv_apply(omega, theta, t):
    W = _hat(omega)
    small = theta[..., 0] < 1e-5
    th = torch.where(small, torch.ones_like(theta[..., 0]), theta[..., 0])
    half = 0.5 * th
    cot_coef = (1.0 - half * torch.cos(half) / torch.sin(half)) / th ** 2
    C = torch.where(small, torch.full_like(th, 1.0 / 12.0),
                    cot_coef)[..., None]
    Wt = _matvec(W, t)
    WWt = _matvec(W, Wt)
    return t - 0.5 * Wt + C * WWt


def random_se3(rng: np.random.Generator, sigma_rot: float = 1.0,
               sigma_trans: float = 1.0, device=None) -> SE3:
    """Random pose for tests and the pose-noise ablation harness
    (reference: the disabled Gaussian SE3 noise block,
    src/flame_offline_tum.cc:438-489): the same numpy draws as the JAX
    package's, rotation first, then `SE3.exp`."""
    omega = rng.normal(0, sigma_rot, 3).astype(np.float32)
    v = rng.normal(0, sigma_trans, 3).astype(np.float32)
    return SE3.exp(np.concatenate([v, omega]), device=device)
