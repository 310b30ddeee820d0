"""SE(3) / SO(3) utilities on torch tensors.

Counterpart of ``slam_tpu/ops/se3.py``: closed-form functions on 4x4
homogeneous matrices and 3x3 rotations, batched over any leading
dimensions. Two conventions appear in the pipeline, documented at each
call site: extrinsics ``T_w2c`` (world -> camera) and poses ``T_c2w``.

The small-angle branches of :func:`so3_exp`, :func:`se3_exp` and
:func:`se3_log` are kept exactly: in float32 the closed forms lose all
precision below theta ~ 0.03 rad, and ``1 - cos`` rounds to 0 below
theta ~ 3.5e-4, which made NaN residuals on tiny-rotation pose-graph
edges at reference scale.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
# Taylor-branch threshold on theta^2, sized for float32
_SMALL_THETA2 = 1e-3


def _eye3(like: torch.Tensor, batch: tuple) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        batch + (3, 3))


def mv3(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3) as explicit mult-adds."""
    return (A[..., :, 0] * v[..., 0, None]
            + A[..., :, 1] * v[..., 1, None]
            + A[..., :, 2] * v[..., 2, None])


def mm33(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3, 3) as explicit mult-adds."""
    return (A[..., :, 0, None] * B[..., 0, None, :]
            + A[..., :, 1, None] * B[..., 1, None, :]
            + A[..., :, 2, None] * B[..., 2, None, :])


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _rodrigues_coeffs(theta2: torch.Tensor):
    """(a, b, theta, small) of R = I + a W + b W^2, with the float32
    Taylor branch below theta^2 = _SMALL_THETA2 and (1 - cos) computed as
    2 sin^2(theta / 2)."""
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _SMALL_THETA2
    s_half = torch.sin(0.5 * theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    2.0 * s_half * s_half / theta2)
    return a, b, theta, small


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: rotation vector (..., 3) -> rotation matrix."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _, _ = _rodrigues_coeffs(theta2)
    W = hat(w)
    W2 = mm33(W, W)
    return (_eye3(w, W.shape[:-2]) + a[..., None, None] * W
            + b[..., None, None] * W2)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> rotation vector (..., 3), with the
    theta -> 0 and theta -> pi regimes handled."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    sin_t = torch.sin(theta)
    anti = vee(R - R.transpose(-1, -2))
    safe_sin = torch.where(torch.abs(sin_t) < _EPS, torch.ones_like(sin_t),
                           sin_t)
    w_generic = anti * (0.5 * theta / safe_sin)[..., None]
    w_small = anti * 0.5
    # near pi: axis from the largest diagonal of (R + I)
    Rp = R + _eye3(R, R.shape[:-2])
    diag = torch.stack([Rp[..., 0, 0], Rp[..., 1, 1], Rp[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(
        Rp, -1, k[..., None, None].expand(R.shape[:-2] + (3, 1)))[..., 0]
    axis = col / (torch.linalg.vector_norm(col, dim=-1, keepdim=True) + _EPS)
    w_pi = axis * theta[..., None]
    near_pi = cos_t < -1.0 + 1e-6
    small = theta < 1e-5
    return torch.where(small[..., None], w_small,
                       torch.where(near_pi[..., None], w_pi, w_generic))


def rotation_angle_deg(R: torch.Tensor) -> torch.Tensor:
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos_t))


def rotation_ypr(R: torch.Tensor) -> torch.Tensor:
    """Yaw-pitch-roll (Z-Y-X Euler) of a rotation matrix, (..., 3)."""
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([yaw, pitch, roll], dim=-1)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble a 4x4 homogeneous matrix from (..., 3, 3) and (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def rot(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def trans(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse."""
    Rt = rot(T).transpose(-1, -2)
    return make_T(Rt, -mv3(Rt, trans(T)))


def between(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """gtsam-style ``A.between(B) = A^-1 B``."""
    return inverse(A) @ B


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    R = rot(T)
    out = (pts[..., :, 0, None] * R[..., None, :, 0]
           + pts[..., :, 1, None] * R[..., None, :, 1]
           + pts[..., :, 2, None] * R[..., None, :, 2])
    return out + trans(T)[..., None, :]


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map: twist (..., 6) [w, v] -> 4x4 homogeneous matrix."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    a, b, theta, small = _rodrigues_coeffs(theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    W = hat(w)
    W2 = mm33(W, W)
    eye = _eye3(xi, W.shape[:-2])
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return make_T(R, mv3(V, v))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Log map: 4x4 -> twist (..., 6) [w, v]. Inverse of :func:`se3_exp`.

    V^-1 = I - W/2 + (1/theta^2)(1 - (theta/2) cot(theta/2)) W^2, with a
    float32 Taylor branch (the naive a/b form divides by an underflowing
    (1 - cos)/theta^2)."""
    w = so3_log(rot(T))
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = mm33(W, W)
    small = theta2 < _SMALL_THETA2
    s_half = torch.sin(0.5 * theta)
    c_half = torch.cos(0.5 * theta)
    cot_term = 0.5 * theta * c_half / torch.where(
        torch.abs(s_half) < _EPS, torch.ones_like(s_half), s_half)
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - cot_term) / theta2)
    Vinv = _eye3(T, W.shape[:-2]) - 0.5 * W + coef[..., None, None] * W2
    return torch.cat([w, mv3(Vinv, trans(T))], dim=-1)


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Right-multiplicative retraction ``T * exp(xi)``."""
    return T @ se3_exp(xi)


def local(T0: torch.Tensor, T1: torch.Tensor) -> torch.Tensor:
    """Local coordinates of T1 around T0: ``log(T0^-1 T1)``."""
    return se3_log(between(T0, T1))


def project_to_so3(R: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix via SVD."""
    U, _, Vt = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vt)
    S = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    return (U * S[..., None, :]) @ Vt
