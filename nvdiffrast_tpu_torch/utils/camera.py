"""Projection / transformation matrices and quaternions.

Counterpart of ``nvdiffrast_tpu.utils.camera``: GL-style perspective
projection, 4x4 matrices applied as ``M @ p`` to a column [x, y, z, 1].
The matrix builders and the random draws are numpy, with the same random
stream for the same generator, so a scene built here equals the one the
JAX package builds; ``transform_pos``, ``q_mul`` and ``q_to_mtx`` are
torch, differentiable.
"""

import numpy as np
import torch


def projection(x=0.1, n=1.0, f=50.0):
    """GL-convention perspective projection matrix."""
    return np.array([
        [n / x, 0, 0, 0],
        [0, n / x, 0, 0],
        [0, 0, -(f + n) / (f - n), -(2 * f * n) / (f - n)],
        [0, 0, -1, 0]], dtype=np.float32)


def translate(x, y, z):
    return np.array([
        [1, 0, 0, x],
        [0, 1, 0, y],
        [0, 0, 1, z],
        [0, 0, 0, 1]], dtype=np.float32)


def rotate_x(a):
    s, c = np.sin(a), np.cos(a)
    return np.array([
        [1, 0, 0, 0],
        [0, c, -s, 0],
        [0, s, c, 0],
        [0, 0, 0, 1]], dtype=np.float32)


def rotate_y(a):
    s, c = np.sin(a), np.cos(a)
    return np.array([
        [c, 0, s, 0],
        [0, 1, 0, 0],
        [-s, 0, c, 0],
        [0, 0, 0, 1]], dtype=np.float32)


def _quat_to_rot3(q):
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float64)


def q_rnd(rng=None):
    """Uniform random unit quaternion (normalized 4-D Gaussian)."""
    rng = rng or np.random
    while True:
        q = rng.normal(size=[4])
        n = np.linalg.norm(q)
        if n > 1e-6:
            return (q / n).astype(np.float32)


def random_rotation_translation(t, rng=None):
    """Uniform random rotation + uniform translation in [-t, t]^3."""
    rng = rng or np.random
    m = np.eye(4)
    m[:3, :3] = _quat_to_rot3(q_rnd(rng))
    m[:3, 3] = rng.uniform(-t, t, size=[3])
    return m.astype(np.float32)


def transform_pos(mtx, pos):
    """Apply a 4x4 matrix to [V, 3] positions -> clip-space [1, V, 4],
    on the device of `pos` (a tensor) and differentiable in both."""
    mtx = torch.as_tensor(mtx, dtype=torch.float32, device=pos.device)
    posw = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
    return (posw @ mtx.T)[None]


# Quaternions (w, x, y, z), as the pose fitting uses them.

def q_unit():
    return np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)


def q_scale_small(q, scale, rng=None):
    """Shrink rotation `q` toward the identity by factor `scale`: the
    short-arc slerp(identity, q, scale), so the angle scales about
    linearly with `scale` (numpy). `rng` is accepted and unused, as in
    the reference."""
    del rng
    q = np.asarray(q, np.float64)
    if q[0] < 0.0:  # short arc: identity is (1, 0, 0, 0)
        q = -q
    omega = np.arccos(np.clip(q[0], -1.0, 1.0))
    if omega < 1e-6:
        out = q_unit() + scale * (q - q_unit())
    else:
        s = np.sin(omega)
        out = (np.sin((1.0 - scale) * omega) / s) * q_unit() \
            + (np.sin(scale * omega) / s) * q
    return (out / np.linalg.norm(out)).astype(np.float32)


def q_mul(p, q):
    """Quaternion product p * q of two [4] tensors."""
    s1, v1 = p[0], p[1:]
    s2, v2 = q[0], q[1:]
    s = s1 * s2 - torch.dot(v1, v2)
    v = s1 * v2 + s2 * v1 + torch.linalg.cross(v1, v2)
    return torch.cat([s[None], v])


def q_to_mtx(q):
    """Quaternion [4] tensor (w, x, y, z) -> 4x4 rotation matrix,
    normalising q first; differentiable."""
    q = q / torch.linalg.norm(q)
    w, x, y, z = q[0], q[1], q[2], q[3]
    r = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])
    top = torch.cat([r, q.new_zeros((3, 1))], dim=1)
    return torch.cat([top, q.new_tensor([[0.0, 0.0, 0.0, 1.0]])])


def q_angle_deg(q1, q2):
    """Angular difference of two unit quaternions in degrees."""
    d = abs(float(np.dot(np.asarray(q1, np.float64), np.asarray(q2, np.float64))))
    return float(np.degrees(2.0 * np.arccos(min(d, 1.0))))
