"""Projection / transformation matrices (numpy only).

Copies of the numpy helpers of ``nvdiffrast_tpu.utils.camera``:
GL-style perspective projection, 4x4 matrices applied as ``M @ p`` to a
column [x, y, z, 1]. Same random stream for the same generator, so a
scene built here equals the one the JAX package builds.
"""

import numpy as np


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
