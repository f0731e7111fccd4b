"""Meshes, cameras and seeded inputs of the benchmark (numpy and torch).

Frozen copies of the procedural mesh and camera matrices the samples use
(``uv_sphere``, ``projection``, ``translate`` and
``random_rotation_translation``), so that the benchmark's inputs do not
move when the program's helpers change. The program and the reference
are handed the same arrays and tensors made here.
"""

import numpy as np
import torch


def uv_sphere(n_lat, n_lon, radius=1.0):
    """UV sphere: (tri [T, 3] int32, vtx [V, 3] float32, uv_tri [T, 3],
    uv [V, 2] float32); the date-line column and the pole rows hold
    duplicated vertices, so the uvs are continuous within each triangle."""
    lats = np.linspace(0.0, np.pi, n_lat + 1)
    lons = np.linspace(0.0, 2 * np.pi, n_lon + 1)
    tt, pp = np.meshgrid(lats, lons, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    vtx = (radius * np.stack([x, y, z], axis=-1)).reshape(-1, 3).astype(np.float32)
    uv = np.stack([pp / (2 * np.pi), tt / np.pi], axis=-1).reshape(-1, 2).astype(np.float32)
    idx = np.arange((n_lat + 1) * (n_lon + 1)).reshape(n_lat + 1, n_lon + 1)
    a, b = idx[:-1, :-1], idx[:-1, 1:]
    c, d = idx[1:, :-1], idx[1:, 1:]
    upper = np.stack([a, b, c], axis=-1)[1:]      # rows i > 0
    lower = np.stack([b, d, c], axis=-1)[:-1]     # rows i < n_lat - 1
    # Row by row, and within a row (upper, lower) per longitude step.
    tris = []
    for i in range(n_lat):
        parts = []
        if i > 0:
            parts.append(upper[i - 1])
        if i < n_lat - 1:
            parts.append(lower[i])
        tris.append(np.stack(parts, axis=1).reshape(-1, 3))
    tri = np.concatenate(tris).astype(np.int32)
    return tri, vtx, tri.copy(), uv


def projection(x=0.1, n=1.0, f=50.0):
    """GL-convention perspective projection matrix."""
    return np.array([[n / x, 0, 0, 0],
                     [0, n / x, 0, 0],
                     [0, 0, -(f + n) / (f - n), -(2 * f * n) / (f - n)],
                     [0, 0, -1, 0]], dtype=np.float32)


def translate(x, y, z):
    return np.array([[1, 0, 0, x], [0, 1, 0, y], [0, 0, 1, z], [0, 0, 0, 1]],
                    dtype=np.float32)


def random_rotation_translation(t, rng):
    """Uniform random rotation (a normalised 4-D Gaussian quaternion) and
    a uniform translation in [-t, t]^3, as a 4x4 matrix."""
    while True:
        q = rng.normal(size=4)
        n = np.linalg.norm(q)
        if n > 1e-6:
            break
    w, x, y, z = q / n
    m = np.eye(4)
    m[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                 [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                 [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    m[:3, 3] = rng.uniform(-t, t, size=3)
    return m.astype(np.float32)


def view_matrices(camera, n_views, rng):
    """[n_views, 4, 4] float32 object-to-clip matrices: the config's
    projection and translation after a seeded rotation per view."""
    base = projection(x=camera["projection_x"]) @ translate(*camera["translate"])
    return np.stack([base @ random_rotation_translation(camera["jitter_t"], rng)
                     for _ in range(n_views)]).astype(np.float32)


def generator(seed, device, stream):
    """A torch.Generator on `device` for one named stream of a seed, so
    each input is drawn the same way whatever else is drawn."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def smooth_targets(n, H, W, C, seed, device, grid=32):
    """[n, H, W, C] float32 seeded target images: uniform noise on a
    coarse grid, upsampled bilinearly, in one draw and one resize."""
    g = generator(seed, device, 7)
    coarse = torch.rand((n, C, grid, grid), generator=g, device=device)
    img = torch.nn.functional.interpolate(coarse, size=(H, W), mode="bilinear",
                                          align_corners=False)
    return img.permute(0, 2, 3, 1).contiguous()


def batch_order(seed, pool, per_step, n_steps):
    """Pool indices of each step's views: successive batches of a seeded
    permutation, a new permutation whenever the pool runs out, so every
    seed draws the same batch sizes in another order."""
    rng = np.random.default_rng([int(seed), 11])
    order = []
    while len(order) < n_steps * per_step:
        order.extend(rng.permutation(pool).tolist())
    return [order[i * per_step:(i + 1) * per_step] for i in range(n_steps)]
