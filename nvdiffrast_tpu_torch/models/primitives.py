"""Procedural meshes (numpy only).

Copies of ``nvdiffrast_tpu.models.primitives``' ``cube_continuous``,
``cube_discontinuous`` and ``uv_sphere`` (the same arrays), kept free of
any JAX import.
"""

import numpy as np


def cube_continuous():
    """8-vertex cube with shared vertices (cube_c equivalent).

    Returns (pos_idx [12,3] i32, vtx_pos [8,3] f32, col_idx, vtx_col [8,3]).
    """
    vtx = np.array([
        [-0.5, -0.5, -0.5], [0.5, -0.5, -0.5], [-0.5, 0.5, -0.5], [0.5, 0.5, -0.5],
        [-0.5, -0.5, 0.5], [0.5, -0.5, 0.5], [-0.5, 0.5, 0.5], [0.5, 0.5, 0.5],
    ], np.float32)
    # 12 triangles, two per face, consistent outward winding.
    tri = np.array([
        [0, 2, 1], [1, 2, 3],  # -z
        [4, 5, 6], [5, 7, 6],  # +z
        [0, 4, 2], [2, 4, 6],  # -x
        [1, 3, 5], [3, 7, 5],  # +x
        [0, 1, 4], [1, 5, 4],  # -y
        [2, 6, 3], [3, 6, 7],  # +y
    ], np.int32)
    col = (vtx + 0.5).astype(np.float32)  # position-derived vertex colors
    return tri, vtx, tri.copy(), col


def cube_discontinuous():
    """24-vertex cube with per-face split vertices (cube_d equivalent):
    every face has its own 4 vertices, the topology that stresses the
    antialias silhouette classification."""
    tri_c, vtx_c, _, _ = cube_continuous()
    vtx6 = vtx_c[tri_c.reshape(-1)].reshape(6, 6, 3)
    out_v = []
    out_t = []
    rng = np.random.RandomState(0)
    for f in range(6):
        uniq, inv = np.unique(vtx6[f].round(6), axis=0, return_inverse=True)
        base = len(np.concatenate(out_v)) if out_v else 0
        out_v.append(uniq.astype(np.float32))
        out_t.append((inv.reshape(2, 3) + base).astype(np.int32))
    vtx_pos = np.concatenate(out_v)
    pos_idx = np.concatenate(out_t)
    col = rng.uniform(0.0, 1.0, size=vtx_pos.shape).astype(np.float32)
    return pos_idx, vtx_pos, pos_idx.copy(), col


def uv_sphere(n_lat=32, n_lon=64, radius=1.0):
    """UV sphere with texture coordinates.

    Returns (pos_idx [T,3], vtx_pos [V,3], uv_idx [T,3], vtx_uv [V,2]).
    Vertices are duplicated along the date line so uvs are continuous
    per triangle.
    """
    lats = np.linspace(0.0, np.pi, n_lat + 1)
    lons = np.linspace(0.0, 2 * np.pi, n_lon + 1)  # duplicated seam column
    tt, pp = np.meshgrid(lats, lons, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    vtx = (radius * np.stack([x, y, z], axis=-1)).reshape(-1, 3).astype(np.float32)
    u = (pp / (2 * np.pi))
    v = (tt / np.pi)
    uvs = np.stack([u, v], axis=-1).reshape(-1, 2).astype(np.float32)

    idx = np.arange((n_lat + 1) * (n_lon + 1)).reshape(n_lat + 1, n_lon + 1)
    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = idx[i, j], idx[i, j + 1]
            c, d = idx[i + 1, j], idx[i + 1, j + 1]
            if i > 0:
                tris.append([a, b, c])
            if i < n_lat - 1:
                tris.append([b, d, c])
    tri = np.asarray(tris, np.int32)
    return tri, vtx, tri.copy(), uvs
