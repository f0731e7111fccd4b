"""Procedural meshes (numpy only).

Copy of ``nvdiffrast_tpu.models.primitives.uv_sphere``, the geometry of
the forward render path's scene, kept free of any JAX import.
"""

import numpy as np


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
