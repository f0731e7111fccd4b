"""Procedural meshes (numpy only).

Copies of ``nvdiffrast_tpu.models.primitives``' ``cube_continuous``,
``cube_discontinuous``, ``uv_sphere``, ``icosphere``,
``checkerboard_texture`` and ``procedural_cubemap`` (the same arrays),
kept free of any JAX import.
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


def icosphere(subdiv=3, radius=1.0):
    """Icosphere by repeated midpoint subdivision (envphong geometry).

    Returns (tri [T, 3] i32, vtx [V, 3] f32)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)

    for _ in range(subdiv):
        cache = {}
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key in cache:
                return cache[key]
            m = (verts[a] + verts[b]) / 2.0
            m /= np.linalg.norm(m)
            vlist.append(m)
            cache[key] = len(vlist) - 1
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab = midpoint(a, b)
            bc = midpoint(b, c)
            ca = midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)

    vtx = (radius * verts).astype(np.float32)
    return faces.astype(np.int32), vtx


def checkerboard_texture(h=256, w=512, c=3, tiles=16):
    """Procedural stand-in for the earth texture [h, w, c] in [0, 1]."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (((xx * tiles // w) + (yy * tiles // h)) % 2).astype(np.float32)
    r = 0.25 + 0.5 * base
    g = 0.5 + 0.35 * np.sin(2 * np.pi * xx / w) * np.cos(np.pi * yy / h)
    b = 1.0 - base * 0.6
    tex = np.stack([r, g, b][:c], axis=-1).astype(np.float32)
    return np.clip(tex, 0.0, 1.0)


def procedural_cubemap(res=64, c=3):
    """Smooth procedural environment cube map [6, res, res, c]."""
    faces = []
    for f in range(6):
        s = (np.arange(res) + 0.5) / res
        ss, tt = np.meshgrid(s, s, indexing="xy")
        du = 2.0 * (ss - 0.5)
        dv = 2.0 * (tt - 0.5)
        one = np.ones_like(du)
        if f == 0:
            d = np.stack([one, -dv, -du], -1)
        elif f == 1:
            d = np.stack([-one, -dv, du], -1)
        elif f == 2:
            d = np.stack([du, one, dv], -1)
        elif f == 3:
            d = np.stack([du, -one, -dv], -1)
        elif f == 4:
            d = np.stack([du, -dv, one], -1)
        else:
            d = np.stack([-du, -dv, -one], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        col = 0.5 + 0.5 * np.stack([
            np.sin(3.0 * d[..., 0]) * np.cos(2.0 * d[..., 1]),
            np.sin(2.5 * d[..., 1] + 1.0),
            np.cos(3.5 * d[..., 2]) * np.sin(1.5 * d[..., 0]),
        ], axis=-1)
        faces.append(col[..., :c].astype(np.float32))
    return np.stack(faces)
