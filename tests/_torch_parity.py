"""Shared scenes and bars for the port's parity tests (tests/test_torch_*.py).

Scenes are numpy arrays made from a seed; each test hands the same
arrays to the JAX package and to the port.
"""

import numpy as np

from nvdiffrast_tpu_torch.models import primitives
from nvdiffrast_tpu_torch.utils import camera


def sphere_scene(B=1, seed=0, A=3):
    """tests/test_pipeline.py _scene: uv-sphere 8x12, B random views,
    random vertex attributes. Returns (pos, tri, attr, attr_idx)."""
    rng = np.random.default_rng(seed)
    pos_idx, vtxp, col_idx, _ = primitives.uv_sphere(8, 12)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    poss = []
    for b in range(B):
        mvp = (camera.projection(x=0.4)
               @ camera.translate(0.05 * b, 0, -3.2)
               @ camera.random_rotation_translation(0.2, rng))
        poss.append((posw @ mvp.T).astype(np.float32))
    attr = rng.standard_normal((B, vtxp.shape[0], A)).astype(np.float32)
    return np.stack(poss), pos_idx, attr, col_idx


def random_scene(seed, B=1, V=64, T=48):
    """tests/test_parity_sweep.py _random_scene: near-plane crossers and
    degenerate triangles. Returns (pos, tri)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1, 1, (B, V, 4)).astype(np.float32)
    pos[..., 3] = rng.uniform(0.4, 2.5, (B, V))
    k = max(2, V // 10)
    pos[:, :k, 3] = rng.uniform(-0.5, 0.1, (B, k))
    tri = rng.randint(0, V, (T, 3)).astype(np.int32)
    tri[0] = [3, 3, 7]
    tri[1] = [5, 5, 5]
    return pos, tri


def assert_ids_match_mod_zfights(id_ref, id_got, z_ref, z_got, max_frac=2e-4):
    """The z-fight bar of tests/test_parity_sweep.py: ids equal except
    where two triangles tie in depth (depths within 1e-4 there), on at
    most `max_frac` of the pixels. Returns the mask of agreeing ids."""
    differ = id_ref != id_got
    if differ.any():
        np.testing.assert_allclose(z_got[differ], z_ref[differ], atol=1e-4,
                                   err_msg="id mismatch at non-tied depth")
        assert differ.mean() <= max_frac, (
            f"{differ.sum()} id mismatches — too many even for z-fights")
    return ~differ
