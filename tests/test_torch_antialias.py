"""Port parity: antialias forward twin plus the neighbour adds
(antialias_cuda.aa_forward) vs antialias_pallas.aa_forward_fused_cols
in interpret mode, on identical colour, id, depth and table inputs.

Bars: the image and alpha within 1e-6, and the edge/side residual ax
equal where alpha != 0 (ax is defined only there: the JAX kernel writes
0 elsewhere in blocks without a pair, ROADMAP C), after _tile_unorder of
the JAX residuals. On the random near-plane scene both bars are 1e-5
(shade_fwd's): its screen coordinates reach ~900 px, the pair analysis'
cross products x1*dy0 - y1*dx0 cancel there, and XLA:CPU contracts them
into fma, which moves alpha by up to ~5e-6.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvdiffrast_tpu.ops import antialias as jaa
from nvdiffrast_tpu.ops import antialias_pallas as jap
from nvdiffrast_tpu.ops.texture_pallas import _tile_order, _tile_unorder
from nvdiffrast_tpu.ops.topology import build_opposite_table as jbuild
from nvdiffrast_tpu_torch.ops import antialias_cuda as tac
from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
from nvdiffrast_tpu_torch.ops.antialias import _build_tables
from nvdiffrast_tpu_torch.ops.topology import build_opposite_table
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from _torch_parity import random_scene, sphere_scene

SCENES = {
    "sphere_b2_c3": lambda: sphere_scene(B=2, seed=3)[:2] + ((40, 56), 3),
    "sphere_b1_c5": lambda: sphere_scene(B=1, seed=4)[:2] + ((33, 47), 5),
    "random_b2_c1": lambda: random_scene(2, B=2) + ((37, 50), 1),
}
ATOL = {"sphere_b2_c3": 1e-6, "sphere_b1_c5": 1e-6, "random_b2_c1": 1e-5}


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs (the port's raster buffers, a random colour image, the JAX
    AA table) and the JAX kernel's outputs, as numpy arrays."""
    pos, tri, (H, W), C = SCENES[name]()
    B, T = pos.shape[0], tri.shape[0]
    N = B * H * W
    p, t = inputs_from_numpy(pos, tri)
    _, _, zw, idf = (o.reshape(N).numpy() for o in rc.rasterize_fused(p, t, (H, W)))
    ct = np.random.default_rng(C).random((C, N), dtype=np.float32)
    jpos, jtri = jnp.asarray(pos), jnp.asarray(tri)
    ftable = np.asarray(jaa._build_tables(jpos, jtri, jbuild(jtri), True, H, W)[0])
    out, res = jap.aa_forward_fused_cols(jnp.asarray(ct), jnp.asarray(idf),
                                         jnp.asarray(zw), jnp.asarray(ftable), T,
                                         True, (B, H, W, C), interpret=True)
    res = [np.asarray(_tile_unorder(r[:_tile_order(jnp.zeros(N), B, H, W).shape[0]],
                                    B, H, W)) for r in res]
    return (pos, tri, (B, H, W), ct, idf, zw, ftable), np.asarray(out), res


@pytest.mark.parametrize("name", sorted(SCENES))
def test_aa_forward_twin_matches_jax(name):
    (pos, tri, shape, ct, idf, zw, ftable), ref, ref_res = _case(name)
    B, H, W = shape
    C, N = ct.shape
    args = inputs_from_numpy(ct, idf, zw, ftable)
    out, res = tac.aa_forward(*args, shape, tri.shape[0])
    img = out.T.reshape(B, H, W, C).numpy()
    np.testing.assert_allclose(img, ref, atol=ATOL[name])
    n_pairs = 0
    for al, ax, r_al, r_ax in zip(res[::2], res[1::2], ref_res[::2], ref_res[1::2]):
        np.testing.assert_allclose(al.numpy(), r_al, atol=ATOL[name])
        live = r_al != 0
        np.testing.assert_array_equal(ax.numpy()[live], r_ax[live])
        n_pairs += int(live.sum())
    assert n_pairs > 20, "too few AA pairs"
    assert np.abs(img - ct.T.reshape(B, H, W, C)).max() > 0.01  # AA changed pixels


def test_aa_tables_match_jax():
    (pos, tri, shape, *_, ftable), _, _ = _case("sphere_b2_c3")
    p, t = inputs_from_numpy(pos, tri)
    got = _build_tables(p, t, build_opposite_table(t), *shape[1:])[0].numpy()
    np.testing.assert_allclose(got[:6], ftable[:6], rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got[6], ftable[6])


def test_aa_device_dispatch_and_checks():
    (pos, tri, shape, ct, idf, zw, ftable), _, _ = _case("sphere_b2_c3")
    T = tri.shape[0]
    args = inputs_from_numpy(ct, idf, zw, ftable)
    before = tac.KERNEL.launches
    got = tac.aa_cols(*args, shape, T)
    ref = tac.aa_cols_plain(*args, shape, T)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert tac.KERNEL.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tac.aa_cols(*(a.to("meta") for a in args), shape, T)
    with pytest.raises(ValueError):  # wrong table width
        tac.aa_cols(*args, shape, T + 1)
    with pytest.raises(ValueError):  # 9 channels
        tac.aa_cols(torch.zeros((9, ct.shape[1])), *args[1:], shape, T)
