"""Port parity of the parallel layer (torch) with the JAX package: the
row-band boundary pass and the data-parallel step.

``nvdiffrast_tpu_torch.parallel.aa_boundary`` and its hand-written
backward against ``nvdiffrast_tpu.parallel.spatial.aa_boundary`` under
``jax.vjp``, on the same numpy rows (no mesh): two neighbouring rows of a
full render as the band's last row and the next band's first, instance
and range mode, ``active`` True and False, ``pos_gradient_boost`` != 1.
Bars of tests/test_torch_antialias_bwd.py: deltas within 1e-6; colour
cotangents within 1e-6 on the sphere scene. On the random near-plane
scene the cotangents take that file's near-plane bar, 1e-5: XLA:CPU
contracts the edge products of JAX's pair math into fma (the port never
does), which moves alpha by up to 1.8e-6 of itself there, and the
cotangents are alpha times standard-normal values (1.07e-6 apart at
most). Position gradients, each vertex row within 2e-6 of its largest
entry on the sphere scene and 1e-5 on the random one: JAX sums the
pairs' rows into triangles and vertices in float32 scatter-adds, the
port its pairs in float64 and its vertices in a fixed order, and where a
vertex's terms cancel (a w entry of 1.07 from terms several times
larger) the two roundings were 1.1e-6 of the row apart.

The port's single-process step (tests/_torch_dist_worker.py
``global_steps``, which tests/test_torch_parallel.py holds the ranks'
data-parallel steps to) against JAX's ``shard_map_train_step`` (pmean
over a 2-device dp mesh) with ``optax.sgd`` at the same rate, after 2
steps: atol 1e-5 / rtol 1e-4 (tests/test_torch_pipeline_bwd.py's
autograd bar).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_dist_worker as worker
from nvdiffrast_tpu.ops.antialias import antialias as jantialias
from nvdiffrast_tpu.ops.interpolate import interpolate as jinterpolate
from nvdiffrast_tpu.ops.rasterize import rasterize as jrasterize
from nvdiffrast_tpu.parallel import make_mesh as jmake_mesh
from nvdiffrast_tpu.parallel import shard_map_train_step as jshard_map_train_step
from nvdiffrast_tpu.parallel import spatial as jsp
from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
from nvdiffrast_tpu_torch.ops.topology import build_opposite_table
from nvdiffrast_tpu_torch.parallel.spatial import aa_boundary
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from _torch_parity import random_scene, sphere_scene

SCENES = {
    "sphere": lambda: sphere_scene(B=2, seed=3)[:2] + ((40, 56), 3),
    "random": lambda: random_scene(2, B=2) + ((37, 50), 2),
}
BAR = {"sphere": 1e-6, "random": 1e-5}      # colour cotangents
POS_BAR = {"sphere": 2e-6, "random": 1e-5}  # pos, of each vertex row's largest
ROWS = (7, 13, 19, 25)  # boundary rows y (pairs y, y + 1)


@functools.lru_cache(maxsize=None)
def _scene(name, ranged):
    """(pos, tri, rast, colour, dtop/dbot cotangents) as numpy. Range
    mode: image 0's positions as one [V, 4] table, B = 1."""
    pos, tri, (H, W), C = SCENES[name]()
    if ranged:
        pos = pos[0]
    p, t = inputs_from_numpy(pos[None] if ranged else pos, tri)
    rast = np.stack([o.numpy() for o in rc.rasterize_fused(p, t, (H, W))], -1)
    rng = np.random.default_rng(C)
    color = rng.random(rast.shape[:3] + (C,), dtype=np.float32)
    g = rng.standard_normal((2, rast.shape[0], W, C)).astype(np.float32)
    return pos, tri, rast, color, g


@functools.lru_cache(maxsize=None)
def _jax_fn(name, ranged, boost):
    """jax.vjp of JAX aa_boundary, jitted once per scene and mode (the
    row index and `active` traced)."""
    pos, tri, rast, color, g = _scene(name, ranged)
    H = rast.shape[1]
    jtri = jnp.asarray(tri)
    # The port's table (the same table bit for bit, tests/test_torch_topology.py):
    # JAX's builds eagerly, op by op, in 6 s a scene.
    op = jnp.asarray(build_opposite_table(torch.from_numpy(tri)).numpy())

    @jax.jit
    def run(ct, cb, rt, rb, p, y, active, gt, gb):
        out, vjp = jax.vjp(lambda a, b, q: jsp.aa_boundary(a, b, rt, rb, q, jtri, op, y,
                                                           active, H, boost=boost),
                           ct, cb, p)
        return out, vjp((gt, gb))

    return run


def _jax(name, ranged, y, active, boost):
    pos, tri, rast, color, g = _scene(name, ranged)
    out, grads = _jax_fn(name, ranged, boost)(
        color[:, y], color[:, y + 1], rast[:, y], rast[:, y + 1], pos, jnp.int32(y),
        jnp.bool_(active), g[0], g[1])
    return [np.asarray(x) for x in out], [np.asarray(x) for x in grads]


def _torch(name, ranged, y, active, boost):
    pos, tri, rast, color, g = _scene(name, ranged)
    H = rast.shape[1]
    p, t, ct, cb, rt, rb = inputs_from_numpy(pos, tri, color[:, y], color[:, y + 1],
                                             rast[:, y], rast[:, y + 1])
    for x in (p, ct, cb):
        x.requires_grad_()
    out = aa_boundary(ct, cb, rt, rb, p, t, build_opposite_table(t), y, active, H, boost)
    grads = torch.autograd.grad(out, (ct, cb, p), (torch.from_numpy(g[0]),
                                                   torch.from_numpy(g[1])))
    return [x.detach().numpy() for x in out], [x.numpy() for x in grads]


def _pos_rows_close(got, ref, rtol):
    scale = np.abs(ref).max(-1, keepdims=True)
    assert (np.abs(got - ref) <= rtol * scale).all(), np.abs(got - ref).max()


# (scene, range mode, pos_gradient_boost): each a JAX compile of its own;
# the boost rides on one of them.
CASES = [("random", False, 1.0), ("random", True, 1.0), ("sphere", False, 1.0),
         ("sphere", True, 3.0)]


@pytest.mark.parametrize("name,ranged,boost", CASES,
                         ids=[f"{n}-{'range' if r else 'instance'}-boost{b:g}"
                              for n, r, b in CASES])
def test_aa_boundary_matches_jax(name, ranged, boost):
    fired = 0
    for y in ROWS:
        (jt, jb), (jgt, jgb, jgp) = _jax(name, ranged, y, True, boost)
        (tt, tb), (tgt, tgb, tgp) = _torch(name, ranged, y, True, boost)
        fired += int((jt != 0).sum() + (jb != 0).sum())
        np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-6, err_msg=f"dtop row {y}")
        np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-6, err_msg=f"dbot row {y}")
        np.testing.assert_allclose(tgt, jgt, rtol=0, atol=BAR[name], err_msg=f"g_ctop row {y}")
        np.testing.assert_allclose(tgb, jgb, rtol=0, atol=BAR[name], err_msg=f"g_cbot row {y}")
        assert tgp.shape == jgp.shape
        _pos_rows_close(tgp, jgp, POS_BAR[name])
        if boost != 1.0:  # the boost scales g_pos exactly, and nothing else
            (ut, ub), (ugt, ugb, ugp) = _torch(name, ranged, y, True, 1.0)
            np.testing.assert_array_equal(tgp, ugp * boost)
            np.testing.assert_array_equal(tgt, ugt)
            np.testing.assert_array_equal(tt, ut)
    assert fired > 0  # the rows hold pairs that blend


def test_aa_boundary_inactive():
    """active=False (the last band) gives zeros, in both packages."""
    (tt, tb), (tgt, tgb, tgp) = _torch("sphere", False, ROWS[2], False, 1.0)
    (jt, jb), (jgt, jgb, jgp) = _jax("sphere", False, ROWS[2], False, 1.0)
    for x in (tt, tb, tgt, tgb, tgp, jt, jb, jgt, jgb, jgp):
        assert not x.any()
    assert np.abs(_torch("sphere", False, ROWS[2], True, 1.0)[1][2]).max() > 0


def test_single_process_step_matches_jax():
    pos_idx, col_idx, vtxc, batch = worker.dp_scene()
    res = worker.DP_RES
    tri, cidx = jnp.asarray(pos_idx), jnp.asarray(col_idx)

    def loss_fn(params, pos_clip):
        rast, _ = jrasterize(None, pos_clip, tri, (res, res), grad_db=False)
        img, _ = jinterpolate(params["col"][None], rast, cidx)
        img = jantialias(img, rast, pos_clip, tri)
        return jnp.mean((img - worker.DP_TARGET) ** 2)

    opt = optax.sgd(worker.DP_LR)
    mesh = jmake_mesh((2,), ("dp",), devices=jax.devices()[:2])
    step = jshard_map_train_step(loss_fn, opt, mesh)
    # Inputs placed as the step's outputs are (parameters replicated, the
    # batch split over dp), so the second step reuses the first's compile.
    params = jax.device_put({"col": jnp.asarray(vtxc)}, NamedSharding(mesh, P()))
    state = opt.init(params)
    gbatch = jax.device_put(jnp.asarray(batch), NamedSharding(mesh, P("dp")))
    for _ in range(worker.DP_STEPS):
        params, state, _ = step(params, state, gbatch)
    got, _ = worker.global_steps(res)
    assert np.abs(got - vtxc).max() > 0
    np.testing.assert_allclose(got, np.asarray(params["col"]), atol=1e-5, rtol=1e-4)
