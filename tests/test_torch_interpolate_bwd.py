"""Port parity: the interpolate op's backward (torch) vs the JAX package.

* ``interpolate_cuda.interp_backward`` twin (kernel B6) vs
  ``interpolate_pallas.interp_backward_fused`` in interpret mode, on the
  same inputs: within 1e-6 (the same expressions; XLA:CPU may contract a
  product and a sum into fma). Per-image, broadcast and 2-D attribute
  tables, with and without derivatives, out-of-range ids.
* ``torch.autograd.grad`` of the public ``interpolate`` vs ``jax.grad`` of
  JAX ``interpolate(impl="pallas_interpret")`` at
  tests/test_interpolate_pallas.py's bar (atol 1e-5, rtol 1e-5) for the
  gradients to attr, rast and rast_db, with diff_attrs None / 'all' /
  [0, -1], per-image, broadcast and 2-D attributes, B = 2; 20 attributes
  run as two chunks through the same kernels (JAX: its XLA path, which
  serves more than 16).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrast_tpu.ops import interpolate as jint
from nvdiffrast_tpu.ops import interpolate_pallas as jip
import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.ops import interpolate_cuda as ic
from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
from nvdiffrast_tpu_torch.ops.pipeline import _attr_table
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from _torch_parity import sphere_scene

RES = (24, 40)
B = 2


@functools.lru_cache(maxsize=None)
def _scene():
    """The port's rasterizer on a B = 2 sphere: (tri, rast, rast_db) as
    numpy, with a few out-of-range ids in rast."""
    pos, tri, _, cidx = sphere_scene(B=B, seed=5)
    p, t = inputs_from_numpy(pos, tri)
    outs = [o.numpy() for o in rc.rasterize_fused(p, t, RES, emit_db=True)]
    rast = np.stack(outs[:4], -1).copy()
    rast[0, 0, :3, 3] = [tri.shape[0] + 1, tri.shape[0] + 5, 0.0]  # invalid ids
    return cidx, rast, np.stack(outs[4:], -1)


def _attr(form, A, seed=0):
    V = int(_scene()[0].max()) + 1
    a = np.random.default_rng(seed).standard_normal((B, V, A)).astype(np.float32)
    return {"per_image": a, "broadcast": a[:1], "2d": a[0]}[form]


@pytest.mark.parametrize("form,A,diff_list", [("per_image", 3, ()),
                                              ("broadcast", 5, (3, 1)),
                                              ("2d", 2, (0, 1))])
def test_interp_backward_twin_matches_jax(form, A, diff_list):
    tri, rast, rast_db = _scene()
    attr = _attr(form, A)
    D = len(diff_list)
    N = rast.shape[0] * rast.shape[1] * rast.shape[2]
    rng = np.random.default_rng(1)
    gy = rng.standard_normal((A, N)).astype(np.float32)
    gda = rng.standard_normal((2 * D, N)).astype(np.float32)
    instance = attr.ndim == 3
    bc = instance and attr.shape[0] == 1
    rid, jtbl, b0, b1, b2, valid, _ = jint._pixel_ids(
        jnp.asarray(attr), jnp.asarray(rast), jnp.asarray(tri), instance, bc)
    db_cols = jint._db_cols(jnp.asarray(rast_db), valid, N) if D else None
    ref = jip.interp_backward_fused(
        jtbl, rid, b0, b1, b2, valid, db_cols, list(jnp.asarray(gy)),
        list(jnp.asarray(gda)) if D else None, A, diff_list, interpret=True)

    a, t, r, rdb, tgy, tgda = inputs_from_numpy(attr, tri, rast, rast_db, gy, gda)
    per_image = form == "per_image"
    tbl = _attr_table(a, t, B if per_image else 1, tri.shape[0])
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(jtbl))
    flats = r.reshape(N, 4).T
    db = tuple(rdb.reshape(N, 4).T) if D else None
    hw = RES[0] * RES[1] if per_image else 0
    before = ic.BWD_KERNEL.launches
    grast, gval, gdb = ic.interp_backward(tbl, flats[0], flats[1], flats[3], db, tgy,
                                          tgda if D else None, diff_list, tri.shape[0], hw)
    assert ic.BWD_KERNEL.launches == before  # CPU tensors run the twin
    for name, got, want in (("grast", grast, ref[0]), ("gval", gval, ref[1]),
                            ("gdb", gdb, ref[2])):
        if want is None:
            assert got is None
            continue
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6, err_msg=name)


def test_interp_backward_checks():
    tri, rast, rast_db = _scene()
    N = B * RES[0] * RES[1]
    a, t, r = inputs_from_numpy(_attr("2d", 2), tri, rast)
    tbl = _attr_table(a, t, 1, tri.shape[0])
    flats = r.reshape(N, 4).T
    gy = torch.zeros((2, N))
    with pytest.raises(ValueError, match="unsupported device"):
        ic.interp_backward(tbl.to("meta"), *(f.to("meta") for f in flats[[0, 1, 3]]),
                           None, gy.to("meta"), None, ())
    with pytest.raises(ValueError):  # gy of the wrong width
        ic.interp_backward(tbl, flats[0], flats[1], flats[3], None, gy[:1], None, ())
    with pytest.raises(ValueError):  # derivatives without their cotangents
        ic.interp_backward(tbl, flats[0], flats[1], flats[3], tuple(flats), gy, None, (0,))
    with pytest.raises(ValueError):  # a per-image table that does not fit
        ic.interp_backward(tbl, flats[0], flats[1], flats[3], None, gy, None, (),
                           tri.shape[0], RES[0] * RES[1])


def _loss_weights(A, D, seed):
    rng = np.random.default_rng(seed)
    shape = (B,) + RES
    return (rng.standard_normal(shape + (A,)).astype(np.float32),
            rng.standard_normal(shape + (2 * D,)).astype(np.float32))


def _jax_grads(attr, diff, impl):
    tri, rast, rast_db = _scene()
    A = attr.shape[-1]
    D = 0 if diff is None else (A if diff == "all" else len(diff))
    w1, w2 = _loss_weights(A, D, A)

    def loss(a, r, rdb):
        o, da = jint.interpolate(a, r, jnp.asarray(tri), rast_db=rdb, diff_attrs=diff,
                                 impl=impl)
        return jnp.sum(o * w1) + jnp.sum(da * w2)

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(attr), jnp.asarray(rast),
                                          jnp.asarray(rast_db))
    return [np.asarray(x) for x in g]


def _torch_grads(attr, diff):
    tri, rast, rast_db = _scene()
    a, t, r, rdb = inputs_from_numpy(attr, tri, rast, rast_db)
    for x in (a, r, rdb):
        x.requires_grad_()
    o, da = dr.interpolate(a, r, t, rast_db=rdb, diff_attrs=diff)
    A = attr.shape[-1]
    D = da.shape[-1] // 2
    w1, w2 = _loss_weights(A, D, A)
    loss = (o * torch.from_numpy(w1)).sum() + (da * torch.from_numpy(w2)).sum()
    g = torch.autograd.grad(loss, (a, r, rdb), allow_unused=True)
    return [np.zeros(x.shape, np.float32) if y is None else y.numpy()
            for x, y in zip((a, r, rdb), g)]


@pytest.mark.parametrize("form,diff", [("per_image", None), ("broadcast", "all"),
                                       ("2d", [0, -1]), ("2d", None),
                                       ("per_image", "all"), ("broadcast", [0, -1])])
def test_interpolate_grads_match_jax(form, diff):
    attr = _attr(form, 3, seed=2)
    ref = _jax_grads(attr, diff, "pallas_interpret")
    got = _torch_grads(attr, diff)
    for name, g, r in zip(("g_attr", "g_rast", "g_rast_db"), got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-5, err_msg=name)
    assert np.abs(ref[0]).max() > 0 and np.abs(ref[1]).max() > 0
    assert (np.abs(ref[2]).max() > 0) == (diff is not None)


def test_interpolate_many_attributes_run_in_chunks():
    """20 attributes: two launches of the same kernels (16 + 4), the
    derivatives of attributes in both chunks; JAX's XLA path serves 20."""
    attr = _attr("per_image", 20, seed=3)
    diff = [0, 17, -1]
    ref = _jax_grads(attr, diff, "xla")
    got = _torch_grads(attr, diff)
    for name, g, r in zip(("g_attr", "g_rast", "g_rast_db"), got, ref):
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-5, err_msg=name)
    tri, rast, rast_db = _scene()
    a, t, r, rdb = inputs_from_numpy(attr, tri, rast, rast_db)
    o, da = dr.interpolate(a, r, t, rast_db=rdb, diff_attrs=diff)
    jo, jda = jint.interpolate(jnp.asarray(attr), jnp.asarray(rast), jnp.asarray(tri),
                               rast_db=jnp.asarray(rast_db), diff_attrs=diff, impl="xla")
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(da.numpy(), np.asarray(jda), atol=1e-6, rtol=1e-5)


def test_interpolate_entry_checks():
    tri, rast, rast_db = _scene()
    a, t, r, rdb = inputs_from_numpy(_attr("2d", 3), tri, rast, rast_db)
    with pytest.raises(ValueError, match="requires rast_db"):
        dr.interpolate(a, r, t, diff_attrs="all")
    with pytest.raises(ValueError, match="out of range"):
        dr.interpolate(a, r, t, rast_db=rdb, diff_attrs=[3])
    with pytest.raises(ValueError):  # minibatch mismatch
        dr.interpolate(a[None].expand(3, -1, -1), r, t)
    o, da = dr.interpolate(a, r, t)
    assert o.shape == (B,) + RES + (3,) and da.shape == (B,) + RES + (0,)
    assert o.device.type == "cpu"
    if not torch.cuda.is_available():  # a non-tensor rast goes to the GPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dr.interpolate(a, rast, t)
