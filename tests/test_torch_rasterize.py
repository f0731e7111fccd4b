"""Port parity: rasterizer (prepass + plain twin) vs the JAX Pallas
rasterizer in interpret mode.

Bars: edge record rows bitwise; ids equal except at z-fights (<= 2e-4
of pixels, tests/test_parity_sweep.py); u, v, z/w within 1e-4 where ids
agree, the JAX suite's own bar.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvdiffrast_tpu.ops import rasterize as jrast
from nvdiffrast_tpu.ops import rasterize_pallas as rp
from nvdiffrast_tpu_torch.ops import rasterize as trast
from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
from nvdiffrast_tpu_torch.ops.coord import pixel_scale_offset
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from _torch_parity import assert_ids_match_mod_zfights, random_scene, sphere_scene

SCENES = {
    "sphere_b1": lambda: sphere_scene(B=1, seed=1)[:2] + ((48, 64),),
    "sphere_b2": lambda: sphere_scene(B=2, seed=2)[:2] + ((48, 64),),
    "random_b2": lambda: random_scene(1, B=2) + ((67, 130),),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    """One scene with its JAX reference (Pallas kernel, interpret mode)."""
    pos, tri, res = SCENES[request.param]()
    B, T = pos.shape[0], tri.shape[0]
    jpos, jtri = jnp.asarray(pos), jnp.asarray(tri)
    ranges = jnp.broadcast_to(jnp.array([[0, T]], jnp.int32), (B, 2))
    ref = rp.rasterize_fused(jpos, jtri, res, ranges, interpret=True,
                             flat=True, emit_db=False)
    rec = rp._build_records_cm(jpos, jtri, jnp.arange(T, dtype=jnp.int32))[0]
    return {"pos": pos, "tri": tri, "res": res,
            "ref": [np.asarray(r) for r in ref[:4]], "rec": np.asarray(rec)}


def test_records_match_jax(case):
    p, t = inputs_from_numpy(case["pos"], case["tri"])
    rec = rc._build_records_cm(p, t)[0].numpy()
    ref = case["rec"]
    # Edge rows (correctly-rounded _dop) and ids: bitwise.
    np.testing.assert_array_equal(rec[:, :9].view(np.int32),
                                  ref[:, :9].view(np.int32))
    np.testing.assert_array_equal(rec[:, 15], ref[:, 15])
    # z/w planes: the same three-term sums, up to fma contraction.
    np.testing.assert_allclose(rec[:, 9:15], ref[:, 9:15], rtol=1e-5,
                               atol=1e-6)


def test_rasterize_matches_jax(case):
    p, t = inputs_from_numpy(case["pos"], case["tri"])
    out = [o.numpy() for o in rc.rasterize_fused(p, t, case["res"])]
    ref = case["ref"]
    assert all(o.shape == (p.shape[0],) + case["res"] for o in out)
    assert (ref[3] > 0).sum() > 100, "scene covers too little to test"
    same = assert_ids_match_mod_zfights(ref[3], out[3], ref[2], out[2])
    for name, a, b in zip(("u", "v", "zw"), ref[:3], out[:3]):
        np.testing.assert_allclose(b[same], a[same], atol=1e-4, err_msg=name)


def _sequential_reference(rec, aabb, res):
    """Kernel semantics written as the kernel runs: per image, records in
    id order, each merged into every pixel of the tiles its AABB meets."""
    H, W = res
    B, T, _ = rec.shape
    xs, xo, ys, yo = (torch.tensor(v, dtype=torch.float32)
                      for v in pixel_scale_offset(H, W))
    py, px = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    fx = px.float() * xs + xo
    fy = py.float() * ys + yo
    tx0 = (px // 16 * 16).float()
    ty0 = (py // 16 * 16).float()
    eps = torch.tensor(1e-9, dtype=torch.float32)
    outs = []
    for b in range(B):
        az = torch.full((H, W), 1e30)
        aw = torch.ones((H, W))
        aid = torch.full((H, W), 1e30)
        pa = torch.zeros((3, H, W))
        for i in range(T):
            s = rec[b, i].tolist()
            s = [torch.tensor(v, dtype=torch.float32) for v in s]
            s += [s[12 + c] - eps * ((s[c] + s[3 + c]) + s[6 + c])
                  for c in range(3)]
            x0, y0, x1, y1 = aabb[b, i]
            hit = ((y0 <= ty0 + 15) & (y1 >= ty0) & (x0 <= tx0 + 15)
                   & (x1 >= tx0))

            def aff(k):
                return (s[k] + s[k + 1] * fx) + s[k + 2] * fy

            def inside(a, k):
                tie = (s[k + 2] > 0) | ((s[k + 2] == 0) & (s[k + 1] > 0))
                return (a > 0) | ((a == 0) & tie)

            a = [aff(0), aff(3), aff(6)]
            pz, pw, cut = aff(9), aff(12), aff(16)
            ok = (hit & inside(a[0], 0) & inside(a[1], 3) & inside(a[2], 6)
                  & (cut >= 0) & (pw > 0) & (pz.abs() <= pw) & (s[15] < 1e29))
            better = ok & ((pz * aw < az * pw)
                           | ((pz * aw == az * pw) & (s[15] < aid)))
            az = torch.where(better, pz, az)
            aw = torch.where(better, pw, aw)
            aid = torch.where(better, s[15], aid)
            pa = torch.where(better, torch.stack(a), pa)
        outs.append((az, aw, aid, pa))
    return outs


@pytest.mark.parametrize("slice_fragments", [None, 300])
def test_twin_merge_order_is_sequential(slice_fragments, monkeypatch):
    """The twin's per-pixel rounds reproduce a plain sequential merge,
    also when its fragments are evaluated a slice of records at a time."""
    if slice_fragments:
        monkeypatch.setattr(rc, "_TWIN_FRAGMENTS", slice_fragments)
    pos, tri = random_scene(5, B=2, T=40)
    res = (37, 50)
    p, t = inputs_from_numpy(pos, tri)
    rec, aabb = rc.build_records(p, t, res)
    u, v, zw, idf = rc.rasterize_records_plain(rec, aabb, res)
    for b, (az, aw, aid, pa) in enumerate(_sequential_reference(rec, aabb, res)):
        valid = aid < 1e29
        assert valid.sum() > 100
        np.testing.assert_array_equal(idf[b].numpy(), torch.where(valid, aid, 0.0).numpy())
        iw = 1.0 / ((pa[0] + pa[1]) + pa[2])
        b0 = torch.clamp(pa[0] * iw, 0.0, 1.0)
        b1 = torch.clamp(pa[1] * iw, 0.0, 1.0)
        bs = 1.0 / torch.clamp(b0 + b1, min=1.0)
        zv = torch.clamp(az / aw, -1.0, 1.0)
        for got, want in ((u[b], b0 * bs), (v[b], b1 * bs), (zw[b], zv)):
            np.testing.assert_array_equal(got.numpy(),
                                          torch.where(valid, want, 0.0).numpy())


def test_dop_bitwise():
    rng = np.random.default_rng(0)
    a, b, c, d = (rng.standard_normal(4000).astype(np.float32) * 10
                  for _ in range(4))
    c[:500], d[:500] = a[:500], b[:500]  # exact cancellation
    c[500:1000], d[500:1000] = b[500:1000], a[500:1000]
    ref = np.asarray(jrast._dop(*(jnp.asarray(x) for x in (a, b, c, d))))
    out = trast._dop(*(torch.from_numpy(x) for x in (a, b, c, d))).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    assert (out[:1000] == 0).all()


def test_unported_modes_raise():
    pos, tri = random_scene(2, B=1)
    p, t = inputs_from_numpy(pos, tri)
    for kw in ({"ranges": torch.zeros((1, 2), dtype=torch.int32)},
               {"peel_depth": torch.zeros((1, 8, 8))},
               {"viewport": (0, 8)}, {"emit_db": True}):
        with pytest.raises(NotImplementedError):
            rc.rasterize_fused(p, t, (8, 8), **kw)
    with pytest.raises(NotImplementedError):
        rc.rasterize_fused(p[0], t, (8, 8))


def test_argument_checks():
    pos, tri = random_scene(2, B=1)
    p, t = inputs_from_numpy(pos, tri)
    with pytest.raises(ValueError):
        rc.rasterize_fused(p[..., :3], t, (8, 8))
    with pytest.raises(ValueError):
        rc.rasterize_fused(p, t[:, :2], (8, 8))
    with pytest.raises(ValueError):
        rc.rasterize_fused(p, t.long(), (8, 8))
    with pytest.raises(ValueError):
        rc.rasterize_fused(p, t, (0, 8))
    bad = t.clone()
    bad[0, 0] = p.shape[1]
    with pytest.raises(ValueError, match="out of range"):
        rc.rasterize_fused(p, bad, (8, 8))


def test_kernel_wrapper_device_dispatch():
    """CPU tensors take the twin; a non-CPU, non-CUDA tensor raises
    (never a silent fallback)."""
    pos, tri = random_scene(3, B=1)
    p, t = inputs_from_numpy(pos, tri)
    rec, aabb = rc.build_records(p, t, (16, 24))
    before = rc.KERNEL.launches
    got = rc.rasterize_records(rec, aabb, (16, 24))
    ref = rc.rasterize_records_plain(rec, aabb, (16, 24))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert rc.KERNEL.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        rc.rasterize_records(rec.to("meta"), aabb.to("meta"), (16, 24))
