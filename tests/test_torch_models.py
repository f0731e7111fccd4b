"""Port parity: the cube fitting model (torch, plain twins) vs the JAX
package's (nvdiffrast_tpu.models.fit_cube), and the camera helpers and
meshes the models share; the pose model is in test_torch_models_pose.py
(the two JAX references run on two workers).

* The same seed gives the same initial parameters and cameras
  (the same numpy RandomState stream), and ``set_params`` carries the
  JAX model's parameters across.
* First step: the loss within rtol 1e-5 and its gradients within atol
  1e-5 / rtol 1e-4 of the JAX model's (tests/test_pipeline.py's gradient
  bar; the JAX model runs its XLA rasterizer on the CPU, the port the
  Pallas kernel's rules, which agree on these scenes).
* Convergence at tests/test_models.py's bar: cube geometric error
  < 0.08 after 150 steps at 16 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrast_tpu.models import fit_cube as jfc
from nvdiffrast_tpu_torch.models import primitives
from nvdiffrast_tpu_torch.models.fit_cube import CubeFitModel
from nvdiffrast_tpu_torch.utils import camera

import _torch_parity  # noqa: F401  (one intra-op thread a test worker)


@pytest.mark.parametrize("discontinuous", [False, True])
def test_cube_first_step_matches_jax(discontinuous):
    jm = jfc.CubeFitModel(resolution=16, discontinuous=discontinuous, seed=0)
    m = CubeFitModel(resolution=16, discontinuous=discontinuous, seed=0, device="cpu")
    for k in ("pos", "col"):
        np.testing.assert_array_equal(m.params[k].detach().numpy(), np.asarray(jm.params[k]))
    m.set_params({k: np.asarray(v) for k, v in jm.params.items()})
    mtx = m.random_mvp()
    np.testing.assert_array_equal(mtx, jm.random_mvp())

    def jloss(p):
        target = jfc.render(mtx, jm.vtx_pos, jm.pos_idx, jm.vtx_col, jm.col_idx, 16,
                            topo=jm.topo)
        img = jfc.render(mtx, p["pos"], jm.pos_idx, p["col"], jm.col_idx, 16, topo=jm.topo)
        return jnp.mean((img - target) ** 2)

    ref_loss, ref_g = jax.jit(jax.value_and_grad(jloss))(jm.params)
    loss = m.loss(mtx)
    g = torch.autograd.grad(loss, [m.params["pos"], m.params["col"]])
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for name, x in zip(("pos", "col"), g):
        r = np.asarray(ref_g[name])
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(x.numpy(), r, atol=1e-5, rtol=1e-4, err_msg=name)


def test_cube_fit_converges():
    m = CubeFitModel(resolution=16, seed=0, device="cpu")
    e0 = m.geometric_error()
    assert e0 > 0.3  # starts far away
    for _ in range(150):
        m.step()
    e = m.geometric_error()
    assert e < 0.08, f"cube geometric error {e:.4f} (bar 0.08, from {e0:.3f})"


def test_camera_and_primitives_match_jax():
    from nvdiffrast_tpu.models import primitives as jprim
    from nvdiffrast_tpu.utils import camera as jcam

    for f in ("cube_continuous", "cube_discontinuous", "uv_sphere"):
        for x, y in zip(getattr(primitives, f)(), getattr(jprim, f)()):
            np.testing.assert_array_equal(x, y)
    for f in ("rotate_x", "rotate_y"):
        np.testing.assert_array_equal(getattr(camera, f)(0.7), getattr(jcam, f)(0.7))
    rng = np.random.RandomState(3)
    q, p = camera.q_rnd(rng), camera.q_rnd(rng)
    np.testing.assert_array_equal(camera.q_scale_small(q, 0.3), jcam.q_scale_small(q, 0.3))
    tq, tp = torch.from_numpy(q), torch.from_numpy(p)
    np.testing.assert_allclose(camera.q_mul(tq, tp).numpy(),
                               np.asarray(jcam.q_mul(jnp.asarray(q), jnp.asarray(p))),
                               atol=1e-6)
    np.testing.assert_allclose(camera.q_to_mtx(tq * 2.0).numpy(),
                               np.asarray(jcam.q_to_mtx(jnp.asarray(q * 2.0))), atol=1e-6)
    pos = rng.randn(5, 3).astype(np.float32)
    mtx = camera.projection(x=0.4) @ camera.translate(0, 0, -3.5)
    np.testing.assert_allclose(camera.transform_pos(mtx, torch.from_numpy(pos)).numpy(),
                               np.asarray(jcam.transform_pos(mtx, pos)), atol=1e-6)
    assert camera.q_angle_deg(q, p) == pytest.approx(jcam.q_angle_deg(q, p))
