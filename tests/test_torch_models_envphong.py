"""Port parity: the envphong (cube-map environment + Phong) fitting model
(torch, plain twins) vs the JAX package's
(nvdiffrast_tpu.models.fit_envphong), and the primitives it uses.

* The same seed gives the same initial parameters, views and lights;
  ``set_params`` carries the JAX model's parameters across.
* First step: the loss within rtol 1e-5 and its gradients to the map and
  the Phong parameters within 5e-5 of each row's largest entry (the
  texture bar, tests/test_pipeline_tex.py:61, per row; the JAX model
  runs its XLA rasterizer and sampler on the CPU, the port the Pallas
  kernels' rules).
* Convergence at tests/test_models.py's bar: env RMSE < 0.03 after 150
  steps at res 32, env 8, subdiv 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nvdiffrast_tpu.models import fit_envphong as jfe
from nvdiffrast_tpu.models import primitives as jprim
from nvdiffrast_tpu_torch.models import primitives
from nvdiffrast_tpu_torch.models.fit_envphong import EnvPhongFitModel, _vertex_normals

import _torch_parity  # noqa: F401  (one intra-op thread a test worker)


def test_envphong_primitives_match_jax():
    for sub in (0, 2):
        for x, y in zip(primitives.icosphere(sub), jprim.icosphere(sub)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(primitives.procedural_cubemap(8), jprim.procedural_cubemap(8))
    tri, vtx = primitives.icosphere(1)
    np.testing.assert_array_equal(_vertex_normals(tri, vtx), jfe._vertex_normals(tri, vtx))


def test_envphong_first_step_matches_jax():
    jm = jfe.EnvPhongFitModel(res=32, env_res=8, subdiv=1, seed=0)
    m = EnvPhongFitModel(res=32, env_res=8, subdiv=1, seed=0, device="cpu")
    for k in ("env", "phong"):
        np.testing.assert_array_equal(m.params[k].detach().numpy(), np.asarray(jm.params[k]))
    rng = np.random.RandomState(1)
    params = {"env": rng.rand(*jm.params["env"].shape).astype(np.float32),
              "phong": np.asarray([0.9, 0.7, 0.5, 12.0], np.float32)}
    m.set_params(params)
    view = m.random_view()
    for x, y in zip(view, jm.random_view()):
        np.testing.assert_array_equal(x, y)
    mvp, campos, ldir = (jnp.asarray(x) for x in view)

    def jloss(p):
        refl, refld, mask = jfe.render_refl(mvp, campos, jm.pos, jm.pos_idx, jm.normals, 32)
        ref = jfe.shade(jm.env_ref, jm.phong_rgb_ref, jm.phong_exp_ref, refl, refld, ldir,
                        mask)
        img = jfe.shade(p["env"], p["phong"][:3], p["phong"][3], refl, refld, ldir, mask)
        return jnp.mean((img - ref) ** 2)

    ref_loss, ref_g = jax.jit(jax.value_and_grad(jloss))(
        {k: jnp.asarray(v) for k, v in params.items()})
    loss = m.loss(*view)
    g = torch.autograd.grad(loss, [m.params["env"], m.params["phong"]])
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for name, x in zip(("env", "phong"), g):
        r = np.asarray(ref_g[name])
        assert np.abs(r).max() > 0
        r2 = r.reshape(-1, r.shape[-1])
        x2 = x.numpy().reshape(r2.shape)
        bad = np.abs(x2 - r2) > 5e-5 * np.abs(r2).max(1, keepdims=True)
        assert not bad.any(), (name, np.nonzero(bad.any(1))[0][:10])


def test_envphong_fit_converges():
    m = EnvPhongFitModel(res=32, env_res=8, subdiv=1, seed=0, device="cpu")
    e0 = m.metrics()[0]
    for _ in range(150):
        m.step()
    env_rmse = m.metrics()[0]
    assert env_rmse < 0.03, f"envphong env RMSE {env_rmse:.4f} (bar 0.03, from {e0:.3f})"
