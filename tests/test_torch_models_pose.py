"""Port parity: the pose fitting model (torch, plain twins) vs the JAX
package's (nvdiffrast_tpu.models.fit_pose).

* The same seed gives the same target and initial poses (the same numpy
  RandomState stream) and, within 1e-5, the same target image (the JAX
  model runs its XLA rasterizer on the CPU, the port the Pallas kernel's
  rules, which agree on this scene).
* First step: the loss within rtol 1e-5 and its gradient to the
  quaternion within atol 1e-5 / rtol 1e-4 of the JAX model's
  (tests/test_pipeline.py's gradient bar).
* Convergence at tests/test_models.py's bar: angle < 2 degrees after 300
  iterations at 24 px.
"""

import numpy as np
import torch

from nvdiffrast_tpu.models import fit_pose as jfp
from nvdiffrast_tpu_torch.models.fit_pose import PoseFitModel


def test_pose_first_step_matches_jax():
    jm = jfp.PoseFitModel(resolution=24, seed=0)
    m = PoseFitModel(resolution=24, seed=0, device="cpu")
    np.testing.assert_array_equal(m.pose_target, jm.pose_target)
    np.testing.assert_array_equal(m.pose_opt.numpy(), np.asarray(jm.pose_opt))
    np.testing.assert_allclose(m.target_img.numpy(), np.asarray(jm.target_img), atol=1e-5)
    q = jm.pose_opt
    ref_loss = float(jm._loss(q, jm.target_img))
    ref_g = np.asarray(jm._loss_grad(q, jm.target_img))
    tq = torch.from_numpy(np.array(q))
    np.testing.assert_allclose(m.loss(tq).item(), ref_loss, rtol=1e-5)
    g = m.loss_grad(tq).numpy()
    assert np.abs(ref_g).max() > 0
    np.testing.assert_allclose(g, ref_g, atol=1e-5, rtol=1e-4)
    assert abs(m.angle_error() - jm.angle_error()) < 1e-4


def test_pose_fit_converges():
    m = PoseFitModel(resolution=24, seed=0, device="cpu")
    a0 = m.angle_error()
    err = m.fit(max_iter=300)
    assert err < 2.0, f"pose angular error {err:.2f} deg (bar 2.0, from {a0:.1f})"
