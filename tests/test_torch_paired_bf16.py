"""The bfloat16 training trajectory of the port's ``make_paired_steps``
against the JAX package's on one init, on the CPU: dropout off, the
freezes and optimizer of ``test_torch_paired_steps.py``, the loss within
rtol 5e-3 of JAX's at every step (``test_torch_bf16.py``'s bound; f32
holds 1e-3), and ``logit_scale`` too. Two settings differ from the f32
trajectory's, each for a measured reason:

* the trainer's default ``--init_temp 1.0``. At 0.07 the logits are
  scaled by 14.3, and the towers' bf16 rounding, 1-2 ulps from JAX's
  (the bf16 softmax deviation, ROADMAP.md section 3), moves this random
  8-wide model's loss by up to 2.2% over the 10 steps;
* sum-type reductions (``sha``, ``2ha``) and no padding row. In bf16,
  max pooling's winners tie or swap at 1-ulp differences, which routes
  the gradient to other frames: the text tower's Q/K gradients then
  differ from JAX's by 50-70% at step 1 (measured). A padding row under
  a sum reduction has a zero embedding, where JAX's loss gradient is
  NaN (``test_torch_paired.py::test_zero_embedding_gradient``).

The trainer's default setting, max reductions with a padding row, is
held by one bf16 gradient in ``test_torch_paired_bf16_grad.py``.
"""
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_paired_steps import run_trajectory
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

BF16_LOSS_RTOL = 5e-3


def test_bf16_trajectory_with_freezes():
    r, _, _, _ = run_trajectory(0.0, jnp.bfloat16, torch.bfloat16,
                                init_temp=1.0, reductions=("sha", "2ha"),
                                padding=False)
    np.testing.assert_allclose(r["loss"], r["j_loss"], rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(r["scale"], r["j_scale"], rtol=BF16_LOSS_RTOL)

