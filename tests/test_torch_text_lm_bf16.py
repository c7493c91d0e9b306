"""The bfloat16 training trajectory of the port's ``make_lm_steps``
against the JAX package's (``test_torch_text_lm_steps.py``'s ten steps
at dropout 0.1, the jitted JAX step's seeds replayed): loss rtol 5e-3."""
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_text_lm import default_offsets  # noqa: F401
from tests.test_torch_text_lm_steps import trajectory
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


def test_bf16_trajectory_with_dropout(monkeypatch):
    r = trajectory(0.1, jnp.bfloat16, torch.bfloat16, monkeypatch)
    np.testing.assert_allclose(r["loss"], r["j_loss"], rtol=5e-3)
