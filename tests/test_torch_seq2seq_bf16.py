"""The bfloat16 training trajectory of the port's ``make_seq2seq_steps``
against the JAX package's on one init, on the CPU: dropout off, 3 frozen
steps then unfrozen (the extractor trains too), the loss within rtol
5e-3 of JAX's at every step (``test_torch_bf16.py``'s bound; f32 holds
1e-3 in ``test_torch_seq2seq_steps.py``).
"""
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_seq2seq_steps import _fairseq_offsets, _run  # noqa: F401
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

BF16_LOSS_RTOL = 5e-3


def test_bf16_trajectory_freeze_then_unfreeze():
    r = _run(0.0, jnp.bfloat16, torch.bfloat16)
    np.testing.assert_allclose(r["loss"], r["j_loss"], rtol=BF16_LOSS_RTOL)
