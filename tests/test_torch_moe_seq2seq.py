"""The MoE aux loss in the port's seq2seq factory against the jitted JAX
``make_seq2seq_steps`` on the CPU: ``tests/test_torch_seq2seq_steps.py``'s
model with its one encoder layer an MoE of E 4 (``moe_every`` 1),
``moe_aux_weight`` 0.5 and every dropout at 0.1 (the JAX step's seeds
replayed), two steps from one init: one with the encoder frozen, in
which only the aux trains it (JAX freezes by ``stop_gradient`` on the
encoder's output), then one unfrozen. Loss (step 1 rtol 1e-4, then
1e-3) and gradient norm (rtol 5e-3) agree at each step.
"""
import jax.numpy as jnp
import numpy as np
import torch

from tests import test_torch_seq2seq_steps as s2s
from tests.test_torch_seq2seq_steps import \
    _fairseq_offsets  # noqa: F401 - a fixture
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

MOE = dict(moe_experts=4, moe_every=1, moe_top_k=2, moe_aux_weight=0.5)


def test_frozen_then_unfrozen_steps_match_jax(monkeypatch):
    monkeypatch.setattr(s2s, "ENC", dict(s2s.ENC, **MOE))
    monkeypatch.setattr(s2s, "FROZEN", 1)
    r = s2s._run(0.1, jnp.float32, torch.float32, monkeypatch, steps=2)
    np.testing.assert_allclose(r["loss"][0], r["j_loss"][0], rtol=1e-4)
    np.testing.assert_allclose(r["loss"], r["j_loss"], rtol=1e-3)
    np.testing.assert_allclose(r["gnorm"], r["j_gnorm"], rtol=5e-3)
