"""HuBERT and data2vec in bfloat16: the port's steps against the jitted JAX
steps on the CPU (jitted, not eager: XLA on the CPU keeps some bf16
intermediates in float32 that eager JAX rounds).

``final_proj`` is a bf16 ``Dense`` (its product rounded, then the bias
added and rounded again) whose output is cast to float32 before the
norm; data2vec's targets and loss sum in float32. Every dropout at 0.1,
the seeds replayed as ``tests/test_torch_hubert.py`` does: the loss and
gradient norm of every step within rtol 5e-3.
"""
import numpy as np
import torch

from tests.test_torch_data2vec import CFG as D2V_CFG
from tests.test_torch_data2vec import D2V_BASE, run_d2v_trajectory
from tests.test_torch_hubert import CFG, run_hubert_trajectory
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

RTOL = 5e-3


def test_hubert_bf16_trajectory_matches_jax(monkeypatch):
    (loss, gnorm, j_loss, j_gnorm), m, jm = run_hubert_trajectory(
        monkeypatch, CFG, steps=6, dtype=torch.bfloat16)
    np.testing.assert_allclose(loss, j_loss, rtol=RTOL)
    np.testing.assert_allclose(gnorm, j_gnorm, rtol=RTOL)
    assert np.isfinite(loss).all()


def test_data2vec_bf16_trajectory_matches_jax(monkeypatch):
    (loss, gnorm, j_loss, j_gnorm), _, _ = run_d2v_trajectory(
        monkeypatch, dict(D2V_CFG, **D2V_BASE), steps=4,
        dtype=torch.bfloat16)
    np.testing.assert_allclose(loss, j_loss, rtol=RTOL)
    np.testing.assert_allclose(gnorm, j_gnorm, rtol=RTOL)
