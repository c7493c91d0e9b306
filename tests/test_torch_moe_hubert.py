"""One MoE HuBERT step of the port against the jitted JAX
``make_hubert_steps`` (``tests/test_torch_hubert.py``'s model and batch
with layer 1 an MoE of E 4, ``moe_aux_weight`` 0.5, every dropout at
0.1): loss, gradient norm and ``moe_aux`` within the bounds of
``tests/test_torch_moe_ssl.py``.
"""
from tests.test_torch_hubert import CFG as HUBERT_CFG
from tests.test_torch_hubert import run_hubert_trajectory
from tests.test_torch_moe_ssl import MOE, _check
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


def test_hubert_step_matches_jax(monkeypatch):
    _, m, jm = run_hubert_trajectory(monkeypatch, dict(HUBERT_CFG, **MOE),
                                     steps=1)
    _check(m, jm)
