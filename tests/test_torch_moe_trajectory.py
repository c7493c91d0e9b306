"""Ten unfrozen MoE CTC steps of the port against the jitted JAX
``make_ctc_steps`` with every dropout at 0.1, the JAX step's seeds
replayed (``tests/test_torch_dropout_trajectories.py``'s bounds: loss
rtol 1e-3, grad norm 5e-3, step 1's loss 1e-4), as
``tests/test_train_dynamics.py`` glues JAX to a torch replica; d 64, f
128, 2 layers (layer 1 an MoE; ``test_torch_moe_ctc.py`` holds one step
of 4 layers), E 4, top-2, ``moe_aux_weight`` 0.5. The batch has a
padding row, whose frames the aux loss counts: its gradient reaches the
zero-variance LayerNorms of that row and is ~1e19 in the first layers on
both sides (the global norm's squares sum in float64 in the port).
"""
from tests.test_torch_dropout_trajectories import CTC_CFG, _check
from tests.test_torch_dropout_trajectories import \
    _fairseq_offsets  # noqa: F401 - a fixture
from tests.test_torch_moe_ctc import MOE
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_topology_trajectories import run_ctc_trajectory

cap_torch_threads()


def test_ten_steps_with_dropout_match_jax(_fairseq_offsets, monkeypatch):
    curves, _, _ = run_ctc_trajectory(monkeypatch, dict(CTC_CFG, **MOE))
    _check(*curves)
