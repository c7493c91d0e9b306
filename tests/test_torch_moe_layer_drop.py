"""LayerDrop 0.5 over ten MoE CTC steps of the port against the jitted
JAX ``make_ctc_steps`` (2 layers, layer 1 MoE, E 4, top-2, aux weight
1.0, every dropout at 0.1), the JAX step's seeds and keep decisions
replayed (``tests/test_torch_layer_drop.py:JaxKeeps``). JAX computes a
dropped layer and selects its input, so a dropped MoE layer's aux loss
counts in the objective and its gradient reaches the layer's attention
and router; the port computes a dropped MoE layer on the seeds it would
have drawn and discards only its output. An aux left out would move the
loss by about 2 in ~800, past the bound (loss rtol 1e-3, grad norm
5e-3, step 1's loss 1e-4). The run must drop layer 1 in some steps and
keep it in others. Both packages take fairseq's special-token ids
(``_fairseq_offsets``), as the sibling trajectories do: without the
fixture the port's ids were whatever an earlier test in the worker's
process left, and a remapped blank moved the loss 9%.
"""
from tests.test_torch_dropout_trajectories import CTC_CFG, _check
from tests.test_torch_dropout_trajectories import \
    _fairseq_offsets  # noqa: F401 - a fixture
from tests.test_torch_layer_drop import KEEPS_SEEN, JaxKeeps
from tests.test_torch_moe_ctc import MOE
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_topology_trajectories import run_ctc_trajectory

cap_torch_threads()


def test_dropped_moe_layer_aux_counts_as_in_jax(_fairseq_offsets,
                                                monkeypatch):
    KEEPS_SEEN.clear()
    cfg = dict(CTC_CFG, layer_drop=0.5, **dict(MOE, moe_aux_weight=1.0))
    curves, _, _ = run_ctc_trajectory(monkeypatch, cfg, seeds_cls=JaxKeeps)
    moe_layer = KEEPS_SEEN[1::2]  # layer 1 of each step
    assert any(moe_layer) and not all(moe_layer)
    _check(*curves)
