"""Tensor parallelism over the encoder topologies and attention paths:
two gloo ranks on the CPU (one model group) take an unfrozen SGD CTC
step of each layout on two rows (one of them shorter), every dropout at 0.1 (one generator seeded alike
on every rank and in the one process), against one process: the
conformer (relative and rotary positions: its attention split, its
position biases and ``linear_pos`` replicated and summed over the
group), WavLM (the gate and the bucket bias replicated), the stable
layer norm (pre-norm), LayerDrop with remat, the attention block
(``fused_attention="block"``: the partial O projection, its bias after
the sum) and the TPU kernel's semantics (``fused_attention=True``),
sequence parallelism on where the stack takes it. Loss rtol 1e-4,
gradient norm 1e-3, parameters 1e-6 plus 1e-5 of their size; the ranks'
whole parameters bitwise equal."""
import numpy as np
import pytest
import torch

from tests.test_torch_dp_ctc import _batch
from tests.test_torch_dropout_trajectories import (  # noqa: F401
    CTC_CFG, _fairseq_offsets)
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_tp_cli import PARAM_ATOL, PARAM_RTOL
from tests.torch_tp_ranks import ctc_tp_steps, run_tp_ranks

cap_torch_threads()

CONFORMER = dict(encoder_type="conformer", extractor_mode="layer",
                 conv_bias=True, conv_depthwise_kernel_size=7)
LAYOUTS = {
    "conformer_rel": dict(CONFORMER, position_embeddings_type="relative"),
    "conformer_rope": dict(CONFORMER, position_embeddings_type="rotary"),
    "wavlm_sp": dict(gated_rel_pos=True, rel_pos_buckets=32,
                     rel_pos_max_distance=64, sequence_parallel=True),
    "pre_norm_sp": dict(pre_norm=True, extractor_mode="layer",
                        conv_bias=True, sequence_parallel=True),
    "layer_drop_remat_sp": dict(layer_drop=0.5, remat=True,
                                sequence_parallel=True),
    "block_sp": dict(fused_attention="block", sequence_parallel=True),
    "kernel": dict(fused_attention=True),
}


def _params(cfg):
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel

    model = Wav2Vec2AcousticModel(AcousticConfig(**cfg),
                                  generator=torch.Generator().manual_seed(0))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batch = {k: v[1:3] for k, v in _batch().items()}
    cases = {name: dict(CTC_CFG, **layout)
             for name, layout in LAYOUTS.items()}
    params = {name: _params(cfg) for name, cfg in cases.items()}
    jobs = [(ctc_tp_steps, (cfg, params[name], batch, 1))
            for name, cfg in cases.items()]
    ranks = run_tp_ranks(jobs, 2, 2, tmp_path_factory.mktemp("tp_topo"))
    one = {name: ctc_tp_steps(0, 1, 1, cfg, params[name], batch, 1)
           for name, cfg in cases.items()}
    return {name: ([r[i] for r in ranks], one[name])
            for i, name in enumerate(cases)}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_at_tp2_matches_one_process(runs, name):
    ranks, one = runs[name]
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
    split = [k for k, v in ranks[0]["own"].items()
             if v.shape != ranks[0]["params"][k].shape]
    assert split
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["gnorm"], one["gnorm"], rtol=1e-3)
    for k, v in one["params"].items():
        np.testing.assert_allclose(ranks[0]["params"][k].numpy(),
                                   v.numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)
