"""ZeRO-1 and FSDP (``parallel/zero.py``) against the data-parallel step
(``parallel/sharding.py``), on gloo ranks on the CPU.

* Two and three ranks (three: the parameter count is no multiple of the
  world, so the chunks end in padding), every dropout 0.1, the span masks
  on, the global batch's last row padding: 2 AdamW CTC steps and 2 AdamW
  pretraining steps under ``dp``, ``zero1`` and ``fsdp``. The ranks are
  bitwise equal to each other; ZeRO-1 and FSDP hold the same world's DP
  run to loss rtol 1e-6 and parameters and moments 1e-6 absolute (they
  are bitwise equal: the gloo sums are rounded once, in float64, so no
  element's sum depends on where it lies in a buffer).
* FSDP composes with ``--remat``, LayerDrop (every rank drops the same
  layers), the MoE FFN (``--moe_experts 4``), WavLM's shared position
  bias and the conformer: bitwise the DP run.
  Under gradient accumulation each micro-step is reduce-scattered, so the
  micro-steps are summed in another order than DP's: held with SGD, loss
  rtol 1e-6 and parameters 1e-6 absolute.
* What a rank stores: ZeRO-1 whole parameters and its chunk of the
  moments; FSDP no element in the model's parameters, its chunks of the
  parameters and moments (about ``1/world`` of DP's).
* One rank (no group): ``shard_state`` shards nothing, and a step is the
  plain one, bitwise."""
import numpy as np
import pytest
import torch

from audio8_tpu_torch.config import AcousticConfig, PretrainConfig
from audio8_tpu_torch.models.wav2vec2 import (Wav2Vec2AcousticModel,
                                              Wav2Vec2Model)
from audio8_tpu_torch.parallel.zero import shard_state
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads
from tests.torch_dp_ranks import kept_offsets, run_ranks, several
from tests.torch_zero_ranks import adamw_state, ctc_run, pretrain_run

cap_torch_threads()

FX = ((16, 10, 5), (16, 3, 2))
DROP = dict(dropout=0.1, attention_dropout=0.1)
CTC = dict(num_labels=12, d_model=32, num_heads=2, num_layers=2, d_ff=64,
           custom_conv_features=FX, timestep_masking=0.3,
           timestep_mask_len=4, channel_masking=0.1, channel_mask_len=4,
           freeze_fx=False, **DROP)
PRETRAIN = dict(d_model=32, num_heads=2, num_layers=2, d_ff=64,
                custom_conv_features=FX, num_vq_vars=8, num_vq_groups=2,
                final_dim=16, n_negatives=10, **DROP)
MODES = ("dp", "zero1", "fsdp")
STEPS = 2


def ctc_batch(world: int) -> dict:
    """A global batch of ``2 * world`` rows, its last row padding."""
    rng = np.random.default_rng(4)
    b, t, u = 2 * world, 2400, 6
    lengths = rng.integers(1200, t + 1, size=b).astype(np.int32)
    lengths[-1] = 0
    signal = rng.normal(size=(b, t)).astype(np.float32)
    signal[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    tokens = rng.integers(4, CTC["num_labels"], size=(b, u)).astype(np.int32)
    tok_len = np.where(lengths > 0, u, 0).astype(np.int32)
    tokens[np.arange(u)[None, :] >= tok_len[:, None]] = Offsets.PAD
    return {"signal": signal, "signal_lengths": lengths,
            "token_ids": tokens, "token_lengths": tok_len}


def weights(model_cls, cfg_cls, cfg, seed=0) -> dict:
    model = model_cls(cfg_cls(**cfg),
                      generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


VARIANTS = {"remat": dict(CTC, remat=True),
            "layer_drop": dict(CTC, layer_drop=0.5),
            "moe": dict(CTC, moe_experts=4, moe_top_k=2, moe_every=1),
            # WavLM's bucket table lies in layer 0 but is read by the
            # stack: it stays in the root segment
            "wavlm": dict(CTC, gated_rel_pos=True, rel_pos_buckets=16,
                          rel_pos_max_distance=32),
            "conformer": dict(CTC, encoder_type="conformer",
                              conv_depthwise_kernel_size=3)}


def _jobs(world):
    ctc = weights(Wav2Vec2AcousticModel, AcousticConfig, CTC)
    pre = weights(Wav2Vec2Model, PretrainConfig, PRETRAIN, 1)
    signal = np.random.default_rng(3).normal(
        size=(2 * world, 4000)).astype(np.float32)
    batch = ctc_batch(world)
    jobs = {("ctc", m): (ctc_run, (CTC, ctc, batch, STEPS, m))
            for m in MODES}
    jobs.update({("pretrain", m): (pretrain_run, (PRETRAIN, pre, signal,
                                                  STEPS, m))
                 for m in MODES})
    if world == 2:
        for name, cfg in VARIANTS.items():
            w = weights(Wav2Vec2AcousticModel, AcousticConfig, cfg)
            for m in ("dp", "fsdp"):
                jobs[(name, m)] = (ctc_run, (cfg, w, batch, STEPS, m))
        sgd = {"optim": "sgd", "lr": 1e-2}
        for m in ("dp", "fsdp"):
            jobs[("accum", m)] = (ctc_run, (CTC, ctc, batch, STEPS, m, 7, 2,
                                            sgd))
    return jobs


_RUNS = {}


def spawned(world: int, tmp_path_factory) -> dict:
    """Every job of one world, on one spawn of its ranks (once per
    module)."""
    if world not in _RUNS:
        with kept_offsets():
            Offsets.remap_fairseq_ctc()
            jobs = _jobs(world)
            keys = list(jobs)
            out = run_ranks(several, world,
                            tmp_path_factory.mktemp(f"zero{world}"),
                            [jobs[k] for k in keys])
        _RUNS[world] = {k: [r[i] for r in out] for i, k in enumerate(keys)}
    return _RUNS[world]


def _max_diff(a: dict, b: dict) -> float:
    return max(float((v - b[k]).abs().max()) for k, v in a.items())


def _check(runs, kind, mode, ref="dp", moments=True):
    ranks = runs[(kind, mode)]
    for r in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            assert torch.equal(v, r["params"][k]), (kind, mode, k)
        assert r["loss"] == ranks[0]["loss"]
    mine, dp = ranks[0], runs[(kind, ref)][0]
    np.testing.assert_allclose(mine["loss"], dp["loss"], rtol=1e-6)
    assert _max_diff(mine["params"], dp["params"]) <= 1e-6
    if moments:
        assert _max_diff(mine["mu"], dp["mu"]) <= 1e-6
        assert _max_diff(mine["nu"], dp["nu"]) <= 1e-6
    return mine, dp


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("kind", ["ctc", "pretrain"])
@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_steps_match_data_parallel(world, kind, mode,
                                           tmp_path_factory):
    runs = spawned(world, tmp_path_factory)
    mine, dp = _check(runs, kind, mode)
    np.testing.assert_allclose(mine["gnorm"], dp["gnorm"], rtol=1e-6)
    if kind == "ctc":
        np.testing.assert_allclose(mine["eval_loss"], dp["eval_loss"],
                                   rtol=1e-6)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_each_rank_stores_its_chunk(world, mode, tmp_path_factory):
    runs = spawned(world, tmp_path_factory)
    n = sum(v.numel() for v in runs[("ctc", "dp")][0]["params"].values())
    for r in runs[("ctc", mode)]:
        stored = r["stored"]
        # each leaf at a multiple of 128 elements, padded to world * 128
        slack = 128 * (len(r["params"]) + world)
        assert n / world <= stored["moments"] / 2 <= (n + slack) / world
        if mode == "zero1":
            assert n <= stored["params"] <= n + slack
        else:
            assert n / world <= stored["params"] <= (n + slack) / world
        assert stored["grads"] == 0  # freed after the step


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fsdp_composes_with_remat_layer_drop_moe_topologies(
        variant, tmp_path_factory):
    runs = spawned(2, tmp_path_factory)
    mine, dp = _check(runs, variant, "fsdp")
    np.testing.assert_allclose(mine["gnorm"], dp["gnorm"], rtol=1e-6)


def test_fsdp_gradient_accumulation(tmp_path_factory):
    runs = spawned(2, tmp_path_factory)
    _check(runs, "accum", "fsdp", moments=False)


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_one_process_shards_nothing(mode):
    """No group (one rank): the state stays whole and a step is bitwise
    the plain one."""
    with kept_offsets():
        Offsets.remap_fairseq_ctc()
        w = weights(Wav2Vec2AcousticModel, AcousticConfig, CTC)
        batch = ctc_batch(1)
        plain = ctc_run(0, 1, None, CTC, w, batch, STEPS, "dp")
        sharded = ctc_run(0, 1, None, CTC, w, batch, STEPS, mode)
    assert sharded["loss"] == plain["loss"]
    for k, v in plain["params"].items():
        assert torch.equal(v, sharded["params"][k]), k
    model = Wav2Vec2AcousticModel(AcousticConfig(**CTC))
    state = adamw_state(model)
    assert shard_state(state, None, zero1=True, fsdp=mode == "fsdp") is None
    assert state.shards is None
