"""Tensor parallelism in the models with a decoder or a text tower, held
to JAX: two gloo ranks on the CPU (one model group) take 2 unfrozen SGD
steps, every dropout at 0.1, with the seeds that the JAX package's
single-device jitted step drew (``JaxSeeds``), sequence parallelism off
and on:

- seq2seq (``tests/test_torch_seq2seq_steps.py``'s model and batch): the
  encoder's and the decoder's self attention, the decoder's cross
  attention (``src_attn``) and FFNs split;
- the paired model (``tests/test_torch_paired_steps.py``'s, max
  reductions): the audio tower and the text tower split, the text
  tower's relative-position table replicated and summed over the group.

Against JAX: loss rtol 1e-4, gradient norm 1e-3, every parameter within
1e-5; the ranks' whole parameters bitwise equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import DecoderConfig as JaxDecoderConfig
from audio8_tpu.config import EncoderConfig as JaxEncoderConfig
from audio8_tpu.models.seq2seq import Seq2Seq as JaxSeq2Seq
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.models.convert import params_from_jax
from tests.test_torch_dp_ctc import check_params
from tests.test_torch_dropout_trajectories import JaxSeeds
from tests.test_torch_paired import AUDIO, OUT_DIM, STACK, TEXT
from tests.test_torch_paired import batch as paired_batch
from tests.test_torch_paired import models as paired_models
from tests.test_torch_seq2seq_steps import DEC, ENC
from tests.test_torch_seq2seq_steps import _batch as s2s_batch
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_tp_steps import fairseq_offsets
from tests.torch_dp_ranks import LR
from tests.torch_tp_ranks import (paired_tp_steps, run_tp_ranks,
                                  seq2seq_tp_steps)

cap_torch_threads()

STEPS = 2
DROP = 0.1
MODES = ("tp", "sp")
TEMP = 0.07
PAIRED_AUDIO = dict(AUDIO, dropout=DROP, reduction_type="sha_max")
PAIRED_TEXT = dict(TEXT, dropout=DROP, encoder_type="transformer",
                   reduction_type="2ha_max")


def _sgd():
    return jax_opt(jax_lrs(LR, 10, sched_type="constant", warmup_steps=0),
                   "sgd")


def _jax_steps(jgrad, jupdate, params, batch, monkeypatch, **flags):
    """``STEPS`` jitted steps (keys folded from 7) recording each step's
    dropout seeds: the losses, gradient norms, the parameters after (the
    port's names) and the seed lists."""
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), _sgd())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    seeds = JaxSeeds(monkeypatch)
    losses, gnorms, seed_lists = [], [], []
    for step in range(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(7), step)
        jl, *_, jg, jrows, _ = jgrad(jstate.params, jb, key, **flags)
        replay, _ = seeds.take()
        seed_lists.append(list(replay._seeds))
        jstate, jn = jupdate(jstate, jg, jrows)
        losses.append(float(jl))
        gnorms.append(float(jn))
    return (losses, gnorms,
            params_from_jax(jax.tree.map(np.asarray, jstate.params)),
            seed_lists)


def jax_seq2seq(monkeypatch):
    batch = s2s_batch(1)
    enc, dec = dict(ENC, dropout=DROP), dict(DEC, dropout=DROP)
    jmodel = JaxSeq2Seq(encoder_config=JaxEncoderConfig(**enc),
                        decoder_config=JaxDecoderConfig(**dec))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jb["signal"], jb["signal_lengths"],
        jb["token_ids"][:, :-1], jb["token_lengths"])["params"])
    jgrad, jupdate, _, _ = jax_steps.make_seq2seq_steps(jmodel, _sgd(),
                                                        clip=25.0)
    return (batch, params_from_jax(params),
            _jax_steps(jgrad, jupdate, params, batch, monkeypatch,
                       freeze=False))


def jax_paired(monkeypatch):
    batch = paired_batch(1)
    jm, jl, params, _ = paired_models(DROP, jnp.float32, torch.float32,
                                      init_temp=TEMP, audio="sha_max",
                                      text="2ha_max")
    jgrad, jupdate, _ = jax_steps.make_paired_steps(jm, jl, _sgd(),
                                                    clip=25.0)
    return (batch, params_from_jax(params),
            _jax_steps(jgrad, jupdate, params, batch, monkeypatch,
                       freeze_audio=False, freeze_text=False))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with fairseq_offsets():
        with pytest.MonkeyPatch.context() as mp:
            s_batch, s_params, s_jax = jax_seq2seq(mp)
        with pytest.MonkeyPatch.context() as mp:
            p_batch, p_params, p_jax = jax_paired(mp)
        jobs = []
        for mode in MODES:
            sp = mode == "sp"
            jobs.append((seq2seq_tp_steps, (
                dict(ENC, dropout=DROP, sequence_parallel=sp),
                dict(DEC, dropout=DROP), s_params, s_batch, s_jax[3])))
            jobs.append((paired_tp_steps, (
                dict(PAIRED_AUDIO, sequence_parallel=sp), PAIRED_TEXT,
                STACK, OUT_DIM, TEMP, p_params, p_batch, p_jax[3])))
        ranks = run_tp_ranks(jobs, 2, 2, tmp_path_factory.mktemp("tp_jax2"))
    names = [(kind, mode) for mode in MODES for kind in ("seq2seq",
                                                          "paired")]
    return ({"seq2seq": s_jax, "paired": p_jax},
            {key: [r[i] for r in ranks] for i, key in enumerate(names)})


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["seq2seq", "paired"])
def test_tp2_matches_jax(runs, kind, mode):
    jax_runs, tp = runs
    j_loss, j_gnorm, j_params, _ = jax_runs[kind]
    ranks = tp[kind, mode]
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
    np.testing.assert_allclose(ranks[0]["loss"], j_loss, rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["gnorm"], j_gnorm, rtol=1e-3)
    check_params(ranks[0]["params"], j_params, 1e-5)
