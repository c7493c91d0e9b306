"""Data-parallel CTC steps: two gloo ranks on the CPU, each on its block
of a 4-row global batch whose last row is all padding, take 3 unfrozen
SGD steps with every dropout at 0.1 (the JAX step's seeds, replayed;
both packages' special-token ids fairseq's, as the trajectory tests
set them). The
ranks' parameters are bitwise equal; the global losses, gradient norms
and parameters match the port's one-rank step on the global batch and
the JAX single-device step (``make_ctc_steps``) on it.

Tolerances: 2 ranks against 1, loss rtol 1e-5, gradient norm 1e-4 (the
unclipped norm is about 1 400: one ulp of the f32 sums moves it) and
parameters 1e-6 absolute (the same step summed in another order);
against JAX, the single-process trajectory tests' (loss rtol 1e-4 at
every step, gradient norm 5e-3) and parameters 1e-5 absolute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import AcousticConfig as JaxAcousticConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxCtcModel
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.parallel.sharding import dryrun_multichip
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_dropout_trajectories import (  # noqa: F401
    CTC_CFG, V, JaxSeeds, _fairseq_offsets)
from tests.test_torch_threads import cap_torch_threads
from tests.torch_dp_ranks import LR, ctc_steps, run_ranks

cap_torch_threads()

STEPS = 3


def _batch():
    rng = np.random.default_rng(4)
    b, t, u = 4, 2400, 6
    lengths = np.array([t, 1700, 2000, 0], np.int32)
    signal = rng.normal(size=(b, t)).astype(np.float32)
    signal[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    tokens = rng.integers(4, V, size=(b, u)).astype(np.int32)
    tok_len = np.array([u, u - 2, u - 1, 0], np.int32)
    tokens[np.arange(u)[None, :] >= tok_len[:, None]] = Offsets.PAD
    return {"signal": signal, "signal_lengths": lengths,
            "token_ids": tokens, "token_lengths": tok_len}


def test_two_ranks_match_one_rank_and_jax(_fairseq_offsets, monkeypatch,
                                          tmp_path):
    batch = _batch()
    jmodel = JaxCtcModel(config=JaxAcousticConfig(**CTC_CFG))
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["signal"]),
        jnp.asarray(batch["signal_lengths"]))["params"])
    jtx = jax_opt(jax_lrs(LR, 10, sched_type="constant", warmup_steps=0),
                  "sgd")
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jgrad, jupdate, _ = jax_steps.make_ctc_steps(jmodel, jtx, clip=25.0)
    seeds = JaxSeeds(monkeypatch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    seed_lists, j_loss, j_gnorm = [], [], []
    for step in range(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(7), step)
        jl, jg, jrows, _ = jgrad(jstate.params, jb, key, freeze=False)
        replay, _ = seeds.take()
        seed_lists.append(list(replay._seeds))
        jstate, jn = jupdate(jstate, jg, jrows)
        j_loss.append(float(jl))
        j_gnorm.append(float(jn))
    j_params = params_from_jax(jax.tree.map(np.asarray, jstate.params))

    sd = params_from_jax(params)
    one = ctc_steps(0, 1, None, CTC_CFG, sd, batch, seed_lists)
    two = run_ranks(ctc_steps, 2, tmp_path, CTC_CFG, sd, batch, seed_lists)

    for k, v in two[0]["params"].items():
        assert torch.equal(v, two[1]["params"][k]), k
    assert two[0]["loss"] == two[1]["loss"]
    np.testing.assert_allclose(two[0]["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(two[0]["gnorm"], one["gnorm"], rtol=1e-4)
    np.testing.assert_allclose(two[0]["loss"], j_loss, rtol=1e-4)
    np.testing.assert_allclose(two[0]["gnorm"], j_gnorm, rtol=5e-3)
    check_params(two[0]["params"], one["params"], 1e-6)
    check_params(two[0]["params"], j_params, 1e-5)


def check_params(ours, want, atol):
    """Every parameter within ``atol`` of ``want``'s."""
    for k, v in ours.items():
        torch.testing.assert_close(v, want[k].to(v.dtype), rtol=0,
                                   atol=atol, msg=k)


def test_dryrun_multichip_two_ranks():
    """``parallel/sharding.py:dryrun_multichip``: two gloo ranks' CTC step,
    dropout and masks on, against one rank."""
    out = dryrun_multichip(2)
    assert out["max_param_diff"] <= 1e-5
    assert np.isfinite(out["loss"])
