"""bf16 numerics of the port against the JAX package on the CPU.

* The bf16 ``Dense`` equals the JAX ``Dense`` bitwise: the product is
  rounded to bf16, then the bf16 bias is added with a second rounding.
* The 10-step CTC trajectory (3 frozen steps, then unfrozen) and the
  5-step pretraining trajectory run in bf16 on both sides, from one
  init, against JAX ``make_ctc_steps`` and ``make_pretrain_steps``. The
  loss must stay within rtol 5e-3 of JAX's at every step (f32 holds
  1e-3). A ``Dense`` that rounds product and bias once leaves JAX's CTC
  trajectory by about 2.2e-2 in 10 steps; JAX's order keeps it near
  2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import AcousticConfig as JaxConfig
from audio8_tpu.config import PretrainConfig as JaxPretrainConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxModel
from audio8_tpu.models.wav2vec2 import Wav2Vec2Model as JaxPretrainModel
from audio8_tpu.nn.layers import Dense as JaxDense
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu.utils import Offsets as JaxOffsets
from audio8_tpu_torch.config import AcousticConfig, PretrainConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.wav2vec2 import (Wav2Vec2AcousticModel,
                                              Wav2Vec2Model)
from audio8_tpu_torch.nn.layers import Dense
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import make_ctc_steps, make_pretrain_steps
from audio8_tpu_torch.utils import Offsets

from tests.test_torch_pretrain import (CFG as PRE_CFG, LR as PRE_LR, N_NEG,
                                       _record, _signal)
from tests.test_torch_train import CFG, CLIP, LR, _batch, _jnp, _tensors
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

BF16_LOSS_RTOL = 5e-3


@pytest.fixture(autouse=True)
def _fairseq_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    Offsets.remap_fairseq_ctc()
    JaxOffsets.remap_fairseq_ctc()
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


@pytest.mark.parametrize("rows,d_in,d_out", [(7, 64, 96), (3, 768, 768),
                                             (50, 512, 32)])
def test_bf16_dense_matches_jax_bitwise(rows, d_in, d_out):
    """Small integers in x and w keep every f32 partial sum exact, so the
    two libraries' summation orders agree and only the rounding order
    shows: the products need more than bf16's 8 bits and are rounded,
    then the fractional bias rounds them a second time."""
    rng = np.random.default_rng(rows)
    x = rng.integers(-15, 16, size=(2, rows, d_in)).astype(np.float32)
    w = rng.integers(-15, 16, size=(d_in, d_out)).astype(np.float32)
    b = (rng.normal(size=(d_out,)) * 64).astype(np.float32)
    want = JaxDense(d_out, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}},
        jnp.asarray(x))
    dense = Dense(d_in, d_out, dtype=torch.bfloat16)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(w.T.copy()))
        dense.bias.copy_(torch.from_numpy(b))
    with torch.no_grad():
        got = dense(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    once = torch.nn.functional.linear(  # one rounding: not JAX's result
        torch.from_numpy(x).bfloat16(), dense.weight.detach().bfloat16(),
        dense.bias.detach().bfloat16())
    assert not torch.equal(once, got)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


@pytest.fixture(scope="module")
def ctc_init():
    b = _batch(0)
    params = jax.jit(JaxModel(config=JaxConfig(**CFG)).init)(
        jax.random.PRNGKey(0), jnp.asarray(b["signal"]),
        jnp.asarray(b["signal_lengths"]))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("fused", [None, True])
def test_bf16_ctc_trajectory_matches_jax(ctc_init, fused):
    jmodel = JaxModel(config=JaxConfig(**CFG, fused_attention=fused),
                      dtype=jnp.bfloat16)
    jtx = jax_opt(jax_lrs(LR, 10, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, ctc_init), jtx)
    jgrad, jupdate, _ = jax_steps.make_ctc_steps(jmodel, jtx, clip=CLIP)
    model = Wav2Vec2AcousticModel(AcousticConfig(**CFG,
                                                 fused_attention=fused),
                                  torch.bfloat16)
    model.load_state_dict(params_from_jax(ctc_init), strict=True)
    state = TrainState(model, create_optimizer(
        create_lrs(LR, 10, sched_type="constant", warmup_steps=0)))
    grad_fn, update_fn, _ = make_ctc_steps(model, clip=CLIP)
    batch = _batch(1)
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    j_loss, loss = [], []
    for step in range(10):
        freeze = step <= 2
        jl, jg, jb, _ = jgrad(jstate.params, _jnp(batch), key, freeze=freeze)
        jstate, _ = jupdate(jstate, jg, jb)
        pl, pg, pb, _ = grad_fn(_tensors(batch), gen, freeze=freeze)
        state, _ = update_fn(state, pg, pb)
        j_loss.append(float(jl))
        loss.append(float(pl))
    np.testing.assert_allclose(loss, j_loss, rtol=BF16_LOSS_RTOL)
    assert loss[-1] < loss[3]


def test_bf16_pretrain_trajectory_matches_jax():
    rngs = {k: jax.random.PRNGKey(i)
            for i, k in enumerate(("params", "mask", "gumbel", "dropout"))}
    init = jax.tree.map(np.asarray, JaxPretrainModel(
        config=JaxPretrainConfig(**PRE_CFG)).init(
            rngs, jnp.asarray(_signal(0)), train=True)["params"])
    n = 5
    signal = _signal(2)
    keys = list(jax.random.split(jax.random.PRNGKey(23), n))
    seeds = [_record(init, signal, k, True)[1] for k in keys]
    jtx = jax_opt(jax_lrs(PRE_LR, n, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, init), jtx)
    jstep, _ = jax_steps.make_pretrain_steps(
        JaxPretrainModel(config=JaxPretrainConfig(**PRE_CFG),
                         dtype=jnp.bfloat16), jtx, clip=1.0,
        n_negatives=N_NEG)
    model = Wav2Vec2Model(PretrainConfig(**PRE_CFG), torch.bfloat16)
    model.load_state_dict(params_from_jax(init), strict=True)
    state = TrainState(model, create_optimizer(
        create_lrs(PRE_LR, n, sched_type="constant", warmup_steps=0)))
    step, _ = make_pretrain_steps(model, clip=1.0, n_negatives=N_NEG)
    x = torch.from_numpy(signal)
    j_loss, loss = [], []
    for k, s in zip(keys, seeds):
        jstate, jm = jstep(jstate, jnp.asarray(signal), k)
        state, m = step(state, x, s, torch.Generator())
        j_loss.append(float(jm["loss"]))
        loss.append(float(m["loss"]))
    np.testing.assert_allclose(loss, j_loss, rtol=BF16_LOSS_RTOL)
