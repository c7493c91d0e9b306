"""Training trajectories of the port's ``make_seq2seq_steps`` against the
JAX package's on one init, on the CPU.

* float32, every dropout at 0.1 (the encoder's and the decoder's,
  residual and attention probabilities), 3 frozen steps then 7 unfrozen:
  the jitted JAX step's dropout seeds are recorded in program order
  (``test_torch_dropout_trajectories.JaxSeeds``) and fed to the port
  through ``SeedReplay``, which must use them all. Tolerances are the
  CTC trajectories': loss rtol 1e-3, grad norm rtol 5e-3, step 1 loss
  rtol 1e-4.
* bfloat16: ``test_torch_seq2seq_bf16.py``.
* ``sequence_loss`` against JAX's in both reductions.
"""
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
from audio8_tpu.utils import Offsets as JaxOffsets
from audio8_tpu_torch.config import DecoderConfig, EncoderConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.seq2seq import Seq2Seq
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import make_seq2seq_steps, sequence_loss
from audio8_tpu_torch.utils import Offsets

from tests.test_torch_dropout_trajectories import JaxSeeds
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

FX = ((32, 10, 5), (32, 3, 2))
V, LR, CLIP = 12, 2e-4, 25.0
ENC = dict(d_model=32, num_heads=2, num_layers=1, d_ff=64,
           custom_conv_features=FX, timestep_masking=0.0,
           channel_masking=0.0, freeze_fx=False)
DEC = dict(vocab_size=V, d_model=32, num_heads=2, num_layers=2, d_ff=64,
           max_len=64)
FROZEN = 3


@pytest.fixture(autouse=True)
def _fairseq_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    Offsets.remap_fairseq_ctc()
    JaxOffsets.remap_fairseq_ctc()
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


def _batch(seed):
    """Three rows, the last a padding row of a snapped batch (zero
    signal and lengths)."""
    rng = np.random.default_rng(seed)
    sig = rng.normal(size=(3, 2400)).astype(np.float32)
    sl = np.array([2400, 1700, 0], np.int32)
    sig[np.arange(2400)[None, :] >= sl[:, None]] = 0.0
    tl = np.array([7, 5, 0], np.int32)
    ids = rng.integers(4, V, size=(3, 7)).astype(np.int32)
    ids[:, 0] = Offsets.GO
    ids[np.arange(7)[None, :] >= tl[:, None]] = Offsets.PAD
    for i, n in enumerate(tl):
        if n:
            ids[i, n - 1] = Offsets.EOS
    return {"signal": sig, "signal_lengths": sl, "token_ids": ids,
            "token_lengths": tl}


def _run(dropout, jdt, tdt, monkeypatch=None, steps=10):
    batch = _batch(1)
    enc = dict(ENC, dropout=dropout)
    dec = dict(DEC, dropout=dropout)
    jmodel = JaxSeq2Seq(encoder_config=JaxEncoderConfig(**enc),
                        decoder_config=JaxDecoderConfig(**dec), dtype=jdt)
    jb_ = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jb_["signal"], jb_["signal_lengths"],
        jb_["token_ids"][:, :-1], jb_["token_lengths"])["params"]
    params = jax.tree.map(np.asarray, params)
    jtx = jax_opt(jax_lrs(LR, steps, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jgrad, jupdate, _, _ = jax_steps.make_seq2seq_steps(jmodel, jtx,
                                                        clip=CLIP)
    model = Seq2Seq(EncoderConfig(**enc), DecoderConfig(**dec), tdt)
    model.load_state_dict(params_from_jax(params), strict=True)
    state = TrainState(model, create_optimizer(
        create_lrs(LR, steps, sched_type="constant", warmup_steps=0)))
    grad_fn, update_fn, _, _ = make_seq2seq_steps(model, clip=CLIP)
    seeds = JaxSeeds(monkeypatch) if dropout else None
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {"j_loss": [], "j_gnorm": [], "loss": [], "gnorm": []}
    for step in range(steps):
        freeze = step < FROZEN
        key = jax.random.fold_in(jax.random.PRNGKey(7), step)
        jl, jg, jb, _ = jgrad(jstate.params, jb_, key, freeze=freeze)
        gen = torch.Generator()
        if seeds is not None:
            gen, _ = seeds.take()
        jstate, jn = jupdate(jstate, jg, jb)
        pl, pg, pb, _ = grad_fn(tb, gen, freeze=freeze)
        if seeds is not None:
            assert gen.remaining == 0  # as many draws, in the same order
        state, pn = update_fn(state, pg, pb)
        out["j_loss"].append(float(jl))
        out["j_gnorm"].append(float(jn))
        out["loss"].append(float(pl))
        out["gnorm"].append(float(pn))
    return out


def test_f32_trajectory_with_dropout_freeze_then_unfreeze(monkeypatch):
    r = _run(0.1, jnp.float32, torch.float32, monkeypatch)
    np.testing.assert_allclose(r["loss"], r["j_loss"], rtol=1e-3)
    np.testing.assert_allclose(r["gnorm"], r["j_gnorm"], rtol=5e-3)
    np.testing.assert_allclose(r["loss"][0], r["j_loss"][0], rtol=1e-4)
    assert r["j_loss"][-1] < r["j_loss"][0]  # the steps trained


@pytest.mark.parametrize("reduction", ["sum", "token"])
def test_sequence_loss_matches_jax(reduction):
    rng = np.random.default_rng(2)
    lp = np.log(rng.dirichlet(np.ones(V), size=(3, 5))).astype(np.float32)
    tgt = rng.integers(0, V, size=(3, 5)).astype(np.int32)
    tgt[2, 2:] = Offsets.PAD
    want = float(jax_steps.sequence_loss(jnp.asarray(lp), jnp.asarray(tgt),
                                         reduction))
    got = float(sequence_loss(torch.from_numpy(lp), torch.from_numpy(tgt),
                              reduction))
    np.testing.assert_allclose(got, want, rtol=1e-6)
