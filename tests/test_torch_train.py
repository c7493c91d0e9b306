"""CTC fine-tuning in the port against the JAX package on the CPU.

* The loss and grad-norm trajectory of the port's ``make_ctc_steps`` is
  glued to the JAX ``make_ctc_steps`` on ``AcousticConfig(
  fused_attention=True)`` (the Pallas attention core in interpret mode,
  the CTC scan) from the same weights, as ``tests/test_train_dynamics.py``
  glues JAX to a torch replica: loss rtol 1e-3, grad norm rtol 5e-3,
  step-1 loss rtol 1e-4. Dropout and masking are off, so both runs are
  deterministic; the batch has a ragged row and a padding row. Covered:
  the grad_fn/update_fn pair with the encoder frozen then unfrozen, two
  micro-batches per step (``--grad_accum 2``), and the fused
  ``train_step``, which also runs with ``fused_attention="block"`` on
  both sides (the attention block kernel in interpret mode).
* A JAX run's parameters, AdamW moments and step count carried into the
  port (``params_from_jax`` with the optimizer state) train on along the
  same trajectory.
* Hash dropout, hash-uniform bits and span masks are bit-exact with the
  JAX package for the same integer seed.
* The dataset yields the JAX ``AudioTextLetterDataset``'s batches for the
  same manifest and seed (``lane_align=False``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio8_tpu.config import AcousticConfig as JaxConfig
from audio8_tpu.data.datasets import AudioTextLetterDataset as JaxDataset
from audio8_tpu.models.text import TextVectorizer as JaxVectorizer
from audio8_tpu.models.text import read_vocab_list as jax_vocab
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxModel
from audio8_tpu.nn.dropout import _hash_dropout
from audio8_tpu.ops import hashrand as jax_hashrand
from audio8_tpu.ops.masks import span_mask as jax_span_mask
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu.utils import Offsets as JaxOffsets
from audio8_tpu_torch.config import AcousticConfig
from audio8_tpu_torch.data.datasets import AudioTextLetterDataset
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.text import TextVectorizer, read_vocab_list
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.nn.dropout import hash_dropout
from audio8_tpu_torch.ops.hashrand import hash_uniform
from audio8_tpu_torch.ops.masks import span_mask
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import accumulate_grads, make_ctc_steps
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

FX = ((32, 10, 5), (32, 3, 2))
D, H, L, V = 64, 4, 2, 12
LR, CLIP = 2e-4, 25.0
CFG = dict(num_labels=V, d_model=D, num_heads=H, num_layers=L, d_ff=128,
           custom_conv_features=FX, dropout=0.0, timestep_masking=0.0,
           channel_masking=0.0, freeze_fx=False)


@pytest.fixture(autouse=True)
def _fairseq_offsets():
    """Both registries in the fairseq CTC layout (blank = 0, pad = 1);
    the port's is restored here, the JAX one by conftest."""
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    Offsets.remap_fairseq_ctc()
    JaxOffsets.remap_fairseq_ctc()
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


def _batch(seed):
    rng = np.random.default_rng(seed)
    b, t, u = 3, 4000, 6
    lengths = np.array([t, 2900, 0], np.int32)
    signal = rng.normal(size=(b, t)).astype(np.float32)
    signal[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    tokens = rng.integers(4, V, size=(b, u)).astype(np.int32)
    tok_len = np.array([u, u - 2, 0], np.int32)
    tokens[np.arange(u)[None, :] >= tok_len[:, None]] = Offsets.PAD
    return {"signal": signal, "signal_lengths": lengths,
            "token_ids": tokens, "token_lengths": tok_len}


@pytest.fixture(scope="module")
def init_params():
    b = _batch(0)
    model = JaxModel(config=JaxConfig(**CFG, fused_attention=True))
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(b["signal"]),
                                 jnp.asarray(b["signal_lengths"]))["params"]
    return jax.tree.map(np.asarray, params)


def _both(init_params, fused=True):
    """The two packages' models, states and steps from one init, both
    with ``fused_attention=fused``."""
    jmodel = JaxModel(config=JaxConfig(**CFG, fused_attention=fused))
    jtx = jax_opt(jax_lrs(LR, 10, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, init_params), jtx)
    jsteps = jax_steps.make_ctc_steps(jmodel, jtx, clip=CLIP)
    model = Wav2Vec2AcousticModel(AcousticConfig(**CFG,
                                                 fused_attention=fused))
    model.load_state_dict(params_from_jax(init_params), strict=True)
    state = TrainState(model, create_optimizer(
        create_lrs(LR, 10, sched_type="constant", warmup_steps=0)))
    return (jstate, jsteps), (state, make_ctc_steps(model, clip=CLIP))


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _check(o_loss, o_gnorm, t_loss, t_gnorm):
    np.testing.assert_allclose(o_loss, t_loss, rtol=1e-3)
    np.testing.assert_allclose(o_gnorm, t_gnorm, rtol=5e-3)
    np.testing.assert_allclose(o_loss[0], t_loss[0], rtol=1e-4)


def test_trajectory_frozen_then_unfrozen(init_params):
    (jstate, (jgrad, jupdate, _)), (state, (grad_fn, update_fn, _)) = \
        _both(init_params)
    batch = _batch(1)
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    j_loss, j_gnorm, loss, gnorm = [], [], [], []
    for step in range(10):
        freeze = step <= 2
        jl, jg, jb, _ = jgrad(jstate.params, _jnp(batch), key, freeze=freeze)
        jstate, jn = jupdate(jstate, jg, jb)
        pl, pg, pb, _ = grad_fn(_tensors(batch), gen, freeze=freeze)
        state, pn = update_fn(state, pg, pb)
        j_loss.append(float(jl))
        j_gnorm.append(float(jn))
        loss.append(float(pl))
        gnorm.append(float(pn))
    _check(loss, gnorm, j_loss, j_gnorm)
    assert loss[-1] < loss[3]  # unfrozen steps train the encoder too


def test_trajectory_grad_accum_2(init_params):
    (jstate, (jgrad, jupdate, _)), (state, (grad_fn, update_fn, _)) = \
        _both(init_params)
    micro = [_batch(2), _batch(3)]
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    j_loss, j_gnorm, loss, gnorm = [], [], [], []
    for step in range(5):
        freeze = step <= 1
        jacc, acc, jtot, tot, jsum, psum = None, None, 0.0, 0.0, 0.0, 0.0
        for b in micro:
            jl, jg, jb, _ = jgrad(jstate.params, _jnp(b), key, freeze=freeze)
            jacc = jax_steps.accumulate_grads(jacc, jg)
            pl, pg, pb, _ = grad_fn(_tensors(b), gen, freeze=freeze)
            acc = accumulate_grads(acc, pg)
            jtot += float(jb)
            tot += float(pb)
            jsum += float(jl)
            psum += float(pl)
        jstate, jn = jupdate(jstate, jacc, jnp.asarray(jtot, jnp.float32))
        state, pn = update_fn(state, acc, tot)
        j_loss.append(jsum)
        j_gnorm.append(float(jn))
        loss.append(psum)
        gnorm.append(float(pn))
    _check(loss, gnorm, j_loss, j_gnorm)


@pytest.mark.parametrize("fused", [True, "block"])
def test_fused_train_step(init_params, fused):
    (jstate, (jgrad, _, _)), (state, (grad_fn, _, _)) = _both(init_params,
                                                              fused)
    batch = _batch(4)
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    j_loss, loss = [], []
    for _ in range(4):
        jstate, jl, _, _ = jgrad.train_step(jstate, _jnp(batch), key,
                                            freeze=False)
        state, pl, _, _ = grad_fn.train_step(state, _tensors(batch), gen,
                                             freeze=False)
        j_loss.append(float(jl))
        loss.append(float(pl))
    np.testing.assert_allclose(loss, j_loss, rtol=1e-3)
    np.testing.assert_allclose(loss[0], j_loss[0], rtol=1e-4)


def test_state_carried_from_jax(init_params):
    (jstate, (jgrad, jupdate, _)), (state, (grad_fn, update_fn, _)) = \
        _both(init_params)
    batch = _batch(5)
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    for _ in range(2):  # JAX alone
        _, jg, jb, _ = jgrad(jstate.params, _jnp(batch), key, freeze=False)
        jstate, _ = jupdate(jstate, jg, jb)
    params, (count, mu, nu) = params_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.opt_state))
    assert count == 2
    state.model.load_state_dict(params, strict=True)
    state.load_opt_state(count, mu, nu)
    j_loss, j_gnorm, loss, gnorm = [], [], [], []
    for _ in range(3):  # both, from the carried state
        jl, jg, jb, _ = jgrad(jstate.params, _jnp(batch), key, freeze=False)
        jstate, jn = jupdate(jstate, jg, jb)
        pl, pg, pb, _ = grad_fn(_tensors(batch), gen, freeze=False)
        state, pn = update_fn(state, pg, pb)
        j_loss.append(float(jl))
        j_gnorm.append(float(jn))
        loss.append(float(pl))
        gnorm.append(float(pn))
    assert state.step == 5
    _check(loss, gnorm, j_loss, j_gnorm)


@pytest.mark.parametrize("seed", [12345, -7, 2 ** 31 - 2])
def test_hash_dropout_bit_exact(seed):
    x = np.random.default_rng(0).normal(size=(3, 50, 17)).astype(np.float32)
    want = np.asarray(_hash_dropout(jnp.asarray(x), 0.1,
                                    jnp.asarray(seed, jnp.int32)))
    got = hash_dropout(torch.from_numpy(x), 0.1, seed & 0xFFFFFFFF).numpy()
    assert np.array_equal(got, want)
    u_want = np.asarray(jax_hashrand.hash_uniform(
        (4, 33), jnp.asarray(seed, jnp.int32)))
    assert np.array_equal(hash_uniform((4, 33), seed & 0xFFFFFFFF).numpy(),
                          u_want)


@pytest.mark.parametrize("b,t,p,span", [(4, 120, 0.5, 10), (3, 768, 0.1, 64),
                                        (2, 9, 0.5, 10)])
def test_span_mask_bit_exact(b, t, p, span):
    key = jax.random.PRNGKey(7)
    seed = int(jax_hashrand.seed_from_key(key))
    want = np.asarray(jax_span_mask(key, b, t, p, span))
    got = span_mask(seed & 0xFFFFFFFF, b, t, p, span).numpy()
    assert np.array_equal(got, want)


def test_dataset_batches_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    letters = ["|", "A", "B", "C", "D"]
    (tmp_path / "dict.ltr.txt").write_text(
        "".join(f"{c} 1\n" for c in letters))
    with open(tmp_path / "train.tsv", "w") as tf, \
            open(tmp_path / "train.ltr", "w") as lf:
        tf.write(str(tmp_path) + "\n")
        for i in range(11):
            n = int(rng.integers(3000, 20000))
            wavfile.write(str(tmp_path / f"{i}.wav"), 16000,
                          (rng.normal(size=n) * 3000).astype(np.int16))
            tf.write(f"{i}.wav\t{n}\n")
            lf.write(" ".join(rng.choice(letters, size=int(rng.integers(
                1, 9)))) + " |\n")
    tsv, vocab_file = str(tmp_path / "train.tsv"), str(tmp_path /
                                                       "dict.ltr.txt")
    jvocab = {v: i for i, v in enumerate(jax_vocab(vocab_file))}
    vocab = {v: i for i, v in enumerate(read_vocab_list(vocab_file))}
    assert vocab == jvocab
    kw = dict(pad_to_multiple=4000, text_pad_multiple=8, seed=3,
              read_workers=1)
    theirs = iter(JaxDataset(tsv, JaxVectorizer(jvocab), 40000,
                             lane_align=False, **kw))
    ours = iter(AudioTextLetterDataset(tsv, TextVectorizer(vocab), 40000,
                                       **kw))
    for _ in range(9):  # past one epoch: the reshuffle must match too
        a, b = next(ours), next(theirs)
        assert a["files"] == b["files"] and a["num_real"] == b["num_real"]
        for k in ("signal", "signal_lengths", "token_ids", "token_lengths"):
            assert np.array_equal(a[k], b[k]), k
