"""Contrastive pretraining in the port against the JAX package on the CPU.

* Hash randomness: ``hash_randint``, ``compact_mask_indices`` and
  ``sample_negative_indices`` are bit-exact with the JAX package for the
  same integer seed; ``hash_gumbel`` agrees within 2 ulp in each of its
  two logs (the two libraries' ``log`` may round differently).
* The tiny ``Wav2Vec2Model`` (one k3s2 extractor layer) forward and loss
  match the JAX model from the same weights (``params_from_jax``) and the
  same seeds, which a recording wrapper around the JAX package's
  ``seed_from_key`` captures from an eager ``apply`` (the port takes them
  as arguments): index tensors equal, floats within atol 1e-4.
* A 5-step ``make_pretrain_steps`` trajectory is glued to the JAX one, as
  ``tests/test_train_dynamics.py:test_pretrain_dynamics_parity`` glues
  JAX to a torch replica: loss rtol 1e-3, grad norm rtol 5e-3, step-1 loss
  rtol 1e-4, with XLA attention (JAX) against the port's core, and with
  ``fused_attention="block"`` on both sides. Dropout is off, so both runs
  are deterministic.
* The dropout's plain backward (the function its kernel is held to)
  equals ``jax.vjp`` of ``_hash_dropout``.
* A checkpoint the port saves loads through the JAX
  ``convert_pretrained_state`` with nothing missing and gives the same
  evaluation outputs; the committed fairseq golden pretrained checkpoint
  loads into the port and gives the pinned hidden states.
* ``AudioFileDataset`` and ``BucketingAudioDataset`` yield the JAX
  package's batches for the same manifest and seed.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import audio8_tpu.ops.hashrand as jax_hashrand
from audio8_tpu.config import PretrainConfig as JaxConfig
from audio8_tpu.data.datasets import AudioFileDataset as JaxFileDataset
from audio8_tpu.data.datasets import BucketingAudioDataset as JaxBucketing
from audio8_tpu.models.convert import convert_pretrained_state
from audio8_tpu.models.wav2vec2 import Wav2Vec2Model as JaxModel
from audio8_tpu.models.wav2vec2 import \
    sample_negative_indices as jax_negatives
from audio8_tpu.models.wav2vec2 import wav2vec2_pretrain_loss as jax_loss
from audio8_tpu.nn.dropout import _hash_dropout
from audio8_tpu.ops.masks import compact_mask_indices as jax_compact
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.config import PretrainConfig
from audio8_tpu_torch.data.datasets import (AudioFileDataset,
                                            BucketingAudioDataset)
from audio8_tpu_torch.models.convert import (load_fairseq_pretrained,
                                             params_from_jax,
                                             save_fairseq_pretrained)
from audio8_tpu_torch.models.wav2vec2 import (PretrainSeeds, Wav2Vec2Model,
                                              sample_negative_indices,
                                              wav2vec2_pretrain_loss)
from audio8_tpu_torch.ops.dropout import fused_dropout
from audio8_tpu_torch.ops.hashrand import MASK32, hash_gumbel, hash_randint
from audio8_tpu_torch.ops.masks import compact_mask_indices
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import (current_temperature,
                                          make_pretrain_steps)
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "fairseq_golden")
FX = ((32, 10, 5), (32, 3, 2))
N_NEG, LR = 20, 2e-4
# the golden fixture's geometry: 2 groups of 8 codewords, final_dim 32
CFG = dict(d_model=64, num_heads=4, num_layers=2, d_ff=128,
           custom_conv_features=FX, num_vq_vars=8, num_vq_groups=2,
           final_dim=32, dropout=0.0, dropout_input=0.0,
           dropout_features=0.0, n_negatives=N_NEG)
N_VARS = 16


def _signal(seed):
    return np.random.default_rng(seed).normal(size=(2, 4000)) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def init_params():
    rngs = {k: jax.random.PRNGKey(i)
            for i, k in enumerate(("params", "mask", "gumbel", "dropout"))}
    params = JaxModel(config=JaxConfig(**CFG)).init(
        rngs, jnp.asarray(_signal(0)), train=True)["params"]
    return jax.tree.map(np.asarray, params)


def _port_model(params, **over) -> Wav2Vec2Model:
    model = Wav2Vec2Model(PretrainConfig(**CFG, **over))
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _record(params, signal, rng, train: bool, temperature: float = 2.0):
    """An eager JAX ``apply`` with the production step's rng folding;
    returns its outputs and the seeds it drew (time mask, then Gumbel in
    training) with the negatives' seed, as ``PretrainSeeds``."""
    real = jax_hashrand.seed_from_key
    seen = []

    def recording(key):
        seed = real(key)
        seen.append(int(seed) & MASK32)
        return seed

    jax_hashrand.seed_from_key = recording
    try:
        out = JaxModel(config=JaxConfig(**CFG)).apply(
            {"params": jax.tree.map(jnp.asarray, params)},
            jnp.asarray(signal), train=train, temperature=temperature,
            rngs={"dropout": jax.random.fold_in(rng, 0),
                  "mask": jax.random.fold_in(rng, 1),
                  "gumbel": jax.random.fold_in(rng, 2)})
    finally:
        jax_hashrand.seed_from_key = real
    assert len(seen) == (2 if train else 1)
    neg = int(real(jax.random.fold_in(rng, 3))) & MASK32
    return out, PretrainSeeds(mask=seen[0], gumbel=seen[-1] if train else 0,
                              negatives=neg)


def _assert_outputs_close(ours, theirs):
    c, t, ppl, valid = ours
    jc, jt, jppl, jvalid = (np.asarray(a) for a in theirs)
    assert np.array_equal(valid.numpy(), jvalid)
    np.testing.assert_allclose(c.detach().numpy(), jc, atol=1e-4, rtol=0)
    np.testing.assert_allclose(t.detach().numpy(), jt, atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(ppl), float(jppl), atol=1e-4, rtol=0)


# ------------------------------------------------------------ randomness


@pytest.mark.parametrize("seed", [12345, -7, 2 ** 31 - 2])
def test_hash_randint_bit_exact_and_gumbel_within_2_ulp(seed):
    jseed = jnp.asarray(seed, jnp.int32)
    maxval = np.array([1, 2, 7, 1000, 2 ** 31 - 1], np.int32)[:, None]
    want = np.asarray(jax_hashrand.hash_randint((5, 33), jseed,
                                                jnp.asarray(maxval)))
    got = hash_randint((5, 33), seed & MASK32, torch.from_numpy(maxval))
    assert np.array_equal(got.numpy(), want)
    # each of the two logs within 2 ulp: the outer log turns an inner
    # difference d at L = -log(u) into d / L, so near u = 1/e (g near 0)
    # an inner ulp is many of the output's
    g_want = np.asarray(jax_hashrand.hash_gumbel((4, 257), jseed))
    g_got = hash_gumbel((4, 257), seed & MASK32).numpy()
    assert g_got.dtype == np.float32
    inner = np.asarray(-jnp.log(jax_hashrand.hash_uniform((4, 257), jseed)))
    bound = 2 * np.spacing(np.abs(g_want)) + 2 * np.spacing(inner) / inner
    assert np.all(np.abs(g_got - g_want) <= bound)


@pytest.mark.parametrize("p,capacity", [(0.3, 40), (0.65, 400), (0.0, 8),
                                        (1.0, 17)])
def test_compact_mask_indices_bit_exact(p, capacity):
    mask = np.random.default_rng(int(p * 100)).random((3, 123)) < p
    idx, valid = jax_compact(jnp.asarray(mask), capacity)
    got_idx, got_valid = compact_mask_indices(torch.from_numpy(mask),
                                              capacity)
    assert got_idx.shape == (3, min(capacity, 123))
    assert np.array_equal(got_idx.numpy(), np.asarray(idx))
    assert np.array_equal(got_valid.numpy(), np.asarray(valid))


@pytest.mark.parametrize("key", [0, 3, 77])
def test_sample_negative_indices_bit_exact(key):
    k = jax.random.PRNGKey(key)
    vc = np.array([0, 1, 2, 57, 260], np.int32)
    want = np.asarray(jax_negatives(k, 5, 260, N_NEG, jnp.asarray(vc)))
    seed = int(jax_hashrand.seed_from_key(k)) & MASK32
    got = sample_negative_indices(seed, 5, 260, N_NEG, torch.from_numpy(vc))
    assert np.array_equal(got.numpy(), want)


def test_temperature_anneal_matches_jax():
    for step in (0, 1, 7, 100_000, 10_000_000):
        want = float(jax_steps.current_temperature(jnp.asarray(step)))
        assert current_temperature(step) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("seed", [12345, -7])
def test_dropout_backward_matches_jax_vjp(seed):
    rng = np.random.default_rng(0)
    x, dy = (rng.normal(size=(3, 50, 17)).astype(np.float32)
             for _ in range(2))
    jseed = jnp.asarray(seed, jnp.int32)
    y, vjp = jax.vjp(lambda a: _hash_dropout(a, 0.1, jseed), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    out = fused_dropout(xt, 0.1, seed & MASK32)
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(dy))
    assert np.array_equal(out.detach().numpy(), np.asarray(y))
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------ model and steps


@pytest.mark.parametrize("train", [True, False])
def test_forward_and_loss_match_jax(init_params, train):
    signal = _signal(1)
    rng = jax.random.PRNGKey(5)
    theirs, seeds = _record(init_params, signal, rng, train, 1.7)
    j_loss, j_metrics = jax_loss(*theirs, jax.random.fold_in(rng, 3),
                                 N_VARS, N_NEG, neg_lookup="gather")
    model = _port_model(init_params)
    with torch.no_grad():
        ours = model(torch.from_numpy(signal), seeds,
                     generator=torch.Generator() if train else None,
                     temperature=1.7)
        loss, metrics = wav2vec2_pretrain_loss(*ours, seeds.negatives,
                                               N_VARS, N_NEG)
    _assert_outputs_close(ours, theirs)
    assert ours[0].shape == (2, 260, 32)  # 26 spans of 10 of 399 frames
    np.testing.assert_allclose(float(loss), float(j_loss), atol=1e-4, rtol=0)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), atol=1e-4,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("fused", [None, "block"])
def test_pretrain_trajectory_matches_jax(init_params, fused):
    n = 5
    signal = _signal(2)
    keys = list(jax.random.split(jax.random.PRNGKey(23), n))
    seeds = [_record(init_params, signal, k, True)[1] for k in keys]

    jtx = jax_opt(jax_lrs(LR, n, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, init_params), jtx)
    jstep, _ = jax_steps.make_pretrain_steps(
        JaxModel(config=JaxConfig(**CFG, fused_attention=fused)), jtx,
        clip=1.0, n_negatives=N_NEG)
    model = _port_model(init_params, fused_attention=fused)
    state = TrainState(model, create_optimizer(
        create_lrs(LR, n, sched_type="constant", warmup_steps=0)))
    step, _ = make_pretrain_steps(model, clip=1.0, n_negatives=N_NEG)
    x = torch.from_numpy(signal)
    j_loss, j_gnorm, loss, gnorm = [], [], [], []
    for k, s in zip(keys, seeds):
        jstate, jm = jstep(jstate, jnp.asarray(signal), k)
        state, m = step(state, x, s, torch.Generator())
        j_loss.append(float(jm["loss"]))
        j_gnorm.append(float(jm["grad_norm"]))
        loss.append(float(m["loss"]))
        gnorm.append(float(m["grad_norm"]))
    assert state.step == n
    np.testing.assert_allclose(loss, j_loss, rtol=1e-3)
    np.testing.assert_allclose(gnorm, j_gnorm, rtol=5e-3)
    np.testing.assert_allclose(loss[0], j_loss[0], rtol=1e-4)
    assert loss[-1] < loss[0]  # the steps train


# ------------------------------------------------------------ checkpoints


def test_saved_checkpoint_loads_through_jax_convert(tmp_path):
    model = Wav2Vec2Model(PretrainConfig(**CFG),
                          generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "checkpoint.pt")
    save_fairseq_pretrained(model, path)
    blob = torch.load(path, map_location="cpu", weights_only=True)["model"]
    state = {k: v.numpy() for k, v in blob.items()}
    assert state["quantizer.vars"].shape == (1, 16, 16)
    params, report = convert_pretrained_state(state, num_layers=2,
                                              num_fx_layers=len(FX))
    assert report["missing"] == [] and report["unexpected"] == []
    signal = _signal(4)
    theirs, seeds = _record(params, signal, jax.random.PRNGKey(9), False)
    with torch.no_grad():
        ours = model(torch.from_numpy(signal), seeds)
    _assert_outputs_close(ours, theirs)
    again = Wav2Vec2Model(PretrainConfig(**CFG))
    again.load_state_dict(load_fairseq_pretrained(path), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_golden_fairseq_pretrained_checkpoint():
    model = Wav2Vec2Model(PretrainConfig(**dict(CFG, d_ff=None)))  # 4 x 64
    model.load_state_dict(load_fairseq_pretrained(
        os.path.join(FIX, "pretrained_tiny.pt")), strict=True)
    expected = np.load(os.path.join(FIX, "expected.npz"))
    with torch.no_grad():
        features = model.layer_norm(model.feature_extractor(
            torch.from_numpy(expected["__input__"])))
        hidden = model.encoder(model.post_extract_proj(features))
    np.testing.assert_allclose(hidden.numpy(), expected["pretrained_hidden"],
                               atol=3e-4, rtol=0)


# ---------------------------------------------------------------- datasets


@pytest.fixture
def manifest(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "train.tsv"
    with open(path, "w") as tf:
        tf.write(str(tmp_path) + "\n")
        for i in range(13):
            n = int(rng.integers(3000, 20000))
            wavfile.write(str(tmp_path / f"{i}.wav"), 16000,
                          (rng.normal(size=n) * 3000).astype(np.int16))
            tf.write(f"{i}.wav\t{n}\n")
    return str(path)


@pytest.mark.parametrize("bucketing", [False, True])
def test_dataset_batches_match_jax(manifest, bucketing):
    kw = dict(seed=3, read_workers=1)
    if bucketing:
        buckets = [4000, 8000, 12000]
        theirs = iter(JaxBucketing(buckets, manifest, 16000, 30000, **kw))
        ours = iter(BucketingAudioDataset(buckets, manifest, 16000, 30000,
                                          **kw))
    else:
        grid = [5000, 8000, 11000, 14000]
        theirs = iter(JaxFileDataset(manifest, 16000, 30000,
                                     length_grid=grid, **kw))
        ours = iter(AudioFileDataset(manifest, 16000, 30000,
                                     length_grid=grid, **kw))
    shapes = set()
    for _ in range(10):  # past one epoch: the reshuffle must match too
        a, b = next(ours), next(theirs)
        assert a.dtype == np.float32 and np.array_equal(a, b)
        shapes.add(a.shape)
    assert len(shapes) > 1
