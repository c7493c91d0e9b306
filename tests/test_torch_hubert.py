"""HuBERT masked-prediction pretraining in the port against the JAX package
on the CPU.

* ``hubert_pretrain_loss`` and its metrics within 1e-6 of JAX's: -1
  padding, targets shorter and longer than T', a zero-length row, and a
  nonzero ``pred_unmasked_weight``.
* The tiny ``HubertPretrainModel`` forward on weights carried across
  (``params_from_jax``) and the seeds the JAX model drew (recorded as
  ``tests/test_torch_dropout_trajectories.py:JaxSeeds`` records them:
  hash dropout and ``seed_from_key``), in training (every dropout 0.1,
  the channel mask on) and in evaluation (the time mask still drawn):
  masks equal, logits within 1e-4.
* A 10-step ``make_hubert_steps`` trajectory against the jitted JAX
  ``make_hubert_steps`` with the recorded seeds: loss rtol 1e-3, gradient
  norm rtol 5e-3, step 1's loss rtol 1e-4; the batch has a short row and
  a padding row (``signal_lengths == 0``).
* A padding row leaves every gradient finite (as JAX's
  ``test_hubert_grads_finite_with_padding_row``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import HubertPretrainConfig as JaxConfig
from audio8_tpu.models.hubert import HubertPretrainModel as JaxModel
from audio8_tpu.models.hubert import hubert_pretrain_loss as jax_loss
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.config import HubertPretrainConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.hubert import (HubertPretrainModel,
                                            HubertSeeds,
                                            hubert_pretrain_loss)
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import make_hubert_steps
from tests.test_torch_dropout_trajectories import JaxSeeds, _check
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

FX = ((32, 10, 5), (32, 3, 2))
K, LR = 12, 2e-4
# every dropout at the recipe's 0.1 (dropout_input's HuBERT default)
CFG = dict(d_model=64, num_heads=4, num_layers=2, d_ff=128,
           custom_conv_features=FX, num_clusters=K, final_dim=16,
           dropout=0.1, attention_dropout=0.1)
SAMPLES = 2400  # T' = 239 on FX


def hubert_batch(seed: int, lengths=(SAMPLES, 1700, 0), u: int = 245):
    """A supervised batch of cluster ids: rows of ``lengths`` samples (0:
    a padding row), U = ``u`` ids per row, -1 past each row's count."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    signal = rng.normal(size=(b, SAMPLES)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    signal[np.arange(SAMPLES)[None, :] >= lens[:, None]] = 0.0
    counts = np.asarray([min(u, (n - 10) // 10) if n else 0
                         for n in lengths], np.int32)
    ids = rng.integers(0, K, size=(b, u)).astype(np.int32)
    ids[np.arange(u)[None, :] >= counts[:, None]] = -1
    return {"signal": signal, "signal_lengths": lens, "token_ids": ids,
            "token_lengths": counts}


def jax_init(cfg, dtype=jnp.float32):
    model = JaxModel(config=JaxConfig(**cfg), dtype=dtype)
    batch = hubert_batch(0)
    params = jax.jit(lambda r, x, n: model.init(r, x, n))(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.asarray(batch["signal"]), jnp.asarray(batch["signal_lengths"]))
    return model, jax.tree.map(np.asarray, params["params"])


def port_model(cfg, params, dtype=torch.float32) -> HubertPretrainModel:
    model = HubertPretrainModel(HubertPretrainConfig(**cfg), dtype)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def run_hubert_trajectory(monkeypatch, cfg, steps: int = 10,
                          dtype=torch.float32):
    """``steps`` steps of both packages' ``make_hubert_steps`` from one JAX
    init on one batch, the port replaying the jitted JAX step's seeds;
    returns (port loss, port gnorm, JAX loss, JAX gnorm) and the last
    metrics of each."""
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jmodel, params = jax_init(cfg, jdtype)
    batch = hubert_batch(1)
    jtx = jax_opt(jax_lrs(LR, steps, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jstep, _ = jax_steps.make_hubert_steps(jmodel, jtx, clip=1.0)
    model = port_model(cfg, params, dtype)
    state = TrainState(model, create_optimizer(
        create_lrs(LR, steps, sched_type="constant", warmup_steps=0)))
    step, _ = make_hubert_steps(model, clip=1.0)
    seeds = JaxSeeds(monkeypatch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    curves = ([], [], [], [])
    for i in range(steps):
        jstate, jm = jstep(jstate, jb, jax.random.fold_in(
            jax.random.PRNGKey(7), i))
        replay, keys = seeds.take()
        # the "key" stream: the time mask, then the channel mask
        state, m = step(state, tb, HubertSeeds(*keys), replay)
        assert replay.remaining == 0  # as many draws, in the same order
        for curve, v in zip(curves, (m["loss"], m["grad_norm"], jm["loss"],
                                     jm["grad_norm"])):
            curve.append(float(v))
    return curves, m, jm


# ------------------------------------------------------------------ loss


def _loss_inputs(case):
    rng = np.random.default_rng(3)
    b, t = 3, 20
    logits = rng.normal(size=(b, t, K)).astype(np.float32) * 3
    time_mask = rng.random((b, t)) < 0.5
    pad = np.ones((b, t), bool)
    u = {"short": 14, "long": 27}.get(case, t)
    targets = rng.integers(0, K, size=(b, u)).astype(np.int32)
    lengths = np.full(b, u, np.int32)
    targets[1, u - 5:] = -1  # -1 padding
    lengths[1] = u - 5
    if case == "zero_row":
        pad[2] = False
        targets[2] = -1
        lengths[2] = 0
    return logits, time_mask, pad, targets, lengths


@pytest.mark.parametrize("case,unmasked_w", [
    ("pad", 0.0), ("short", 0.0), ("long", 0.0), ("zero_row", 0.0),
    ("pad", 0.5), ("zero_row", 0.3)])
def test_loss_and_metrics_match_jax(case, unmasked_w):
    logits, tm, pad, targets, lengths = _loss_inputs(case)
    want, wm = jax_loss(*(jnp.asarray(a) for a in (logits, tm, pad, targets,
                                                   lengths)),
                        1.0, unmasked_w)
    got, gm = hubert_pretrain_loss(*(torch.from_numpy(a) for a in (
        logits, tm, pad, targets, lengths)), 1.0, unmasked_w)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k in ("acc_masked", "n_masked"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)


def test_loss_with_nothing_masked_is_zero_not_nan():
    logits, tm, pad, targets, lengths = _loss_inputs("pad")
    got, gm = hubert_pretrain_loss(
        torch.from_numpy(logits), torch.zeros(tm.shape, dtype=torch.bool),
        torch.from_numpy(pad), torch.from_numpy(targets),
        torch.from_numpy(lengths))
    assert float(got) == 0.0 and float(gm["acc_masked"]) == 0.0


# --------------------------------------------------------------- forward


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax(monkeypatch, train):
    cfg = dict(CFG, channel_masking=0.2, channel_mask_len=8)
    jmodel, params = jax_init(cfg)
    batch = hubert_batch(2)
    rng = jax.random.PRNGKey(11)
    seeds = JaxSeeds(monkeypatch)
    rngs = {"mask": jax.random.fold_in(rng, 1)}
    if train:
        rngs["dropout"] = jax.random.fold_in(rng, 0)
    jl, jtm, jpm = jax.jit(lambda p, x, n, r: jmodel.apply(
        {"params": p}, x, n, train=train, rngs=r))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(batch["signal"]),
        jnp.asarray(batch["signal_lengths"]), rngs)
    jax.effects_barrier()
    keys = [s for _, (stream, s) in sorted(seeds._slots.items())
            if stream == "key"]
    replay = seeds.take()[0] if train else None
    assert len(keys) == (2 if train else 1)  # time (and channel) masks
    model = port_model(cfg, params)
    with torch.no_grad():
        lg, tm, pm = model(torch.from_numpy(batch["signal"]),
                           torch.from_numpy(batch["signal_lengths"]),
                           HubertSeeds(*keys), generator=replay)
    if train:
        assert replay.remaining == 0
    assert np.array_equal(tm.numpy(), np.asarray(jtm)) and tm.any()
    assert np.array_equal(pm.numpy(), np.asarray(jpm))
    assert lg.dtype == torch.float32
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)


# ------------------------------------------------------------ trajectory


def test_trajectory_matches_jax(monkeypatch):
    (loss, gnorm, j_loss, j_gnorm), m, jm = run_hubert_trajectory(
        monkeypatch, CFG)
    _check(loss, gnorm, j_loss, j_gnorm)
    assert loss[-1] < loss[0]
    np.testing.assert_allclose(float(m["n_masked"]), float(jm["n_masked"]))


def test_padding_row_leaves_gradients_finite():
    _, params = jax_init(CFG)
    model = port_model(CFG, params)
    batch = {k: torch.from_numpy(v) for k, v in hubert_batch(
        8, lengths=(SAMPLES, 0)).items()}
    logits, tm, pm = model(batch["signal"], batch["signal_lengths"],
                           HubertSeeds(5, 6),
                           generator=torch.Generator().manual_seed(3))
    assert not pm[1].any()
    loss, _ = hubert_pretrain_loss(logits, tm, pm, batch["token_ids"],
                                   batch["token_lengths"])
    loss.backward()
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
