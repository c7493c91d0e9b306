"""data2vec-audio masked regression in the port against the JAX package on
the CPU.

* ``data2vec_targets`` (each of the top k hiddens instance-normalised over
  all T' frames, averaged) and ``data2vec_loss`` with its metrics within
  1e-6 of JAX's, with and without a pad mask.
* ``ema_decay_schedule`` and ``ema_update`` bitwise equal to JAX's as its
  jitted step computes them (XLA fuses their multiply-adds).
* The encoder's ``return_hiddens``: each layer's output before the
  pre-norm ``layer_norm``, and under LayerDrop a dropped layer's input,
  against the JAX teacher's hiddens on carried weights with the jitted
  JAX forward's dropout seeds and keep decisions replayed
  (``tests/test_torch_layer_drop.py:JaxKeeps``); the conformer refuses.
* A 10-step ``make_data2vec_steps`` trajectory of the data2vec-base
  layout (layer-norm extractor, five stacked positional convs) against the
  jitted JAX step with the recorded seeds, every dropout at 0.1: loss rtol
  1e-3, gradient norm rtol 5e-3, step 1's loss rtol 1e-4, and the EMA
  teacher's parameters at the end within 1e-5 of JAX's.
* Under a conformer preset the model builds a transformer stack, as the
  JAX model does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import Data2VecPretrainConfig as JaxConfig
from audio8_tpu.models.data2vec import Data2VecAudioModel as JaxModel
from audio8_tpu.models import data2vec as jd2v
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.config import Data2VecPretrainConfig
from audio8_tpu_torch.models import data2vec as d2v
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.data2vec import Data2VecAudioModel
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import make_data2vec_steps
from tests.test_torch_dropout_trajectories import JaxSeeds, _check
from tests.test_torch_layer_drop import JaxKeeps
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

FX = ((32, 10, 5), (32, 3, 2))
LR = 2e-4
CFG = dict(d_model=64, num_heads=4, num_layers=2, d_ff=128,
           custom_conv_features=FX, dropout=0.1, attention_dropout=0.1,
           average_top_k_layers=2, ema_decay=0.9, ema_end_decay=0.99,
           ema_anneal_steps=10)
# the data2vec-base preset's layout
D2V_BASE = dict(extractor_mode="layer", pos_conv_depth=5, conv_pos_kernel=19)


def d2v_signal(seed: int, rows: int = 2, samples: int = 2400) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(rows, samples)) \
        .astype(np.float32)


def jax_init(cfg, dtype=jnp.float32):
    model = JaxModel(config=JaxConfig(**cfg), dtype=dtype)
    params = jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.asarray(d2v_signal(0)))
    return model, jax.tree.map(np.asarray, params["params"])


def port_model(cfg, params, dtype=torch.float32) -> Data2VecAudioModel:
    model = Data2VecAudioModel(Data2VecPretrainConfig(**cfg), dtype)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def run_d2v_trajectory(monkeypatch, cfg, steps: int = 10,
                       dtype=torch.float32):
    """``steps`` steps of both packages' ``make_data2vec_steps`` from one
    JAX init (the teacher a copy of it) on one dense batch; returns the
    four curves, the port's teacher and the JAX teacher as port state."""
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jmodel, params = jax_init(cfg, jdtype)
    signal = d2v_signal(1)
    jtx = jax_opt(jax_lrs(LR, steps, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jteacher = jax.tree.map(jnp.asarray, params)
    jstep, _ = jax_steps.make_data2vec_steps(jmodel, jtx, clip=1.0)
    model, teacher = (port_model(cfg, params, dtype) for _ in range(2))
    state = TrainState(model, create_optimizer(
        create_lrs(LR, steps, sched_type="constant", warmup_steps=0)))
    step, _ = make_data2vec_steps(model, teacher, clip=1.0)
    seeds = JaxSeeds(monkeypatch)
    jb = {"signal": jnp.asarray(signal), "signal_lengths": None}
    tb = {"signal": torch.from_numpy(signal), "signal_lengths": None}
    curves = ([], [], [], [])
    for i in range(steps):
        jstate, jteacher, jm = jstep(jstate, jteacher, jb, jax.random.fold_in(
            jax.random.PRNGKey(7), i))
        replay, (mask,) = seeds.take()
        state, m = step(state, tb, mask, replay)
        assert replay.remaining == 0
        assert m["ema_decay"] == float(jm["ema_decay"])
        for curve, v in zip(curves, (m["loss"], m["grad_norm"], jm["loss"],
                                     jm["grad_norm"])):
            curve.append(float(v))
    return curves, teacher, params_from_jax(jax.tree.map(np.asarray,
                                                         jteacher))


# -------------------------------------------------------- targets and loss


def test_targets_match_jax():
    rng = np.random.default_rng(0)
    hiddens = [rng.normal(size=(2, 37, 16)).astype(np.float32) * (i + 1)
               for i in range(4)]
    for k in (1, 3):
        want = np.asarray(jd2v.data2vec_targets(
            [jnp.asarray(h) for h in hiddens], k))
        got = d2v.data2vec_targets([torch.from_numpy(h) for h in hiddens],
                                   k).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pad", [False, True])
def test_loss_and_metrics_match_jax(pad):
    rng = np.random.default_rng(1)
    pred = rng.normal(size=(3, 29, 16)).astype(np.float32)
    target = rng.normal(size=(3, 29, 16)).astype(np.float32)
    tm = rng.random((3, 29)) < 0.6
    pm = (np.arange(29)[None, :] < np.array([29, 17, 0])[:, None]) \
        if pad else None
    want, wm = jd2v.data2vec_loss(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(tm),
        None if pm is None else jnp.asarray(pm))
    got, gm = d2v.data2vec_loss(
        torch.from_numpy(pred), torch.from_numpy(target),
        torch.from_numpy(tm), None if pm is None else torch.from_numpy(pm))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k in ("target_std", "pred_std", "n_masked"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)


@pytest.mark.parametrize("start,end,anneal", [
    (0.999, 0.9999, 30_000), (0.9, 0.99, 10), (0.9, 0.99, 7),
    (0.5, 0.75, 0)])
def test_ema_schedule_bitwise(start, end, anneal):
    """Against the schedule as the jitted JAX step computes it."""
    sched = jax.jit(lambda s: jd2v.ema_decay_schedule(s, start, end,
                                                      anneal))
    for step in list(range(12)) + [15_000, 29_999, 30_000, 40_000]:
        want = np.float32(sched(jnp.asarray(step)))
        assert np.float32(d2v.ema_decay_schedule(
            step, start, end, anneal)) == want, step


def test_ema_update_bitwise():
    """Against the update as the jitted JAX step computes it."""
    rng = np.random.default_rng(2)
    t = [rng.normal(size=s).astype(np.float32) for s in ((70, 50), (1100,))]
    s = [rng.normal(size=a.shape).astype(np.float32) for a in t]
    update = jax.jit(jd2v.ema_update)
    for decay in (0.999, 0.9, 0.981, float(np.float32(0.99945))):
        want = update([jnp.asarray(a) for a in t],
                      [jnp.asarray(a) for a in s], jnp.float32(decay))
        got = [torch.from_numpy(a.copy()) for a in t]
        d2v.ema_update(got, [torch.from_numpy(a) for a in s], decay)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------- hiddens


@pytest.mark.parametrize("pre_norm,layer_drop", [(False, 0.0), (True, 0.0),
                                                 (True, 0.5)])
def test_return_hiddens_match_jax(monkeypatch, pre_norm, layer_drop):
    cfg = dict(CFG, pre_norm=pre_norm, layer_drop=layer_drop)
    jmodel, params = jax_init(cfg)
    model = port_model(cfg, params)
    x = d2v_signal(3)
    lens = np.array([2400, 1500], np.int32)
    train = layer_drop > 0.0
    run = jax.jit(lambda p, a, n, r: jmodel.apply(
        {"params": p}, a, n, train=train, mask=False, collect_hiddens=True,
        rngs={"dropout": r}))
    keeps = JaxKeeps(monkeypatch) if train else None
    for i in range(20):  # a draw that drops one layer and keeps the other
        want, _, _ = run(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                         jnp.asarray(lens), jax.random.PRNGKey(i))
        replay = keeps.take()[0] if train else None
        if not train or sorted(replay._keeps) == [False, True]:
            break
    if train:
        assert replay._keeps in ([True, False], [False, True])
        dropped = replay._keeps.index(False)
    with torch.no_grad():
        got, tm, pm = model(torch.from_numpy(x), torch.from_numpy(lens),
                            generator=replay, collect_hiddens=True)
    assert not tm.any() and len(got) == len(want) == cfg["num_layers"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)
    if train:
        assert replay.remaining == 0
        before = got[dropped - 1] if dropped else None
        if before is not None:
            assert torch.equal(got[dropped], before)


def test_conformer_refuses_hiddens_and_data2vec_builds_a_transformer():
    from audio8_tpu_torch.config import EncoderConfig
    from audio8_tpu_torch.models.wav2vec2 import AudioTransformerEncoder

    conf = dict(d_model=32, num_heads=2, num_layers=1, d_ff=64,
                encoder_type="conformer")
    enc = AudioTransformerEncoder(EncoderConfig(**conf))
    with pytest.raises(ValueError, match="transformer stack only"):
        enc(torch.zeros(1, 5, 32), return_hiddens=True)
    model = Data2VecAudioModel(Data2VecPretrainConfig(
        **conf, custom_conv_features=FX))
    assert model.encoder.config.encoder_type == "transformer"
    assert hasattr(model.encoder, "pos_conv")


# ------------------------------------------------------------ trajectory


def test_trajectory_and_teacher_match_jax(monkeypatch):
    (loss, gnorm, j_loss, j_gnorm), teacher, j_teacher = run_d2v_trajectory(
        monkeypatch, dict(CFG, **D2V_BASE))
    _check(loss, gnorm, j_loss, j_gnorm)
    for k, v in teacher.state_dict().items():
        np.testing.assert_allclose(v.numpy(), j_teacher[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
