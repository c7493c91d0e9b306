"""LayerDrop and the stable-layer-norm pretraining trajectory against
the JAX package, every dropout at 0.1 and the jitted JAX step's seeds
replayed into the port (``tests/test_torch_dropout_trajectories.py:
JaxSeeds``).

* LayerDrop 0.5 over ten unfrozen CTC steps of the LV-60 layout. The
  JAX stack draws one keep decision per layer (``jax.random.bernoulli``,
  recorded here in program order beside the seeds) and computes a
  dropped layer before it selects the layer's input; the port skips the
  layer but draws the seeds the layer would have drawn, so the replayed
  stream lines up and the port consumes exactly the decisions and seeds
  JAX made. The run must drop some layers and keep others.
* Five pretraining steps of ``Wav2Vec2Model`` with the LV-60 layout
  (``make_pretrain_steps``): the conv bias and the layer-mode norms
  train through the conv backward.

Bounds: loss rtol 1e-3, grad norm rtol 5e-3, step 1's loss rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import PretrainConfig as JaxPretrainConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2Model as JaxPretrainModel
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.config import PretrainConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds, Wav2Vec2Model
from audio8_tpu_torch.ops.hashrand import SeedReplay
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import make_pretrain_steps
from tests.test_torch_dropout_trajectories import (CTC_CFG, LR, N_NEG,
                                                   PRETRAIN_CFG, JaxSeeds,
                                                   _check)
from tests.test_torch_dropout_trajectories import \
    _fairseq_offsets  # noqa: F401 - a fixture
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_topology_trajectories import LV60, run_ctc_trajectory

cap_torch_threads()

KEEPS_SEEN = []


class JaxKeeps(JaxSeeds):
    """:class:`JaxSeeds` plus the LayerDrop keep decisions: each scalar
    ``jax.random.bernoulli`` the step draws takes a slot too. A traced-
    twice forward writes its decisions twice; the first
    ``CTC_CFG['num_layers']`` are the step's."""

    def __init__(self, monkeypatch):
        super().__init__(monkeypatch)
        bernoulli = jax.random.bernoulli

        def recorded(key, p=0.5, shape=None):
            keep = bernoulli(key, p, shape)
            if not shape:
                self._note("keep", keep)
            return keep

        monkeypatch.setattr(jax.random, "bernoulli", recorded)

    def take(self):
        jax.effects_barrier()
        keeps = [bool(v) for _, (stream, v) in sorted(self._slots.items())
                 if stream == "keep"][:CTC_CFG["num_layers"]]
        self._slots = {s: v for s, v in self._slots.items()
                       if v[0] != "keep"}
        replay, key_seeds = super().take()
        seeds = [replay.next_seed() for _ in range(replay.remaining)]
        KEEPS_SEEN.extend(keeps)
        return _CheckedReplay(seeds, keeps), key_seeds


class _CheckedReplay(SeedReplay):
    """A replay whose seeds must all be drawn (``remaining``) and whose
    keep decisions too."""

    @property
    def remaining(self) -> int:
        return super().remaining + self.keeps_left


def test_layer_drop_trajectory_matches_jax(_fairseq_offsets, monkeypatch):
    KEEPS_SEEN.clear()
    cfg = dict(CTC_CFG, layer_drop=0.5, **LV60)
    (loss, gnorm, j_loss, j_gnorm), _, _ = run_ctc_trajectory(
        monkeypatch, cfg, seeds_cls=JaxKeeps)
    assert len(KEEPS_SEEN) == 10 * CTC_CFG["num_layers"]
    assert any(KEEPS_SEEN) and not all(KEEPS_SEEN)
    _check(loss, gnorm, j_loss, j_gnorm)


def test_lv60_pretrain_trajectory_matches_jax(monkeypatch):
    n = 5
    cfg = dict(PRETRAIN_CFG, **LV60)
    signal = np.random.default_rng(2).normal(size=(2, 2400)).astype(
        np.float32)
    jmodel = JaxPretrainModel(config=JaxPretrainConfig(**cfg))
    rngs = {k: jax.random.PRNGKey(i)
            for i, k in enumerate(("params", "mask", "gumbel", "dropout"))}
    params = jax.tree.map(np.asarray, jax.jit(
        lambda r, x: jmodel.init(r, x, train=True))(
        rngs, jnp.asarray(signal))["params"])
    keys = list(jax.random.split(jax.random.PRNGKey(23), n))
    jtx = jax_opt(jax_lrs(LR, n, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jstep, _ = jax_steps.make_pretrain_steps(jmodel, jtx, clip=1.0,
                                             n_negatives=N_NEG)
    model = Wav2Vec2Model(PretrainConfig(**cfg))
    model.load_state_dict(params_from_jax(params), strict=True)
    state = TrainState(model, create_optimizer(
        create_lrs(LR, n, sched_type="constant", warmup_steps=0)))
    step, _ = make_pretrain_steps(model, clip=1.0, n_negatives=N_NEG)
    seeds = JaxSeeds(monkeypatch)
    x = torch.from_numpy(signal)
    j_loss, j_gnorm, loss, gnorm = [], [], [], []
    for k in keys:
        jstate, jm = jstep(jstate, jnp.asarray(signal), k)
        replay, (mask, gumbel, negatives) = seeds.take()
        state, m = step(state, x, PretrainSeeds(mask=mask, gumbel=gumbel,
                                                negatives=negatives), replay)
        assert replay.remaining == 0
        j_loss.append(float(jm["loss"]))
        j_gnorm.append(float(jm["grad_norm"]))
        loss.append(float(m["loss"]))
        gnorm.append(float(m["grad_norm"]))
    _check(loss, gnorm, j_loss, j_gnorm)
    bias = "feature_extractor.conv_layers.1.0.bias"
    assert not torch.equal(model.state_dict()[bias],
                           params_from_jax(params)[bias])


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_layer_drop_extremes_draw_as_jax(rate):
    """Rate 0 keeps every layer and draws no decision; rate 1 drops every
    layer but still draws each one's seeds (none here: dropout 0)."""
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel

    cfg = AcousticConfig(**dict(CTC_CFG, dropout=0.0, attention_dropout=0.0,
                                dropout_input=0.0, dropout_features=0.0),
                         layer_drop=rate)
    model = Wav2Vec2AcousticModel(cfg,
                                  generator=torch.Generator().manual_seed(0))
    keeps = [] if rate == 0.0 else [False] * cfg.num_layers
    replay = SeedReplay([], keeps)
    x = torch.randn(2, 2400, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        lp, _ = model(x, torch.tensor([2400, 1200]), generator=replay,
                      freeze=False)
    assert replay.keeps_left == 0 and torch.isfinite(lp).all()
