"""``--remat``: each encoder layer recomputed in the backward
(``nn/transformer.py:run_layers`` under ``torch.utils.checkpoint``) on
the dropout seeds it drew before it ran (``ops.hashrand.SeedReplay``),
on the CPU, every dropout at 0.1.

* Against the same model without remat, from one init and one generator
  seed: ten unfrozen CTC steps' losses and gradient norms, every
  gradient of step 1 and the weights after step 10, all bitwise, for
  the post-norm transformer and the conformer, with LayerDrop 0 and 0.5.
  The generator's state after each step equals the plain run's: the
  recompute draws nothing, and the forward draws what a plain forward
  draws.
* Against the JAX package's ``remat=True`` (``nn.remat`` of each layer)
  on the seeds the jitted JAX step drew, recorded and replayed
  (``tests/test_torch_dropout_trajectories.py:JaxSeeds``): step 1's loss
  within 1e-4 relative and every gradient within 1e-3 of JAX's, relative
  to the leaf's largest entry (at least 1e-3 of the model's largest: a
  key bias's gradient is zero but for rounding); then three more steps'
  losses within 1e-3.
* Without a generator (evaluation) remat changes nothing.
"""
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
from audio8_tpu_torch.config import AcousticConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import make_ctc_steps
from tests.test_torch_dropout_trajectories import (CTC_CFG, LR, JaxSeeds,
                                                   _ctc_batch)
from tests.test_torch_dropout_trajectories import \
    _fairseq_offsets  # noqa: F401 - a fixture
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_topology_trajectories import TOPOLOGIES

cap_torch_threads()

STACKS = {"transformer": {}, "conformer": TOPOLOGIES["conformer_relative"]}


def _port_run(cfg, steps, remat):
    """``steps`` unfrozen CTC steps from one seeded init and generator:
    the losses, grad norms, step 1's gradients, the generator's state
    after each step and the final weights."""
    model = Wav2Vec2AcousticModel(AcousticConfig(**cfg, remat=remat),
                                  generator=torch.Generator().manual_seed(0))
    state = TrainState(model, create_optimizer(
        create_lrs(LR, steps, sched_type="constant", warmup_steps=0)))
    grad_fn, update_fn, _ = make_ctc_steps(model, clip=25.0)
    batch = {k: torch.from_numpy(v) for k, v in _ctc_batch(1).items()}
    generator = torch.Generator().manual_seed(5)
    out = {"loss": [], "gnorm": [], "rng": []}
    for step in range(steps):
        loss, grads, rows, _ = grad_fn(batch, generator, freeze=False)
        if step == 0:
            out["grads"] = {k: v.clone() for k, v in grads.items()}
        state, gnorm = update_fn(state, grads, rows)
        out["loss"].append(loss.item())
        out["gnorm"].append(gnorm.item())
        out["rng"].append(generator.get_state())
    out["weights"] = model.state_dict()
    return out


@pytest.mark.parametrize("layer_drop", [0.0, 0.5])
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_remat_is_bitwise_the_plain_run(_fairseq_offsets, stack, layer_drop):
    cfg = dict(CTC_CFG, layer_drop=layer_drop, **STACKS[stack])
    plain, remat = (_port_run(cfg, 10, r) for r in (False, True))
    assert remat["loss"] == plain["loss"]
    assert remat["gnorm"] == plain["gnorm"]
    for a, b in zip(remat["rng"], plain["rng"]):
        assert torch.equal(a, b)  # the same stream, step by step
    for k, g in plain["grads"].items():
        assert torch.equal(remat["grads"][k], g), k
    for k, w in plain["weights"].items():
        assert torch.equal(remat["weights"][k], w), k
    layer = "encoder.encoder.layers.1.final_layer_norm.weight"
    assert plain["grads"][layer].abs().sum() > 0 or layer_drop > 0


def test_remat_recomputes_each_layer(_fairseq_offsets):
    """The backward runs every kept layer's forward again: twice the
    layer forwards of a plain step, and a recompute draws no seed."""
    calls = {}
    for remat in (False, True):
        model = Wav2Vec2AcousticModel(
            AcousticConfig(**CTC_CFG, remat=remat),
            generator=torch.Generator().manual_seed(0))
        n = [0]
        for layer in model.encoder.encoder.layers:
            layer.register_forward_pre_hook(
                lambda *_: n.__setitem__(0, n[0] + 1))
        batch = {k: torch.from_numpy(v) for k, v in _ctc_batch(1).items()}
        grad_fn, _, _ = make_ctc_steps(model)
        grad_fn(batch, torch.Generator().manual_seed(5), freeze=False)
        calls[remat] = n[0]
    assert calls == {False: CTC_CFG["num_layers"],
                     True: 2 * CTC_CFG["num_layers"]}


def test_eval_forward_ignores_remat(_fairseq_offsets):
    batch = _ctc_batch(1)
    outs = []
    for remat in (False, True):
        model = Wav2Vec2AcousticModel(
            AcousticConfig(**CTC_CFG, remat=remat),
            generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            lp, _ = model(torch.from_numpy(batch["signal"]),
                          torch.from_numpy(batch["signal_lengths"]))
        outs.append(lp)
    assert torch.equal(*outs)


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_remat_matches_jax_remat(_fairseq_offsets, monkeypatch, stack):
    cfg = dict(CTC_CFG, remat=True, **STACKS[stack])
    batch = _ctc_batch(1)
    jmodel = JaxCtcModel(config=JaxAcousticConfig(**cfg))
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["signal"]),
        jnp.asarray(batch["signal_lengths"]))["params"])
    steps = 4
    jtx = jax_opt(jax_lrs(LR, steps, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jgrad, jupdate, _ = jax_steps.make_ctc_steps(jmodel, jtx, clip=25.0)
    model = Wav2Vec2AcousticModel(AcousticConfig(**cfg))
    model.load_state_dict(params_from_jax(params), strict=True)
    state = TrainState(model, create_optimizer(
        create_lrs(LR, steps, sched_type="constant", warmup_steps=0)))
    grad_fn, update_fn, _ = make_ctc_steps(model, clip=25.0)
    seeds = JaxSeeds(monkeypatch)
    jb_ = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, j_losses = [], []
    for step in range(steps):
        key = jax.random.fold_in(jax.random.PRNGKey(7), step)
        jl, jg, jb, _ = jgrad(jstate.params, jb_, key, freeze=False)
        replay, _ = seeds.take()
        jstate, _ = jupdate(jstate, jg, jb)
        pl, pg, pb, _ = grad_fn(tb, replay, freeze=False)
        assert replay.remaining == 0  # as many draws, in the same order
        state, _ = update_fn(state, pg, pb)
        losses.append(float(pl))
        j_losses.append(float(jl))
        if step == 0:
            np.testing.assert_allclose(float(pl), float(jl), rtol=1e-4)
            want = params_from_jax(jax.tree.map(np.asarray, jg))
            top = max(float(w.abs().max()) for w in want.values())
            for k, g in pg.items():
                w = want[k].numpy()
                scale = max(float(np.abs(w).max()), 1e-3 * top)
                np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                           atol=1e-3 * scale, err_msg=k)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-3)
