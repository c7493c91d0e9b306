"""The MoE aux loss in the port's paired factory against the jitted JAX
``make_paired_steps`` on the CPU: ``tests/test_torch_paired.py``'s dual
encoder with the audio tower's one layer an MoE of E 4 (``moe_every``
1), ``moe_aux_weight`` 0.5 and every dropout at 0.1 (the JAX step's
seeds replayed), weight decay 0.01: two steps from one init with the
audio tower frozen (only the aux trains it, as JAX's ``stop_gradient``
on the tower's output leaves it). Loss (rtol 1e-4), gradient norm
(rtol 5e-3) and ``moe_aux`` (rtol 1e-5) agree at each step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import make_paired_steps
from tests import test_torch_paired as paired
from tests.test_torch_dropout_trajectories import JaxSeeds
from tests.test_torch_moe_ssl import MOE
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

LR, CLIP, WD = 5e-4, 25.0, 0.01


def test_steps_match_jax(monkeypatch):
    monkeypatch.setattr(paired, "AUDIO", dict(paired.AUDIO, moe_every=1,
                                              moe_top_k=2, **MOE))
    jm, jl, params, module = paired.models(0.1, jnp.float32, torch.float32,
                                           audio="sha_max", text="2ha_max")
    b = paired.batch(1)
    jtx = jax_opt(jax_lrs(LR, 2, sched_type="constant", warmup_steps=0),
                  weight_decay=WD)
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jgrad, jupdate, _ = jax_steps.make_paired_steps(jm, jl, jtx, clip=CLIP)
    state = TrainState(module, create_optimizer(
        create_lrs(LR, 2, sched_type="constant", warmup_steps=0),
        weight_decay=WD))
    grad_fn, update_fn, _ = make_paired_steps(module, clip=CLIP)
    seeds = JaxSeeds(monkeypatch)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    flags = dict(freeze_audio=True, freeze_text=False)
    for step in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(7), step)
        jloss, jmet, jg, jrows, _ = jgrad(jstate.params, jb, key, **flags)
        gen, _ = seeds.take()
        jstate, jn = jupdate(jstate, jg, jrows)
        loss, met, g, rows, _ = grad_fn(tb, gen, **flags)
        assert gen.remaining == 0
        state, n = update_fn(state, g, rows)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        np.testing.assert_allclose(float(n), float(jn), rtol=5e-3)
        np.testing.assert_allclose(float(met["moe_aux"]),
                                   float(jmet["moe_aux"]), rtol=1e-5)
        assert float(met["moe_aux"]) >= 1.0 - 1e-5
        router = "model.audio_encoder.encoder.encoder.layers.0.moe.router" \
            ".weight"
        assert float(g[router].abs().sum()) > 0
