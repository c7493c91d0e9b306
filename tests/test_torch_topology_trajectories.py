"""Training trajectories of the new encoder topologies against the JAX
package's ``make_ctc_steps`` with every dropout at 0.1, the seeds of
the jitted JAX step recorded and replayed into the port
(``tests/test_torch_dropout_trajectories.py:JaxSeeds``): ten unfrozen
CTC steps of the stable-layer-norm model with the layer-norm extractor
and conv bias (LV-60's layout), of WavLM's gated position bias (its
gates train) and of the conformer with relative positions. The port
must draw exactly the seeds JAX draws, in its order: the pre-norm
layer's, WavLM's composed attention's and the conformer block's six
dropouts each line up. Bounds: loss rtol 1e-3, grad norm rtol 5e-3,
step 1's loss rtol 1e-4.
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
                                                   _check, _ctc_batch)
from tests.test_torch_dropout_trajectories import \
    _fairseq_offsets  # noqa: F401 - a fixture
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

LV60 = dict(pre_norm=True, extractor_mode="layer", conv_bias=True)
TOPOLOGIES = {
    "lv60": LV60,
    "wavlm": dict(gated_rel_pos=True, rel_pos_buckets=32,
                  rel_pos_max_distance=64),
    "conformer_relative": dict(extractor_mode="layer", conv_bias=True,
                               encoder_type="conformer",
                               position_embeddings_type="relative",
                               conv_depthwise_kernel_size=7),
}


def run_ctc_trajectory(monkeypatch, cfg, steps=10, seeds_cls=JaxSeeds):
    """``steps`` unfrozen CTC steps of both packages from one JAX init
    with the recorded seeds; returns the four curves and the port's
    model."""
    batch = _ctc_batch(1)
    jmodel = JaxCtcModel(config=JaxAcousticConfig(**cfg))
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["signal"]),
        jnp.asarray(batch["signal_lengths"]))["params"])
    jtx = jax_opt(jax_lrs(LR, steps, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jgrad, jupdate, _ = jax_steps.make_ctc_steps(jmodel, jtx, clip=25.0)
    model = Wav2Vec2AcousticModel(AcousticConfig(**cfg))
    model.load_state_dict(params_from_jax(params), strict=True)
    state = TrainState(model, create_optimizer(
        create_lrs(LR, steps, sched_type="constant", warmup_steps=0)))
    grad_fn, update_fn, _ = make_ctc_steps(model, clip=25.0)
    seeds = seeds_cls(monkeypatch)
    jb_ = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    curves = ([], [], [], [])
    for step in range(steps):
        key = jax.random.fold_in(jax.random.PRNGKey(7), step)
        jl, jg, jb, _ = jgrad(jstate.params, jb_, key, freeze=False)
        replay, _ = seeds.take()
        jstate, jn = jupdate(jstate, jg, jb)
        pl, pg, pb, _ = grad_fn(tb, replay, freeze=False)
        assert replay.remaining == 0  # as many draws, in the same order
        state, pn = update_fn(state, pg, pb)
        for curve, v in zip(curves, (pl, pn, jl, jn)):
            curve.append(float(v))
    return curves, model, params


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_ctc_trajectory_matches_jax(_fairseq_offsets, monkeypatch, name):
    cfg = dict(CTC_CFG, **TOPOLOGIES[name])
    (loss, gnorm, j_loss, j_gnorm), model, params = run_ctc_trajectory(
        monkeypatch, cfg)
    _check(loss, gnorm, j_loss, j_gnorm)
    if name == "wavlm":  # the gates and the bucket table trained
        before = params_from_jax(params)
        after = model.state_dict()
        for k in ("encoder.encoder.layers.1.self_attn.gru_rel_pos_const",
                  "encoder.encoder.layers.0.self_attn.gru_rel_pos_linear"
                  ".weight",
                  "encoder.encoder.layers.0.self_attn.rel_attn_embed"
                  ".weight"):
            assert not torch.equal(before[k], after[k]), k
