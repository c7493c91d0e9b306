"""MoE CTC fine-tuning in the port against the JAX ``make_ctc_steps`` on
the CPU (d 64, f 128, 4 layers, E 4: layers 1 and 3 MoE, top-2,
``moe_aux_weight`` 0.5 so the aux moves the loss well past the bounds).

* One step from one init, frozen and unfrozen: the loss (rtol 1e-5) and
  every gradient (within 1e-4 of each leaf's largest; the key biases,
  whose true gradient is 0, are rounding noise on both sides); frozen, the
  encoder's gradient is the aux's alone, non-zero as in JAX (JAX freezes
  by ``stop_gradient`` on the encoder's output), and zero with the aux
  weight at 0.
* ``--remat``: three steps bitwise the plain run's (losses, grad norms,
  step 1's gradients, the generator's stream and the final weights),
  with and without LayerDrop; the aux is recorded once per layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import AcousticConfig as JaxConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxModel
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.config import AcousticConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.train.steps import make_ctc_steps
from tests.test_torch_dropout_trajectories import CTC_CFG, _ctc_batch
from tests.test_torch_dropout_trajectories import \
    _fairseq_offsets  # noqa: F401 - a fixture
from tests.test_torch_remat import _port_run
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

MOE = dict(moe_experts=4, moe_top_k=2, moe_aux_weight=0.5)
CFG = dict(CTC_CFG, num_layers=4, **MOE)
EVAL = dict(dropout=0.0, attention_dropout=0.0, dropout_input=0.0,
            dropout_features=0.0)


@pytest.fixture(scope="module")
def init():
    batch = _ctc_batch(1)
    jmodel = JaxModel(config=JaxConfig(**CFG))
    return jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["signal"]),
        jnp.asarray(batch["signal_lengths"]))["params"])


def _one_step(params, cfg, freeze):
    """Both packages' gradients of one step (no dropout), the port's by
    name, JAX's carried to the port's names."""
    batch = _ctc_batch(1)
    jmodel = JaxModel(config=JaxConfig(**cfg))
    jtx = jax_opt(jax_lrs(2e-4, 10, sched_type="constant", warmup_steps=0))
    jgrad, _, _ = jax_steps.make_ctc_steps(jmodel, jtx, clip=25.0)
    jl, jg, _, _ = jgrad(jax.tree.map(jnp.asarray, params),
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.PRNGKey(7), freeze=freeze)
    model = Wav2Vec2AcousticModel(AcousticConfig(**cfg))
    model.load_state_dict(params_from_jax(params), strict=True)
    grad_fn, _, _ = make_ctc_steps(model, clip=25.0)
    pl, pg, _, _ = grad_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                           torch.Generator(), freeze=freeze)
    return float(pl), pg, float(jl), params_from_jax(
        jax.tree.map(np.asarray, jg))


@pytest.mark.parametrize("freeze", [True, False])
def test_one_step_matches_jax(init, freeze):
    cfg = dict(CFG, **EVAL)
    pl, pg, jl, jg = _one_step(init, cfg, freeze)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for k, g in jg.items():
        if k.endswith("k_proj.bias"):
            continue  # its true gradient is 0 (a shift of a query's logits)
        scale = max(float(g.abs().max()), 1e-30)
        np.testing.assert_allclose(pg[k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
    router = "encoder.encoder.layers.1.moe.router.weight"
    attn = "encoder.encoder.layers.0.self_attn.q_proj.weight"
    assert float(pg[router].abs().sum()) > 0
    assert float(pg[attn].abs().sum()) > 0
    if freeze:
        # only the aux reaches the encoder: the last MoE layer's experts,
        # which no router reads, get nothing
        assert float(pg["encoder.encoder.layers.3.moe.wi"].abs().sum()) == 0
        assert float(jg["encoder.encoder.layers.3.moe.wi"].abs().sum()) == 0


def test_frozen_encoder_gets_nothing_without_the_aux(init):
    cfg = dict(CFG, **EVAL, moe_aux_weight=0.0)
    pl, pg, jl, jg = _one_step(init, cfg, True)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for k in pg:
        if k.startswith("encoder."):
            assert float(pg[k].abs().sum()) == 0, k
            assert float(jg[k].abs().sum()) == 0, k


@pytest.mark.parametrize("layer_drop", [0.0, 0.5])
def test_remat_is_bitwise_the_plain_run(_fairseq_offsets, layer_drop):
    cfg = dict(CFG, layer_drop=layer_drop)
    plain, remat = (_port_run(cfg, 3, r) for r in (False, True))
    assert remat["loss"] == plain["loss"]
    assert remat["gnorm"] == plain["gnorm"]
    for a, b in zip(remat["rng"], plain["rng"]):
        assert torch.equal(a, b)
    for k, g in plain["grads"].items():
        assert torch.equal(remat["grads"][k], g), k
    for k, w in plain["weights"].items():
        assert torch.equal(remat["weights"][k], w), k
    assert plain["grads"]["encoder.encoder.layers.3.moe.router.weight"] \
        .abs().sum() > 0
