"""Mixture-of-Experts weights across the two packages and the port's own
files, on the CPU (d 64, f 128, 4 layers, E 4, top-2).

* The converters' key table equals the model's own keys for experts in
  every layer, every second and every third, and ``jax_topology`` reads
  the experts and their spacing off a JAX tree.
* ``params_from_jax`` of a MoE tree after two JAX AdamW steps, with its
  moments and count: two more steps on both sides agree (loss rtol
  1e-4, gradient norm rtol 1e-3).
* The port's ``.pt`` and resume file carry every expert leaf and its
  moments; the JAX fairseq reader lists the experts as unexpected and
  the FFNs they replace as missing (a documented deviation: no fairseq
  layout holds experts, and neither package extends it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import AcousticConfig as JaxConfig
from audio8_tpu.models.convert import convert_ctc_state as jax_convert_ctc
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxModel
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.config import AcousticConfig
from audio8_tpu_torch.models.convert import (encoder_table, jax_topology,
                                             load_fairseq_ctc,
                                             params_from_jax)
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.train.checkpoint import load_resume, save_checkpoint
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import make_ctc_steps
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_moe_model import (EVAL, FX, MOE, SIZE, V,
                                        _batch, _fairseq_offsets,  # noqa
                                        jax_init)
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("every", [1, 2, 3])
def test_key_table_and_topology(every):
    cfg = AcousticConfig(**SIZE, **EVAL, **MOE, moe_every=every)
    model = Wav2Vec2AcousticModel(cfg)
    body = {k[len("encoder."):] for k in model.state_dict()
            if k.startswith("encoder.")}
    table = {k for k, _, _ in encoder_table(dataclasses.asdict(cfg),
                                            len(FX), cfg.num_layers)}
    assert body == table
    moe_layers = [i for i in range(4) if i % every == every - 1]
    assert {k.split(".")[2] for k in body if ".moe." in k} \
        == {str(i) for i in moe_layers}
    x, lengths = _batch()
    jmodel = JaxModel(config=JaxConfig(**SIZE, **EVAL, **MOE,
                                       moe_every=every))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x,
                            lengths)["params"]
    topo = jax_topology(shapes["encoder"])
    assert topo["moe_experts"] == 4 and topo["moe_every"] == every


def _ctc_batch(seed):
    rng = np.random.default_rng(seed)
    x, lengths = _batch(seed)
    tokens = rng.integers(4, V, size=(3, 6)).astype(np.int32)
    tok_len = np.array([6, 4, 0], np.int32)
    tokens[np.arange(6)[None, :] >= tok_len[:, None]] = Offsets.PAD
    return {"signal": x, "signal_lengths": lengths, "token_ids": tokens,
            "token_lengths": tok_len}


def test_jax_state_with_adamw_moments_carries_across(tmp_path):
    """Two JAX steps, then the tree and its AdamW state into the port;
    two more steps on both sides agree, and the port's ``.pt`` and
    resume file restore every expert leaf and its moments."""
    cfg = dict(SIZE, **EVAL, **MOE, moe_top_k=2, freeze_fx=False)
    params = jax_init(cfg)
    jmodel = JaxModel(config=JaxConfig(**cfg))
    jtx = jax_opt(jax_lrs(2e-4, 10, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jgrad, jupdate, _ = jax_steps.make_ctc_steps(jmodel, jtx, clip=25.0)
    batch = _ctc_batch(2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    for _ in range(2):
        _, g, n, _ = jgrad(jstate.params, jb, key, freeze=False)
        jstate, _ = jupdate(jstate, g, n)
    state_dict, (count, mu, nu) = params_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.opt_state))
    wi = "encoder.encoder.layers.1.moe.wi"
    assert count == 2 and mu[wi].shape == (4, 64, 128)
    assert float(mu[wi].abs().sum()) > 0 and float(nu[wi].abs().sum()) > 0
    model = Wav2Vec2AcousticModel(AcousticConfig(**cfg))
    model.load_state_dict(state_dict, strict=True)
    state = TrainState(model, create_optimizer(
        create_lrs(2e-4, 10, sched_type="constant", warmup_steps=0)))
    state.load_opt_state(count, mu, nu)
    grad_fn, update_fn, _ = make_ctc_steps(model, clip=25.0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(2):
        jl, g, n, _ = jgrad(jstate.params, jb, key, freeze=False)
        jstate, jn = jupdate(jstate, g, n)
        pl, pg, pb, _ = grad_fn(tb, torch.Generator().manual_seed(0),
                                freeze=False)
        state, pn = update_fn(state, pg, pb)
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-4)
        np.testing.assert_allclose(float(pn), float(jn), rtol=1e-3)

    path = save_checkpoint(state, str(tmp_path / "checkpoint-step-4.pt"),
                           "ctc")
    fresh = Wav2Vec2AcousticModel(AcousticConfig(**cfg))
    fresh.load_state_dict(load_fairseq_ctc(path), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    again = TrainState(fresh, create_optimizer(
        create_lrs(2e-4, 10, sched_type="constant", warmup_steps=0)))
    assert load_resume(again, path, "ctc") == 4
    i = again.names.index(wi)
    assert torch.equal(again.opt_state.mu[i],
                       state.opt_state.mu[state.names.index(wi)])

    # the JAX fairseq reader: the experts are unexpected, the FFNs they
    # replace missing
    blob = torch.load(path, weights_only=True)["model"]
    _, report = jax_convert_ctc({k: v.numpy() for k, v in blob.items()},
                                num_layers=4, num_fx_layers=len(FX))
    assert sorted(report["unexpected"]) == sorted(
        f"w2v_encoder.w2v_model.encoder.layers.{i}.moe.{leaf}"
        for i in (1, 3) for leaf in ("router.weight", "wi", "bi", "wo",
                                     "bo"))
    assert sorted(report["missing"]) == sorted(
        f"w2v_encoder.w2v_model.encoder.layers.{i}.{fc}.{p}"
        for i in (1, 3) for fc in ("fc1", "fc2") for p in ("weight",
                                                           "bias"))
