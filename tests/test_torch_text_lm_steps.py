"""Training trajectories of the port's ``make_lm_steps`` against the JAX
package's on one init, on the CPU.

Ten steps of (4, 17) packed blocks (the last row with a PAD tail) from
JAX weights carried by ``params_from_jax``, AdamW with weight decay
0.01 and clipping at 1.0, as ``cli.train_lm`` steps:

* float32 at dropout 0, and at 0.1 with the jitted JAX step's dropout
  seeds recorded (``test_torch_dropout_trajectories.JaxSeeds``) and fed
  to the port through ``SeedReplay``, which must use them all: loss rtol
  1e-3, gradient norm rtol 5e-3, step 1's loss rtol 1e-4;
* bfloat16: ``test_torch_text_lm_bf16.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import TextLMConfig as JaxTextLMConfig
from audio8_tpu.models.text import CausalTextLM as JaxCausalTextLM
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.config import TextLMConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.text import CausalTextLM
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import make_lm_steps
from tests.test_torch_dropout_trajectories import JaxSeeds
from tests.test_torch_text_lm import default_offsets  # noqa: F401
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

CFG = dict(vocab_size=13, d_model=32, num_heads=2, num_layers=2, d_ff=64,
           rpr_k=4, block_len=16)
LR, STEPS = 1e-3, 10


def blocks(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, CFG["vocab_size"], size=(4, 17)).astype(np.int32)
    ids[0, 0] = 1  # the stream's GO
    ids[3, 11:] = 0  # the last partial block's PAD tail
    return ids


def trajectory(dropout, jdt, tdt, monkeypatch):
    cfg = dict(CFG, dropout=dropout)
    jmodel = JaxCausalTextLM(config=JaxTextLMConfig(**cfg), dtype=jdt)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))["params"])
    jtx = jax_opt(jax_lrs(LR, STEPS, warmup_steps=2), weight_decay=0.01)
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jstep, _ = jax_steps.make_lm_steps(jmodel, jtx, clip=1.0)
    model = CausalTextLM(TextLMConfig(**cfg), tdt)
    model.load_state_dict(params_from_jax(params), strict=True)
    state = TrainState(model, create_optimizer(
        create_lrs(LR, STEPS, warmup_steps=2), weight_decay=0.01))
    step, _ = make_lm_steps(model, clip=1.0)
    seeds = JaxSeeds(monkeypatch) if dropout else None
    out = {"j_loss": [], "j_gnorm": [], "loss": [], "gnorm": []}
    for i in range(STEPS):
        ids = blocks(i)
        jstate, jm = jstep(jstate, {"ids": jnp.asarray(ids)},
                           jax.random.fold_in(jax.random.PRNGKey(5), i))
        gen = seeds.take()[0] if seeds is not None else torch.Generator()
        state, m = step(state, {"ids": torch.from_numpy(ids)}, gen)
        if seeds is not None:
            assert gen.remaining == 0  # as many draws, in the same order
        out["j_loss"].append(float(jm["loss"]))
        out["j_gnorm"].append(float(jm["grad_norm"]))
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["grad_norm"]))
        assert float(m["tokens"]) == float(jm["tokens"])
    return out


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_f32_trajectory(dropout, monkeypatch):
    r = trajectory(dropout, jnp.float32, torch.float32, monkeypatch)
    np.testing.assert_allclose(r["loss"], r["j_loss"], rtol=1e-3)
    np.testing.assert_allclose(r["gnorm"], r["j_gnorm"], rtol=5e-3)
    np.testing.assert_allclose(r["loss"][0], r["j_loss"][0], rtol=1e-4)
    assert r["j_loss"][-1] < r["j_loss"][0]  # the steps trained

