"""RNN-T training steps of the port (``train/steps.py:
make_transducer_steps``) against the JAX package's on the CPU, as
``tests/test_train_dynamics.py`` glues JAX to a torch replica: the
10-step loss and gradient-norm trajectories from one init (3 frozen
steps, then unfrozen), each loss route, at loss rtol 1e-3, gradient norm
rtol 5e-3 and step-1 loss rtol 1e-4. The batch has 24 frames, a
ragged row and a padding row (``signal_lengths`` 0) and targets with
PAD tails. Dropout and masking are off here, so both runs are
deterministic; ``test_torch_transducer_dropout.py`` runs dropout and
``test_torch_transducer_steps_bf16.py`` bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import TransducerConfig as JaxConfig
from audio8_tpu.models.transducer import Transducer as JaxTransducer
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu.utils import Offsets as JaxOffsets
from audio8_tpu_torch.config import TransducerConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.transducer import Transducer
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.train.steps import make_transducer_steps
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

FX = ((32, 10, 5), (32, 3, 2))
V, LR, CLIP = 10, 3e-4, 25.0
CFG = dict(vocab_size=V, d_model=32, num_heads=2, num_layers=1, d_ff=64,
           pred_layers=1, pred_dim=24, pred_embed_dim=16, d_joint=20,
           custom_conv_features=FX, timestep_masking=0.0,
           channel_masking=0.0, dropout=0.0, pred_dropout=0.0,
           freeze_fx=False)
STEPS, FROZEN = 10, 3


@pytest.fixture(autouse=True)
def _fairseq_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    Offsets.remap_fairseq_ctc()
    JaxOffsets.remap_fairseq_ctc()
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


def make_batch(seed, t=256):
    rng = np.random.default_rng(seed)
    b, u = 3, 5
    lengths = np.array([t, t * 3 // 4, 0], np.int32)
    signal = rng.normal(size=(b, t)).astype(np.float32)
    signal[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    tokens = rng.integers(4, V, size=(b, u)).astype(np.int32)
    tok_len = np.array([u, u - 2, 0], np.int32)
    tokens[np.arange(u)[None, :] >= tok_len[:, None]] = Offsets.PAD
    return {"signal": signal, "signal_lengths": lengths,
            "token_ids": tokens, "token_lengths": tok_len}


def init_params(cfg=CFG):
    JaxOffsets.remap_fairseq_ctc()
    b = make_batch(0)
    model = JaxTransducer(config=JaxConfig(**cfg))
    p = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(b["signal"]),
                            jnp.asarray(b["signal_lengths"]),
                            jnp.asarray(b["token_ids"]))["params"]
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def params():
    return init_params()


def both(params, cfg=CFG, fused=False, bf16=False):
    """The two packages' steps and states from one init."""
    jdt, dt = ((jnp.bfloat16, torch.bfloat16) if bf16
               else (jnp.float32, torch.float32))
    jmodel = JaxTransducer(config=JaxConfig(**cfg), dtype=jdt)
    jtx = jax_opt(jax_lrs(LR, STEPS, sched_type="constant", warmup_steps=0))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jsteps = jax_steps.make_transducer_steps(jmodel, jtx, clip=CLIP,
                                             fused_loss=fused)
    model = Transducer(TransducerConfig(**cfg), dt)
    model.load_state_dict(params_from_jax(params), strict=True)
    state = TrainState(model, create_optimizer(
        create_lrs(LR, STEPS, sched_type="constant", warmup_steps=0)))
    return (jstate, jsteps), (state, make_transducer_steps(
        model, clip=CLIP, fused_loss=fused))


def trajectories(params, fused=False, bf16=False):
    (jstate, (jgrad, jupdate, _, _)), (state, (grad_fn, update_fn, _, _)) \
        = both(params, fused=fused, bf16=bf16)
    batch = make_batch(1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {"j_loss": [], "j_gnorm": [], "loss": [], "gnorm": []}
    for step in range(STEPS):
        freeze = step < FROZEN
        jl, jg, jn_rows, _ = jgrad(jstate.params, jb, jax.random.PRNGKey(0),
                                   freeze=freeze)
        jstate, jn = jupdate(jstate, jg, jn_rows)
        pl, pg, rows, _ = grad_fn(tb, None, freeze=freeze)
        state, pn = update_fn(state, pg, rows)
        out["j_loss"].append(float(jl))
        out["j_gnorm"].append(float(jn))
        out["loss"].append(float(pl))
        out["gnorm"].append(float(pn))
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_trajectory_frozen_then_unfrozen(params, fused):
    t = trajectories(params, fused)
    np.testing.assert_allclose(t["loss"], t["j_loss"], rtol=1e-3)
    np.testing.assert_allclose(t["gnorm"], t["j_gnorm"], rtol=5e-3)
    np.testing.assert_allclose(t["loss"][0], t["j_loss"][0], rtol=1e-4)
    assert t["loss"][-1] < t["loss"][0]

