"""RNN-T training steps of the port against the JAX package's on the
CPU with dropout (the helpers of ``test_torch_transducer_steps.py``):
every dropout at 0.1 (the encoder's, attention probabilities and the
predictor's three, on the dropout kernel's plain version): the seeds the
jitted JAX step draws, recorded in program order
(``test_torch_dropout_trajectories.py:JaxSeeds``), replayed into the
port, which must draw exactly as many; the masks are bitwise the same,
so the trajectory holds the dropout-off bounds (step-1 loss rtol 1e-4,
loss 1e-3, gradient norm 5e-3), frozen and unfrozen.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_dropout_trajectories import JaxSeeds
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_transducer_steps import (CFG, _fairseq_offsets, both,
                                               init_params, make_batch)

cap_torch_threads()
__all__ = ["_fairseq_offsets"]  # the fixture this file uses

DROPOUT = dict(dropout=0.1, attention_dropout=0.1, dropout_input=0.1,
               dropout_features=0.1, pred_dropout=0.1)


def test_trajectory_with_dropout(monkeypatch):
    cfg = dict(CFG, **DROPOUT)
    p = init_params(cfg)
    (jstate, (jgrad, jupdate, _, _)), (state, (grad_fn, update_fn, _, _)) \
        = both(p, cfg)
    batch = make_batch(2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    seeds = JaxSeeds(monkeypatch)
    out = {"j_loss": [], "j_gnorm": [], "loss": [], "gnorm": []}
    for step in range(4):
        freeze = step < 1
        key = jax.random.fold_in(jax.random.PRNGKey(7), step)
        jl, jg, jn_rows, _ = jgrad(jstate.params, jb, key, freeze=freeze)
        replay, _ = seeds.take()
        jstate, jn = jupdate(jstate, jg, jn_rows)
        pl, pg, rows, _ = grad_fn(tb, replay, freeze=freeze)
        assert replay.remaining == 0  # as many draws, in the same order
        state, pn = update_fn(state, pg, rows)
        for k, v in (("j_loss", jl), ("j_gnorm", jn), ("loss", pl),
                     ("gnorm", pn)):
            out[k].append(float(v))
    np.testing.assert_allclose(out["loss"][0], out["j_loss"][0], rtol=1e-4)
    np.testing.assert_allclose(out["loss"], out["j_loss"], rtol=1e-3)
    np.testing.assert_allclose(out["gnorm"], out["j_gnorm"], rtol=5e-3)
