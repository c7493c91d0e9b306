"""The MoE aux loss in the port's RNN-T factory against the jitted JAX
``make_transducer_steps`` on the CPU: ``tests/test_torch_transducer_
steps.py``'s model with its one encoder layer an MoE of E 4
(``moe_every`` 1, top-2, ``moe_aux_weight`` 0.5), two steps from one
init with the encoder frozen, in which only the aux trains it (as JAX's
``stop_gradient`` on the encoder's output leaves it): loss (step 1 rtol
1e-4, then 1e-3) and gradient norm (rtol 5e-3) at each step. The
unfrozen step is the CTC and seq2seq files'.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests import test_torch_transducer_steps as rnnt
from tests.test_torch_transducer_steps import \
    _fairseq_offsets  # noqa: F401 - a fixture
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

CFG = dict(rnnt.CFG, moe_experts=4, moe_every=1, moe_top_k=2,
           moe_aux_weight=0.5)


def test_frozen_steps_match_jax():
    params = rnnt.init_params(CFG)
    (jstate, (jgrad, jupdate, _, _)), (state, (grad_fn, update_fn, _, _)) \
        = rnnt.both(params, cfg=CFG)
    batch = rnnt.make_batch(1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, j_loss, gnorm, j_gnorm = [], [], [], []
    for _ in range(2):
        jl, jg, jrows, _ = jgrad(jstate.params, jb, jax.random.PRNGKey(0),
                                 freeze=True)
        jstate, jn = jupdate(jstate, jg, jrows)
        pl, pg, rows, _ = grad_fn(tb, None, freeze=True)
        assert float(pg["encoder.encoder.layers.0.moe.router.weight"]
                     .abs().sum()) > 0
        state, pn = update_fn(state, pg, rows)
        loss.append(float(pl))
        j_loss.append(float(jl))
        gnorm.append(float(pn))
        j_gnorm.append(float(jn))
    np.testing.assert_allclose(loss[0], j_loss[0], rtol=1e-4)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-3)
    np.testing.assert_allclose(gnorm, j_gnorm, rtol=5e-3)
