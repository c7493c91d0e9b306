"""The port's 2-rank ZeRO-1 and FSDP CTC steps against the JAX package's
``shard_state(..., zero1=True)`` and ``(..., fsdp=True)`` steps on the
8-device CPU mesh (``tests/test_zero1.py``'s model, weights and 8-row
batch, dropout and masks off; AdamW at 1e-3 with weight decay 0.01), the
weights shared through ``params_from_jax``. Two steps each, held at the
tolerances the data-parallel step is held to against JAX
(``tests/test_torch_dp_ctc.py``): loss rtol 1e-4, gradient norm rtol
5e-3. JAX's own test holds its sharded step to its replicated one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio8_tpu.parallel.sharding import (DP_ONLY_RULES, batch_sharding,
                                          make_mesh, shard_state)
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu.train.steps import make_ctc_steps as jax_ctc_steps
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads
from tests.test_zero1 import SMALL, _setup
from tests.torch_dp_ranks import kept_offsets, run_ranks, several
from tests.torch_zero_ranks import ctc_run

cap_torch_threads()

STEPS = 2
LR, WD = 1e-3, 0.01
CFG = dict(num_labels=12, dropout=0.0, timestep_masking=0.0,
           channel_masking=0.0, **SMALL)


def _jax_run(model, params, batch_np, zero1, fsdp):
    mesh = make_mesh(data=8, model=1)
    bs = batch_sharding(mesh)
    batch = {k: jax.device_put(v, bs) for k, v in batch_np.items()}
    tx = jax_opt(jax_lrs(LR, 100, sched_type="constant", warmup_steps=0),
                 weight_decay=WD)
    grad_fn, update_fn, _ = jax_ctc_steps(model, tx)
    state = shard_state(JaxState.create(
        jax.tree_util.tree_map(jnp.asarray, params), tx), mesh,
        DP_ONLY_RULES, zero1=zero1, fsdp=fsdp)
    losses, gnorms = [], []
    for _ in range(STEPS):
        loss, grads, bsz, _ = grad_fn(state.params, batch,
                                      jax.random.PRNGKey(0), freeze=False)
        state, gnorm = update_fn(state, grads, bsz)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
    return losses, gnorms


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    assert len(jax.devices()) == 8
    model, _, params, batch_np = _setup()
    params = jax.device_get(params)
    jax_runs = {m: _jax_run(model, params, batch_np, m == "zero1",
                            m == "fsdp") for m in ("zero1", "fsdp")}
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    kw = {"lr": LR, "weight_decay": WD}
    with kept_offsets():  # the ranks start from fairseq's ids, as JAX's
        Offsets.remap_fairseq_ctc()
        port = run_ranks(several, 2, tmp_path_factory.mktemp("zero_jax"),
                         [(ctc_run, (CFG, sd, batch_np, STEPS, m, 0, 1, kw))
                          for m in ("zero1", "fsdp")])
    return jax_runs, {m: port[0][i] for i, m in
                      enumerate(("zero1", "fsdp"))}


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_two_ranks_match_jax_sharded_step(runs, mode):
    jax_runs, port = runs
    j_loss, j_gnorm = jax_runs[mode]
    np.testing.assert_allclose(port[mode]["loss"], j_loss, rtol=1e-4)
    np.testing.assert_allclose(port[mode]["gnorm"], j_gnorm, rtol=5e-3)
    assert port[mode]["loss"][1] < port[mode]["loss"][0]
