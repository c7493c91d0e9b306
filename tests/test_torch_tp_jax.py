"""Tensor parallelism over the encoder topologies whose split differs
from the plain transformer's, held to JAX: two gloo ranks on the CPU (one
model group) take 2 unfrozen SGD CTC steps on a 4-row batch whose last
row is padding, every dropout at 0.1, with the seeds that the JAX
package's single-device jitted step drew (``JaxSeeds``, the attention
block's seed too), sequence parallelism off and on:

- the conformer, relative and rotary positions (its attention split, the
  position biases and ``linear_pos`` replicated and summed over the
  group);
- WavLM (its gate and bucket bias replicated and summed);
- the attention block, ``fused_attention="block"`` (the rank's partial O
  projection, its bias added once after the sum; JAX's block kernel in
  interpret mode).

Against JAX: loss rtol 1e-4, gradient norm 1e-3, every parameter within
1e-5 (``tests/test_torch_tp_steps.py``'s); the ranks' whole parameters
bitwise equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import AcousticConfig as JaxAcousticConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxCtcModel
from audio8_tpu.ops.pallas import attention_block_kernel as jax_block
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.models.convert import params_from_jax
from tests.test_torch_dp_ctc import _batch, check_params
from tests.test_torch_dropout_trajectories import CTC_CFG, JaxSeeds
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_tp_steps import fairseq_offsets
from tests.test_torch_tp_topologies import CONFORMER
from tests.torch_dp_ranks import LR
from tests.torch_tp_ranks import ctc_tp_steps, run_tp_ranks

cap_torch_threads()

STEPS = 2
LAYOUTS = {
    "conformer_rel": dict(CONFORMER, position_embeddings_type="relative"),
    "conformer_rope": dict(CONFORMER, position_embeddings_type="rotary"),
    "wavlm": dict(gated_rel_pos=True, rel_pos_buckets=32,
                  rel_pos_max_distance=64),
    "block": dict(fused_attention="block"),
}
MODES = ("tp", "sp")


class JaxBlockSeeds(JaxSeeds):
    """:class:`JaxSeeds`, and the attention block kernel's seed."""

    def __init__(self, monkeypatch):
        super().__init__(monkeypatch)
        make = jax_block.attention_block_nheads

        def nheads(n):
            block = make(n)

            def run(*args):
                rate, seed = args[-2:]
                if rate > 0.0:
                    self._note("dropout", seed)
                return block(*args)

            return run

        monkeypatch.setattr(jax_block, "attention_block_nheads", nheads)


def jax_ctc(cfg, batch, monkeypatch):
    """The JAX model's init, then ``STEPS`` jitted unfrozen SGD CTC steps
    on one device (keys folded from 7), recording each step's dropout
    seeds. Returns the init, the losses, gradient norms, the parameters
    after (the port's names) and the seed lists."""
    jmodel = JaxCtcModel(config=JaxAcousticConfig(**cfg))
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["signal"]),
        jnp.asarray(batch["signal_lengths"]))["params"])
    jtx = jax_opt(jax_lrs(LR, 10, sched_type="constant", warmup_steps=0),
                  "sgd")
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrad, jupdate, _ = jax_steps.make_ctc_steps(jmodel, jtx, clip=25.0)
    seeds = JaxBlockSeeds(monkeypatch)
    losses, gnorms, seed_lists = [], [], []
    for step in range(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(7), step)
        jl, jg, jrows, _ = jgrad(jstate.params, jb, key, freeze=False)
        replay, _ = seeds.take()
        seed_lists.append(list(replay._seeds))
        jstate, jn = jupdate(jstate, jg, jrows)
        losses.append(float(jl))
        gnorms.append(float(jn))
    return (params_from_jax(params), losses, gnorms,
            params_from_jax(jax.tree.map(np.asarray, jstate.params)),
            seed_lists)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with fairseq_offsets():
        batch = _batch()
        jax_runs = {}
        for name, layout in LAYOUTS.items():
            with pytest.MonkeyPatch.context() as mp:
                jax_runs[name] = jax_ctc(dict(CTC_CFG, **layout), batch, mp)
        jobs = [(ctc_tp_steps, (dict(CTC_CFG, **layout,
                                     sequence_parallel=mode == "sp"),
                                jax_runs[name][0], batch, jax_runs[name][4]))
                for name, layout in LAYOUTS.items() for mode in MODES]
        ranks = run_tp_ranks(jobs, 2, 2, tmp_path_factory.mktemp("tp_jax"))
        names = [(name, mode) for name in LAYOUTS for mode in MODES]
        return jax_runs, {key: [r[i] for r in ranks]
                          for i, key in enumerate(names)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_at_tp2_matches_jax(runs, name, mode):
    jax_runs, tp = runs
    _, j_loss, j_gnorm, j_params, _ = jax_runs[name]
    ranks = tp[name, mode]
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
    split = [k for k, v in ranks[0]["own"].items()
             if v.shape != ranks[0]["params"][k].shape]
    assert split
    np.testing.assert_allclose(ranks[0]["loss"], j_loss, rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["gnorm"], j_gnorm, rtol=1e-3)
    check_params(ranks[0]["params"], j_params, 1e-5)
