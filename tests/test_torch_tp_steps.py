"""Tensor-parallel CTC steps at DP 2 x TP 2: four gloo ranks on the CPU
(two data ranks, each a model group of two) take 2 unfrozen SGD steps on
a 4-row global batch whose last row is padding, every dropout at 0.1
(the jitted JAX step's seeds, replayed), sequence parallelism off and on
(239 frames: a T the group does not divide), in float32 and bfloat16.

Against one process and the JAX single-device jitted step (float32):
loss rtol 1e-4, gradient norm 1e-3, parameters 1e-6 plus 1e-5 of their
size against the port's one process (the clip factor carries the
norm's relative rounding into every parameter) and 1e-5 absolute
against JAX (``tests/test_torch_dp_ctc.py``'s). The ranks hold bitwise
equal whole parameters, and SP on equals SP off within the same
tolerances (the scatter on T sums in another order).
In bfloat16 the reference is JAX's own tensor-parallel step on the
8-device CPU mesh (``make_mesh(data=4, model=2)``, ``TP_RULES``), which
rounds the row-split partial products before its psum, as the port does;
held at the bf16 trajectory bound (loss rtol 5e-3,
``tests/test_torch_bf16.py``). Both packages' special-token ids are
fairseq's for the runs (:func:`fairseq_offsets`), whatever earlier tests
left."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import AcousticConfig as JaxAcousticConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxCtcModel
from audio8_tpu.parallel.sharding import (TP_RULES, make_mesh, put_batch,
                                          shard_state)
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu.utils import Offsets as JaxOffsets
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_bf16 import BF16_LOSS_RTOL
from tests.test_torch_dp_ctc import _batch, check_params
from tests.test_torch_dropout_trajectories import (  # noqa: F401
    CTC_CFG, JaxSeeds, _fairseq_offsets)
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_tp_cli import PARAM_ATOL, PARAM_RTOL
from tests.torch_dp_ranks import LR, kept_offsets
from tests.torch_tp_ranks import ctc_tp_steps, run_tp_ranks

cap_torch_threads()

STEPS = 2
SP_CFG = dict(CTC_CFG, sequence_parallel=True)


@contextlib.contextmanager
def fairseq_offsets():
    """Both packages' special tokens remapped as fairseq's CTC dictionary
    has them, restored after: a test holding the port to JAX must not
    depend on what earlier tests of its process left in either registry
    (several remap JAX's without restoring it)."""
    saved = (JaxOffsets.PAD, JaxOffsets.GO, JaxOffsets.EOS, JaxOffsets.UNK,
             list(JaxOffsets.VALUES))
    with kept_offsets():
        Offsets.remap_fairseq_ctc()
        JaxOffsets.remap_fairseq_ctc()
        try:
            yield
        finally:
            (JaxOffsets.PAD, JaxOffsets.GO, JaxOffsets.EOS,
             JaxOffsets.UNK) = saved[:4]
            JaxOffsets.VALUES[:] = saved[4]


def jax_ctc(batch, params, dtype=jnp.float32, mesh=None, seeds=None):
    """The jitted JAX CTC step ``STEPS`` times (keys folded from 7), on
    one device or over ``mesh`` with ``TP_RULES``; with ``seeds`` (a
    ``JaxSeeds``) each step's dropout seeds are recorded. Returns the
    losses, gradient norms, the parameters after and the seed lists."""
    jmodel = JaxCtcModel(config=JaxAcousticConfig(**CTC_CFG), dtype=dtype)
    jtx = jax_opt(jax_lrs(LR, 10, sched_type="constant", warmup_steps=0),
                  "sgd")
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if mesh is not None:
        jstate = shard_state(jstate, mesh, TP_RULES)
        jb = put_batch(batch, mesh)
    jgrad, jupdate, _ = jax_steps.make_ctc_steps(jmodel, jtx, clip=25.0,
                                                 mesh=mesh)
    losses, gnorms, seed_lists = [], [], []
    for step in range(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(7), step)
        jl, jg, jrows, _ = jgrad(jstate.params, jb, key, freeze=False)
        if seeds is not None:
            replay, _ = seeds.take()
            seed_lists.append(list(replay._seeds))
        jstate, jn = jupdate(jstate, jg, jrows)
        losses.append(float(jl))
        gnorms.append(float(jn))
    return (losses, gnorms,
            params_from_jax(jax.tree.map(np.asarray, jstate.params)),
            seed_lists)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs (one device in f32, recording the seeds; the 8-device
    TP mesh in bf16), the port's one process in f32, then the three
    DP 2 x TP 2 runs on one spawn of four ranks."""
    with fairseq_offsets():
        batch = _batch()
        jmodel = JaxCtcModel(config=JaxAcousticConfig(**CTC_CFG))
        params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
            jax.random.PRNGKey(0), jnp.asarray(batch["signal"]),
            jnp.asarray(batch["signal_lengths"]))["params"])
        with pytest.MonkeyPatch.context() as mp:
            jax_f32 = jax_ctc(batch, params, seeds=JaxSeeds(mp))
        seed_lists = jax_f32[3]
        jax_bf16 = jax_ctc(batch, params, jnp.bfloat16,
                           make_mesh(data=4, model=2))
        sd = params_from_jax(params)
        one = ctc_tp_steps(0, 1, 1, CTC_CFG, sd, batch, seed_lists)
        jobs = [(ctc_tp_steps, (CTC_CFG, sd, batch, seed_lists)),
                (ctc_tp_steps, (SP_CFG, sd, batch, seed_lists)),
                (ctc_tp_steps, (CTC_CFG, sd, batch, seed_lists,
                                torch.bfloat16))]
        ranks = run_tp_ranks(jobs, 4, 2, tmp_path_factory.mktemp("tp_steps"))
        return {"jax": jax_f32, "jax_bf16": jax_bf16, "one": one,
                "f32": [r[0] for r in ranks], "sp": [r[1] for r in ranks],
                "bf16": [r[2] for r in ranks]}


def _ranks_equal(ranks):
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]
        for k, v in ranks[0]["params"].items():
            assert torch.equal(v, r["params"][k]), k
    # the two model ranks of a data rank hold different slices of a
    # split leaf, the two data ranks of a model rank the same
    own = [r["own"] for r in ranks]
    split = [k for k, v in own[0].items() if v.shape != ranks[0][
        "params"][k].shape]
    assert split
    for k in split:
        assert torch.equal(own[0][k], own[2][k])
        assert not torch.equal(own[0][k], own[1][k])


def _close(mine, want, rtol, what):
    np.testing.assert_allclose(mine, want, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("kind", ["f32", "sp"])
def test_dp2_tp2_match_one_process_and_jax(runs, kind):
    ranks, one = runs[kind], runs["one"]
    j_loss, j_gnorm, j_params, _ = runs["jax"]
    _ranks_equal(ranks)
    r0 = ranks[0]
    _close(r0["loss"], one["loss"], 1e-4, "loss vs one process")
    _close(r0["gnorm"], one["gnorm"], 1e-3, "gradient norm vs one process")
    _close(r0["loss"], j_loss, 1e-4, "loss vs JAX")
    _close(r0["gnorm"], j_gnorm, 1e-3, "gradient norm vs JAX")
    for k, v in one["params"].items():
        np.testing.assert_allclose(r0["params"][k].numpy(), v.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)
    check_params(r0["params"], j_params, 1e-5)


def test_sequence_parallel_equals_tensor_parallel(runs):
    sp, tp = runs["sp"][0], runs["f32"][0]
    _close(sp["loss"], tp["loss"], 1e-4, "loss")
    _close(sp["gnorm"], tp["gnorm"], 1e-3, "gradient norm")
    for k, v in tp["params"].items():
        np.testing.assert_allclose(sp["params"][k].numpy(), v.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


def test_bf16_dp2_tp2_matches_jax_tensor_parallel(runs):
    ranks = runs["bf16"]
    _ranks_equal(ranks)
    j_loss, j_gnorm, _, _ = runs["jax_bf16"]
    _close(ranks[0]["loss"], j_loss, BF16_LOSS_RTOL, "bf16 loss vs JAX TP")
    assert all(np.isfinite(ranks[0]["gnorm"]))
