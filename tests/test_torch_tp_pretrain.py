"""Tensor-parallel contrastive pretraining and the global norm at TP 2:
two gloo ranks on the CPU (one model group) take 3 SGD pretraining
steps on a 4-row dense batch with every dropout at 0.1 and the JAX
step's span-mask, Gumbel, negative and dropout seeds, sequence
parallelism off and on (239 frames: a T the group does not divide), in
float32 and bfloat16; then CTC steps whose clip (1.0) scales every step.

Float32 against one process and the JAX single-device step: loss rtol
1e-4, gradient norm 1e-3 (JAX 5e-3, ``tests/test_torch_dp_pretrain.py``'s),
parameters 1e-6 plus 1e-5 of their size against one process and 1e-5
absolute against JAX. The global norm: the split leaves' squares summed
over the model group, the replicated ones once, is one process's norm
(the whole gradient's, gathered on the rank) within 1e-6, and the
clipped steps' norms and parameters are one process's. The
ranks' replicated parameters are bitwise equal. Bfloat16 against JAX's
tensor-parallel step on the 8-device CPU mesh: loss rtol 5e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import PretrainConfig as JaxPretrainConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2Model as JaxPretrainModel
from audio8_tpu.parallel.sharding import (TP_RULES, make_mesh, put_batch,
                                          shard_state)
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from tests.test_torch_bf16 import BF16_LOSS_RTOL
from tests.test_torch_dp_ctc import _batch, check_params
from tests.test_torch_dp_pretrain import _jax_run
from tests.test_torch_dropout_trajectories import (  # noqa: F401
    CTC_CFG, N_NEG, PRETRAIN_CFG, _fairseq_offsets)
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_tp_cli import PARAM_ATOL, PARAM_RTOL
from tests.torch_dp_ranks import LR
from tests.torch_tp_ranks import (ctc_tp_steps, norm_of_split_grads,
                                  pretrain_tp_steps, run_tp_ranks)

cap_torch_threads()

SP_CFG = dict(PRETRAIN_CFG, sequence_parallel=True)


def jax_tp_bf16(signal, params):
    """JAX's bf16 pretraining steps over the (4, 2) mesh, the keys of
    ``_jax_run``."""
    from audio8_tpu_torch.models.convert import jax_from_params

    jmodel = JaxPretrainModel(config=JaxPretrainConfig(**PRETRAIN_CFG),
                              dtype=jnp.bfloat16)
    model = _port_model(params)
    jtx = jax_opt(jax_lrs(LR, 10, sched_type="constant", warmup_steps=0),
                  "sgd")
    mesh = make_mesh(data=4, model=2)
    jstate = shard_state(JaxState.create(jax.tree.map(
        jnp.asarray, jax_from_params(model)), jtx), mesh, TP_RULES)
    jstep, _ = jax_steps.make_pretrain_steps(jmodel, jtx, clip=1.0,
                                             n_negatives=N_NEG, mesh=mesh)
    x = put_batch({"signal": signal}, mesh)["signal"]
    losses = []
    for k in jax.random.split(jax.random.PRNGKey(23), 3):
        jstate, jm = jstep(jstate, x, k)
        losses.append(float(jm["loss"]))
    return losses


def _port_model(params):
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2Model

    model = Wav2Vec2Model(PretrainConfig(**PRETRAIN_CFG))
    model.load_state_dict(params, strict=True)
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    signal = np.random.default_rng(2).normal(size=(4, 2400)).astype(
        np.float32)
    with pytest.MonkeyPatch.context() as mp:
        sd, step_seeds, jm, j_params = _jax_run(mp, signal)
    jax_bf16 = jax_tp_bf16(signal, sd)
    batch = _batch()
    ctc = CTC_CFG
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel

    ctc_sd = {k: v.detach().clone() for k, v in Wav2Vec2AcousticModel(
        AcousticConfig(**ctc), generator=torch.Generator().manual_seed(0))
        .state_dict().items()}
    no_drop = dict(ctc, dropout=0.0, attention_dropout=0.0,
                   dropout_input=0.0)
    clip_args = (no_drop, ctc_sd, batch, [[], []], torch.float32, 1.0)
    jobs = [(pretrain_tp_steps, (PRETRAIN_CFG, sd, signal, step_seeds)),
            (pretrain_tp_steps, (SP_CFG, sd, signal, step_seeds)),
            (pretrain_tp_steps, (PRETRAIN_CFG, sd, signal, step_seeds,
                                 torch.bfloat16)),
            (ctc_tp_steps, clip_args),
            (norm_of_split_grads, (no_drop, ctc_sd, batch))]
    ranks = run_tp_ranks(jobs, 2, 2, tmp_path_factory.mktemp("tp_pretrain"))
    one = pretrain_tp_steps(0, 1, 1, PRETRAIN_CFG, sd, signal, step_seeds)
    one_clip = ctc_tp_steps(0, 1, 1, *clip_args)
    return {"jax": (jm, j_params), "jax_bf16": jax_bf16, "one": one,
            "one_clip": one_clip,
            **{name: [r[i] for r in ranks] for i, name in enumerate(
                ("f32", "sp", "bf16", "clip", "norm"))}}


def _replicated_equal(ranks):
    own0, own1 = ranks[0]["own"], ranks[1]["own"]
    whole = ranks[0]["params"]
    split = [k for k, v in own0.items() if v.shape != whole[k].shape]
    assert split
    for k, v in own0.items():
        if k in split:
            assert not torch.equal(v, own1[k]), k
        else:
            assert torch.equal(v, own1[k]), k
    for k, v in whole.items():
        assert torch.equal(v, ranks[1]["params"][k]), k


@pytest.mark.parametrize("kind", ["f32", "sp"])
def test_tp2_pretraining_matches_one_process_and_jax(runs, kind):
    ranks, one = runs[kind], runs["one"]
    jm, j_params = runs["jax"]
    _replicated_equal(ranks)
    r0 = ranks[0]
    assert r0["loss"] == ranks[1]["loss"]
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-4)
    np.testing.assert_allclose(r0["gnorm"], one["gnorm"], rtol=1e-3)
    np.testing.assert_allclose(r0["loss"], [m["loss"] for m in jm],
                               rtol=1e-4)
    np.testing.assert_allclose(r0["gnorm"], [m["grad_norm"] for m in jm],
                               rtol=5e-3)
    for k, v in one["params"].items():
        np.testing.assert_allclose(r0["params"][k].numpy(), v.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)
    check_params(r0["params"], j_params, 1e-5)


def test_bf16_tp2_pretraining_matches_jax_tensor_parallel(runs):
    ranks = runs["bf16"]
    _replicated_equal(ranks)
    np.testing.assert_allclose(ranks[0]["loss"], runs["jax_bf16"],
                               rtol=BF16_LOSS_RTOL)


def test_global_norm_of_split_gradients_is_the_whole_norm(runs):
    for r in runs["norm"]:
        assert r == runs["norm"][0]
        np.testing.assert_allclose(r["split"], r["whole"], rtol=1e-6)


def test_clipping_is_one_process(runs):
    ranks, one = runs["clip"], runs["one_clip"]
    _replicated_equal(ranks)
    assert min(one["gnorm"]) > 1.0  # every step is clipped
    np.testing.assert_allclose(ranks[0]["gnorm"], one["gnorm"], rtol=1e-3)
    for k, v in one["params"].items():
        np.testing.assert_allclose(ranks[0]["params"][k].numpy(),
                                   v.numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)
