"""Data-parallel contrastive pretraining: two gloo ranks on the CPU, each
on its half of a 4-row dense batch, take 3 SGD steps with every dropout at
0.1 and the JAX step's span-mask, Gumbel, negative and dropout seeds.
The ranks' parameters are bitwise equal, and the losses, code
perplexities, accuracies, gradient norms and parameters match the
port's one-rank step on the global batch and the JAX single-device
step: the masks, noise and negatives are drawn for the global rows, the
slot average and accuracy divide by global counts, and the perplexity is
taken over the global batch's averaged probabilities.

The perplexity is the same global value on every rank; its gradient
reaches each rank through its own rows only (``sharding.global_sum``'s
identity backward), so the ranks' summed gradient is one rank's on the
global batch, not twice it. One pair of ranks runs both tests' steps.

Tolerances as the CTC file's (``tests/test_torch_dp_ctc.py``): 2 ranks
against 1, loss rtol 1e-5 and gradient norm 1e-4; against JAX the
single-process trajectory tests' (loss rtol 1e-4 each step, gradient
norm 5e-3); parameters 1e-6 and 1e-5 absolute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import PretrainConfig as JaxPretrainConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2Model as JaxPretrainModel
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.models.convert import params_from_jax
from tests.test_torch_dp_ctc import check_params
from tests.test_torch_dropout_trajectories import (N_NEG, PRETRAIN_CFG,
                                                   JaxSeeds)
from tests.test_torch_threads import cap_torch_threads
from tests.torch_dp_ranks import (LR, ppl_grads, pretrain_steps, run_ranks,
                                  several)

cap_torch_threads()

STEPS = 3


def _jax_run(monkeypatch, signal):
    jmodel = JaxPretrainModel(config=JaxPretrainConfig(**PRETRAIN_CFG))
    rngs = {k: jax.random.PRNGKey(i)
            for i, k in enumerate(("params", "mask", "gumbel", "dropout"))}
    params = jax.tree.map(np.asarray, jax.jit(
        lambda r, x: jmodel.init(r, x, train=True))(
        rngs, jnp.asarray(signal))["params"])
    jtx = jax_opt(jax_lrs(LR, 10, sched_type="constant", warmup_steps=0),
                  "sgd")
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), jtx)
    jstep, _ = jax_steps.make_pretrain_steps(jmodel, jtx, clip=1.0,
                                             n_negatives=N_NEG)
    seeds = JaxSeeds(monkeypatch)
    step_seeds, metrics = [], []
    for k in jax.random.split(jax.random.PRNGKey(23), STEPS):
        jstate, jm = jstep(jstate, jnp.asarray(signal), k)
        replay, keys = seeds.take()
        step_seeds.append((list(replay._seeds), tuple(keys)))
        metrics.append({m: float(jm[m]) for m in
                        ("loss", "grad_norm", "code_perplexity",
                         "accuracy")})
    return (params_from_jax(params), step_seeds, metrics,
            params_from_jax(jax.tree.map(np.asarray, jstate.params)))


def _ppl_inputs():
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2Model

    signal = np.random.default_rng(3).normal(size=(4, 2400)).astype(
        np.float32)
    model = Wav2Vec2Model(PretrainConfig(**PRETRAIN_CFG),
                          generator=torch.Generator().manual_seed(0))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return PRETRAIN_CFG, sd, signal, (list(range(100, 140)), (11, 12, 13))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run, then both tests' 2-rank runs on one pair of ranks."""
    signal = np.random.default_rng(2).normal(size=(4, 2400)).astype(
        np.float32)
    with pytest.MonkeyPatch.context() as mp:
        sd, step_seeds, jm, j_params = _jax_run(mp, signal)
    steps_args = (PRETRAIN_CFG, sd, signal, step_seeds)
    ppl_args = _ppl_inputs()
    two = run_ranks(several, 2, tmp_path_factory.mktemp("dp_pretrain"),
                    [(pretrain_steps, steps_args), (ppl_grads, ppl_args)])
    return {"steps": ([r[0] for r in two], steps_args, jm, j_params),
            "ppl": ([r[1] for r in two], ppl_args)}


def test_two_ranks_match_one_rank_and_jax(runs):
    two, args, jm, j_params = runs["steps"]
    one = pretrain_steps(0, 1, None, *args)
    for k, v in two[0]["params"].items():
        assert torch.equal(v, two[1]["params"][k]), k
    for m in ("loss", "ppl", "accuracy", "gnorm"):
        assert two[0][m] == two[1][m], m
    np.testing.assert_allclose(two[0]["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(two[0]["ppl"], one["ppl"], rtol=1e-5)
    np.testing.assert_allclose(two[0]["accuracy"], one["accuracy"],
                               rtol=1e-5)
    np.testing.assert_allclose(two[0]["gnorm"], one["gnorm"], rtol=1e-4)
    np.testing.assert_allclose(two[0]["loss"], [m["loss"] for m in jm],
                               rtol=1e-4)
    np.testing.assert_allclose(two[0]["ppl"],
                               [m["code_perplexity"] for m in jm],
                               rtol=1e-4)
    np.testing.assert_allclose(two[0]["accuracy"],
                               [m["accuracy"] for m in jm], rtol=1e-4)
    np.testing.assert_allclose(two[0]["gnorm"],
                               [m["grad_norm"] for m in jm], rtol=5e-3)
    check_params(two[0]["params"], one["params"], 1e-6)
    check_params(two[0]["params"], j_params, 1e-5)


def test_perplexity_gradient_is_not_multiplied_by_the_ranks(runs):
    """The summed gradient of the global code perplexity over two ranks
    is one rank's on the global batch (an all-reduce as the backward of
    the global average would double it)."""
    two, args = runs["ppl"]
    one = ppl_grads(0, 1, None, *args)
    assert two[0]["ppl"] == two[1]["ppl"]
    np.testing.assert_allclose(two[0]["ppl"], one["ppl"], rtol=1e-6)
    assert set(two[0]["grads"]) == set(one["grads"])
    for k, g in one["grads"].items():
        assert float(g.abs().max()) > 0, k
        torch.testing.assert_close(two[0]["grads"][k], g, rtol=1e-4,
                                   atol=1e-6 * float(g.abs().max()), msg=k)
