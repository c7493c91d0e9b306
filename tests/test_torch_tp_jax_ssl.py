"""Tensor parallelism in the RNN-T, HuBERT and data2vec steps, held to
JAX: two gloo ranks on the CPU (one model group) take 2 SGD steps, every
dropout at 0.1, with the seeds that the JAX package's single-device
jitted step drew (``JaxSeeds``: the dropout seeds, and HuBERT's and
data2vec's mask seeds), sequence parallelism off and on. The encoder is
split; the transducer's predictor and joint and the SSL heads stay whole;
data2vec's teacher is split as its student is, and its EMA runs on the
rank's slices.

Against JAX: loss rtol 1e-4, gradient norm 1e-3, every parameter (and
data2vec's teacher) within 1e-5; the ranks' whole parameters bitwise
equal. The models and batches are those of ``tests/test_torch_hubert.py``,
``tests/test_torch_data2vec.py`` and ``tests/test_torch_transducer_*.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import Data2VecPretrainConfig as JaxD2VConfig
from audio8_tpu.config import TransducerConfig as JaxRnntConfig
from audio8_tpu.models.data2vec import Data2VecAudioModel as JaxD2V
from audio8_tpu.models.transducer import Transducer as JaxTransducer
from audio8_tpu.train import steps as jax_steps
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu_torch.models.convert import params_from_jax
from tests.test_torch_data2vec import CFG as D2V_CFG
from tests.test_torch_data2vec import d2v_signal
from tests.test_torch_dp_ctc import check_params
from tests.test_torch_dropout_trajectories import JaxSeeds
from tests.test_torch_hubert import CFG as HUBERT_CFG
from tests.test_torch_hubert import hubert_batch
from tests.test_torch_hubert import jax_init as hubert_init
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_tp_jax_text import _jax_steps, _sgd
from tests.test_torch_tp_steps import fairseq_offsets
from tests.test_torch_transducer_dropout import DROPOUT
from tests.test_torch_transducer_steps import CFG as RNNT_CFG
from tests.test_torch_transducer_steps import init_params, make_batch
from tests.torch_tp_ranks import (run_tp_ranks, ssl_tp_steps,
                                  transducer_tp_steps)

cap_torch_threads()

STEPS = 2
MODES = ("tp", "sp")
RNNT = dict(RNNT_CFG, **DROPOUT)


def jax_transducer(monkeypatch):
    params = init_params(RNNT)
    batch = make_batch(1)
    jmodel = JaxTransducer(config=JaxRnntConfig(**RNNT))
    jgrad, jupdate, _, _ = jax_steps.make_transducer_steps(jmodel, _sgd(),
                                                           clip=25.0)
    return (batch, params_from_jax(params),
            _jax_steps(jgrad, jupdate, params, batch, monkeypatch,
                       freeze=False))


def jax_ssl(kind, monkeypatch):
    """``STEPS`` jitted HuBERT or data2vec steps (SGD, clip 1, keys folded
    from 7): the batch, the init, the losses, gradient norms, parameters
    after (the port's names), the seeds per step and data2vec's
    teacher."""
    if kind == "hubert":
        cfg, batch = HUBERT_CFG, hubert_batch(1)
        jmodel, params = hubert_init(cfg)
    else:
        cfg = D2V_CFG
        batch = {"signal": d2v_signal(1), "signal_lengths": None}
        jmodel = JaxD2V(config=JaxD2VConfig(**cfg))
        params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
            {"params": jax.random.PRNGKey(0),
             "mask": jax.random.PRNGKey(1)},
            jnp.asarray(d2v_signal(0)))["params"])
    make = getattr(jax_steps, f"make_{kind}_steps")
    jstep, _ = make(jmodel, _sgd(), clip=1.0)
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), _sgd())
    jteacher = jax.tree.map(jnp.asarray, params)
    jb = {k: None if v is None else jnp.asarray(v) for k, v in batch.items()}
    seeds = JaxSeeds(monkeypatch)
    losses, gnorms, step_seeds = [], [], []
    for i in range(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(7), i)
        if kind == "hubert":
            jstate, jm = jstep(jstate, jb, key)
        else:
            jstate, jteacher, jm = jstep(jstate, jteacher, jb, key)
        replay, keys = seeds.take()
        step_seeds.append((list(replay._seeds), keys))
        losses.append(float(jm["loss"]))
        gnorms.append(float(jm["grad_norm"]))
    return {"batch": batch, "init": params_from_jax(params), "cfg": cfg,
            "loss": losses, "gnorm": gnorms,
            "params": params_from_jax(jax.tree.map(np.asarray,
                                                   jstate.params)),
            "teacher": params_from_jax(jax.tree.map(np.asarray, jteacher)),
            "seeds": step_seeds}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with fairseq_offsets():
        with pytest.MonkeyPatch.context() as mp:
            r_batch, r_params, r_jax = jax_transducer(mp)
        ssl = {}
        for kind in ("hubert", "data2vec"):
            with pytest.MonkeyPatch.context() as mp:
                ssl[kind] = jax_ssl(kind, mp)
        jobs, names = [], []
        for mode in MODES:
            sp = mode == "sp"
            jobs.append((transducer_tp_steps, (
                dict(RNNT, sequence_parallel=sp), r_params, r_batch,
                r_jax[3])))
            names.append(("transducer", mode))
            for kind, j in ssl.items():
                jobs.append((ssl_tp_steps, (
                    kind, dict(j["cfg"], sequence_parallel=sp), j["init"],
                    j["batch"], j["seeds"])))
                names.append((kind, mode))
        ranks = run_tp_ranks(jobs, 2, 2, tmp_path_factory.mktemp("tp_jax3"))
    want = {"transducer": dict(zip(("loss", "gnorm", "params"), r_jax)),
            **ssl}
    return want, {key: [r[i] for r in ranks] for i, key in enumerate(names)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["transducer", "hubert", "data2vec"])
def test_tp2_matches_jax(runs, kind, mode):
    want, tp = runs
    ranks = tp[kind, mode]
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
    np.testing.assert_allclose(ranks[0]["loss"], want[kind]["loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["gnorm"], want[kind]["gnorm"],
                               rtol=1e-3)
    check_params(ranks[0]["params"], want[kind]["params"], 1e-5)
    if kind == "data2vec":
        check_params(ranks[0]["teacher"], want[kind]["teacher"], 1e-5)
