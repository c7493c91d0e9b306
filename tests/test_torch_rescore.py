"""The port's neural-LM n-best rescoring (``ops/rescore.py``) against the
JAX package's on the CPU, under the default and the fairseq CTC
``Offsets`` (``cli.test``'s):

* ``ctc_label_logp`` against JAX's scan, hypotheses of several lengths
  and two that cannot align (more labels than frames; repeats that need
  a blank between them), which JAX's ``zero_infinity`` scores 0: within
  1e-5 of the largest value, the unalignable ones equal;
* ``NeuralLMRescorer.lm_logp`` on JAX weights carried by
  ``params_from_jax`` into the port's ``lm`` checkpoint, against JAX's
  rescorer on the same weights: within 1e-5;
* ``rescore_nbest`` and ``rescore_transducer_nbest``: the same pick and
  totals, an empty hypothesis never picked unless all are, at two LM
  weights and a word bonus.
* The long edges: ``lm_logp`` on hypotheses of up to 520 labels (past
  the LM's ``block_len`` and JAX's 512-label grid step) within 2e-7
  relative, and ``ctc_label_logp`` at (1015 frames, 600 labels) and
  (300, 140) bitwise.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu import utils as jax_utils
from audio8_tpu.config import TextLMConfig as JaxTextLMConfig
from audio8_tpu.models.text import CausalTextLM as JaxCausalTextLM
from audio8_tpu.ops import rescore as jax_rescore
from audio8_tpu.train import checkpoint as jax_checkpoint
from audio8_tpu_torch.config import TextLMConfig
from audio8_tpu_torch.models.convert import params_from_jax
from audio8_tpu_torch.models.text import CausalTextLM
from audio8_tpu_torch.ops import rescore
from audio8_tpu_torch.train.checkpoint import save_checkpoint
from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                          create_optimizer)
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_text_lm import default_offsets  # noqa: F401
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

CFG = dict(vocab_size=12, d_model=32, num_heads=2, num_layers=2, d_ff=64,
           dropout=0.1, rpr_k=4, block_len=16)
T, V = 12, 12


@pytest.fixture(params=[False, True], ids=["default", "fairseq"])
def offsets(request, default_offsets):
    """Both packages' ``Offsets`` at their defaults or remapped to
    fairseq's (``default_offsets`` puts them back after the test)."""
    if request.param:
        Offsets.remap_fairseq_ctc()
        jax_utils.Offsets.remap_fairseq_ctc()
    return request.param


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """(port basedir, JAX params): one JAX init saved as the port's LM
    checkpoint beside its ``lm_config.json``."""
    model = JaxCausalTextLM(config=JaxTextLMConfig(**CFG))
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 16), jnp.int32))["params"])
    basedir = tmp_path_factory.mktemp("lm")
    port = CausalTextLM(TextLMConfig(**CFG))
    port.load_state_dict(params_from_jax(params), strict=True)
    state = TrainState(port, create_optimizer(create_lrs(1e-3, 10)))
    save_checkpoint(state, str(basedir / "checkpoint-step-7.pt"), "lm")
    with open(basedir / "lm_config.json", "w") as f:
        json.dump(dict(CFG, dict_file="dict.ltr.txt"), f)
    return str(basedir), params


def jax_rescorer(monkeypatch, basedir, params, alpha, bonus):
    """JAX's ``NeuralLMRescorer`` on ``params`` (its checkpoint reader
    handed them)."""
    monkeypatch.setattr(jax_checkpoint, "find_latest_checkpoint",
                        lambda d: ("ckpt", 7))
    monkeypatch.setattr(jax_checkpoint, "load_checkpoint",
                        lambda p: {"params": params})
    return jax_rescore.NeuralLMRescorer(basedir, alpha=alpha,
                                        word_bonus=bonus)


def log_probs(seed):
    x = np.random.default_rng(seed).normal(size=(T, V)).astype(
        np.float32) * 2.0
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


HYPS = [[5, 6, 7], [5, 6], [8], [5, 9, 5, 9, 6], [7, 7, 7],
        list(range(4, 12)) * 2,   # 16 labels > 10 frames: cannot align
        [6, 6, 6, 6, 6, 6]]       # 6 repeats need 11 frames of 10


def test_ctc_label_logp_matches_jax_scan(offsets):
    lp = log_probs(0)
    got = rescore.ctc_label_logp(lp, 10, HYPS)
    want = jax_rescore.ctc_label_logp(lp, 10, HYPS)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert got[-2] == want[-2] == 0.0 and got[-1] == want[-1] == 0.0
    assert np.all(got[:-2] < 0)
    assert rescore.ctc_label_logp(lp, 10, []).shape == (0,)


def test_lm_logp_matches_jax(offsets, lm, monkeypatch):
    basedir, params = lm
    mine = rescore.NeuralLMRescorer(basedir, alpha=0.5)
    theirs = jax_rescorer(monkeypatch, basedir, params, 0.5, 0.0)
    hyps = HYPS[:5] + [[]]
    np.testing.assert_allclose(mine.lm_logp(hyps), theirs.lm_logp(hyps),
                               rtol=1e-5)


@pytest.mark.parametrize("alpha,bonus", [(0.5, 0.0), (2.0, 1.5)])
def test_rescore_nbest_picks_as_jax(offsets, lm, monkeypatch, alpha,
                                    bonus):
    basedir, params = lm
    mine = rescore.NeuralLMRescorer(basedir, alpha=alpha, word_bonus=bonus)
    theirs = jax_rescorer(monkeypatch, basedir, params, alpha, bonus)
    for seed in range(3):
        lp = log_probs(seed)
        nbest = [[]] + HYPS[seed:seed + 4]
        timings = {}
        got = rescore.rescore_nbest(lp, 10, nbest, mine, timings=timings)
        assert got == jax_rescore.rescore_nbest(lp, 10, nbest, theirs)
        assert got != 0 and set(timings) == {"ctc", "lm"}
        totals = [rescore.ctc_label_logp(lp, 10, nbest[1:])
                  + alpha * mine.lm_logp(nbest[1:])
                  + bonus * np.array([len(h) for h in nbest[1:]]),
                  jax_rescore.ctc_label_logp(lp, 10, nbest[1:])
                  + alpha * theirs.lm_logp(nbest[1:])
                  + bonus * np.array([len(h) for h in nbest[1:]])]
        np.testing.assert_allclose(totals[0], totals[1], rtol=1e-5)
        assert got == 1 + int(np.argmax(totals[0]))
    assert rescore.rescore_nbest(log_probs(0), 10, [[], []], mine) == 0


def test_rescore_transducer_nbest_picks_as_jax(offsets, lm, monkeypatch):
    basedir, params = lm
    mine = rescore.NeuralLMRescorer(basedir, alpha=1.0, word_bonus=0.3)
    theirs = jax_rescorer(monkeypatch, basedir, params, 1.0, 0.3)
    rng = np.random.default_rng(4)
    for _ in range(4):
        scores = rng.normal(size=5).astype(np.float32) * 3.0 - 10.0
        nbest = [HYPS[i] for i in rng.permutation(5)]
        nbest[int(rng.integers(5))] = []
        assert rescore.rescore_transducer_nbest(scores, nbest, mine) == \
            jax_rescore.rescore_transducer_nbest(scores, nbest, theirs)
    assert rescore.rescore_transducer_nbest([], [], mine) == 0


def test_lm_logp_past_block_len_and_jax_grid_step(lm, monkeypatch):
    """Hypotheses of up to 520 labels: past the LM's ``block_len`` (16)
    and JAX's 512-label grid step, within 2e-7 relative (1.1e-7 seen)."""
    basedir, params = lm
    mine = rescore.NeuralLMRescorer(basedir, alpha=0.5)
    theirs = jax_rescorer(monkeypatch, basedir, params, 0.5, 0.0)
    rng = np.random.default_rng(4)
    hyps = [list(rng.integers(4, 12, size=n)) for n in (17, 300, 512, 520)]
    np.testing.assert_allclose(mine.lm_logp(hyps), theirs.lm_logp(hyps),
                               rtol=2e-7)


def test_ctc_label_logp_long_is_bitwise_jax():
    """(1015 frames, 600 labels) and (300, 140)."""
    rng = np.random.default_rng(5)
    for t, u in ((1015, 600), (300, 140)):
        x = rng.normal(size=(t, V)).astype(np.float32) * 2.0
        lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
        hyps = [list(rng.integers(4, V, size=n)) for n in (u, u // 2)]
        got = rescore.ctc_label_logp(lp, t, hyps)
        want = jax_rescore.ctc_label_logp(lp, t, hyps)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert np.all(got < 0)
