"""``cli.train --distributed true`` on two gloo ranks against the JAX
trainer on the same corpus from the same fairseq ``.pt`` (dropout and
masks off, so both draw nothing): the ranks' logged global losses are
JAX's single-device step's, at the tolerance of the single-process
comparison (``tests/test_torch_eval_cli.py:
test_both_trainers_restart_from_one_pt``: rtol 1e-3, the first step
1e-4)."""
import numpy as np
import pytest

import audio8_tpu.cli.train as jax_train_cli
from audio8_tpu import utils as jax_utils
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_eval_cli import checkpoint, flac_corpus  # noqa: F401
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_train_cli import _train_args, corpus  # noqa: F401
from tests.torch_dp_ranks import run_cli_ranks

cap_torch_threads()


@pytest.fixture(autouse=True)
def _restore_offsets():
    """Both trainers remap their package's ``Offsets``."""
    saved = [(o.PAD, o.GO, o.EOS, o.UNK, list(o.VALUES))
             for o in (Offsets, jax_utils.Offsets)]
    yield
    for o, s in zip((Offsets, jax_utils.Offsets), saved):
        o.PAD, o.GO, o.EOS, o.UNK = s[:4]
        o.VALUES[:] = s[4]


def test_two_ranks_match_the_jax_trainer(flac_corpus, checkpoint, tmp_path,
                                         monkeypatch):
    recorded = []
    real = jax_train_cli.make_ctc_steps

    def recording(*a, **kw):
        grad_fn, update_fn, eval_fn = real(*a, **kw)
        step = grad_fn.train_step

        def train_step(*args, **kwargs):
            out = step(*args, **kwargs)
            recorded.append(float(out[1]))
            return out

        grad_fn.train_step = train_step
        return grad_fn, update_fn, eval_fn

    monkeypatch.setattr(jax_train_cli, "make_ctc_steps", recording)
    args = _train_args(flac_corpus, "")
    for flag, value in (("--train_steps", "4"), ("--grad_accum", "1"),
                        ("--steps_per_checkpoint", "100"),
                        ("--valid_steps", "0"),
                        ("--unfreeze_enc_after_step", "2"),
                        ("--timestep_masking", "0.0")):
        args[args.index(flag) + 1] = value
    args = [a for a in args if a not in ("--device", "cpu")] + [
        "--restart_from", checkpoint, "--dropout", "0.0",
        "--channel_masking", "0.0"]
    args[args.index("--basedir") + 1] = str(tmp_path / "port")
    (ranks,) = run_cli_ranks([("audio8_tpu_torch.cli.train",
                               args + ["--device", "cpu"])], 2,
                             tmp_path / "ranks")
    args[args.index("--basedir") + 1] = str(tmp_path / "jax")
    jax_train_cli.train(args + ["--lane_align", "false"])
    losses = [r["loss"] for r in ranks[0]["log"]]
    assert losses == [r["loss"] for r in ranks[1]["log"]]
    assert [r["frozen"] for r in ranks[0]["log"]] == [True] * 3 + [False]
    assert len(recorded) == len(losses) == 4
    np.testing.assert_allclose(losses, recorded, rtol=1e-3)
    np.testing.assert_allclose(losses[0], recorded[0], rtol=1e-4)
