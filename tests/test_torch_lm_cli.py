"""The port's text-LM trainer and the decode flags it feeds, end to end
on the CPU (``--device cpu``), on the tiny letter corpus of
``test_torch_transducer_cli.py`` and a 2-step CTC run on it:

* ``cli.train_lm`` takes 3 steps (validating and saving at step 2 and
  at the last), writes ``lm_config.json`` with the absolute dict file,
  ``lm`` checkpoints with resume files, and resumes from its directory
  at the step it saved; ``--distributed true`` with ``WORLD_SIZE`` set
  but no launcher's rank and rendezvous raises (it never trains one
  rank);
* ``cli.test --beam 4 --lm_rescore`` that basedir, with and without
  ``--device_beam``, gives the JAX entry point's metrics on the same
  checkpoints (``werr_rescore_4``, CER, WER; JAX's rescorer reads the
  LM's weights mapped back to its tree) and splits its host seconds;
* ``cli.transcribe --device_beam true`` and ``cli.serve``'s handler with
  the device beam give the host search's transcripts.

``cli.test --transducer --beam --lm_rescore`` runs in
``test_torch_transducer_cli.py``.
"""
import io
import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio8_tpu import utils as jax_utils
from audio8_tpu.cli.test import evaluate as jax_evaluate
from audio8_tpu.train import checkpoint as jax_checkpoint
from audio8_tpu_torch.cli import serve as serve_cli
from audio8_tpu_torch.cli import test as test_cli
from audio8_tpu_torch.cli import train as train_cli
from audio8_tpu_torch.cli import train_lm, transcribe
from audio8_tpu_torch.models.convert import jax_named_assignments
from audio8_tpu_torch.ops.rescore import NeuralLMRescorer
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_train_cli import SMALL, _train_args
from tests.test_torch_transducer_cli import write_corpus

cap_torch_threads()

LM = ["--d_model", "16", "--num_heads", "2", "--num_layers", "1",
      "--d_ff", "32", "--rpr_k", "4", "--block_len", "16",
      "--batch_size", "4", "--warmup_steps", "1", "--device", "cpu"]
MODEL = [a for a in SMALL if a not in ("--device", "cpu")] + [
    "--pad_to_multiple", "4000"]


@pytest.fixture(autouse=True)
def _restore_offsets():
    """``cli.test`` in both packages remaps their ``Offsets``."""
    saved = [(o.PAD, o.GO, o.EOS, o.UNK, list(o.VALUES))
             for o in (Offsets, jax_utils.Offsets)]
    yield
    for o, s in zip((Offsets, jax_utils.Offsets), saved):
        o.PAD, o.GO, o.EOS, o.UNK = s[:4]
        o.VALUES[:] = s[4]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(corpus, CTC checkpoint, LM basedir, the LM run's state)."""
    root = tmp_path_factory.mktemp("corpus")
    write_corpus(root)
    args = _train_args(root, str(root / "ctc"))
    args[args.index("--train_steps") + 1] = "2"
    args[args.index("--steps_per_checkpoint") + 1] = "2"
    train_cli.train(args)
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    lm_dir = str(root / "lm")
    state = train_lm.train(["--text", str(root / "train.ltr"),
                            "--valid_text", str(root / "valid.ltr"),
                            "--dict_file", str(root / "dict.ltr.txt"),
                            "--basedir", lm_dir, "--train_steps", "3",
                            "--steps_per_checkpoint", "2", *LM])
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]
    return root, str(root / "ctc" / "checkpoint-step-2.pt"), lm_dir, state


def test_train_lm_saves_validates_and_resumes(run, monkeypatch):
    root, _, lm_dir, state = run
    assert state.step == 3 and [r["step"] for r in state.log] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["tokens"] > 0
               for r in state.log)
    assert [v["step"] for v in state.valid] == [2, 3]
    assert all(np.isfinite(v["valid_nll"]) for v in state.valid)
    with open(os.path.join(lm_dir, "lm_config.json")) as f:
        cfg = json.load(f)
    assert cfg["dict_file"] == str(root / "dict.ltr.txt")
    assert (cfg["d_model"], cfg["rpr_k"], cfg["block_len"]) == (16, 4, 16)
    for step in (2, 3):
        for ext in (".pt", ".resume"):
            assert os.path.exists(os.path.join(
                lm_dir, f"checkpoint-step-{step}{ext}"))
    more = train_lm.train(["--text", str(root / "train.ltr"),
                           "--dict_file", str(root / "dict.ltr.txt"),
                           "--basedir", lm_dir, "--train_steps", "4",
                           "--steps_per_checkpoint", "2", "--restart_from",
                           lm_dir, *LM])
    assert more.step == 4 and [r["step"] for r in more.log] == [4]
    # --distributed under a launcher's WORLD_SIZE never trains one rank
    monkeypatch.setenv("WORLD_SIZE", "2")
    for k in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="launch with torchrun"):
        train_lm.train(["--text", "t", "--dict_file", "d",
                        "--distributed", "true", "--device", "cpu"])


def jax_lm_params(lm_dir: str):
    """The port LM's weights as the JAX ``CausalTextLM`` tree."""
    rescorer = NeuralLMRescorer(lm_dir)
    state = rescorer.model.state_dict()
    tree = {}
    for path, key, tf in jax_named_assignments(rescorer.model):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = tf(state[key].numpy())
    return tree


@pytest.mark.parametrize("device_beam", ["false", "true"])
def test_cli_test_rescores_as_jax_does(run, monkeypatch, device_beam):
    root, ckpt, lm_dir, _ = run
    params = jax_lm_params(lm_dir)
    find, load = (jax_checkpoint.find_latest_checkpoint,
                  jax_checkpoint.load_checkpoint)
    monkeypatch.setattr(jax_checkpoint, "find_latest_checkpoint",
                        lambda d, *a, **k: ("lm-ckpt", 3) if d == lm_dir
                        else find(d, *a, **k))
    monkeypatch.setattr(jax_checkpoint, "load_checkpoint",
                        lambda p, *a, **k: {"params": params}
                        if p == "lm-ckpt" else load(p, *a, **k))
    common = MODEL + ["--checkpoint", ckpt, "--root_dir", str(root),
                      "--valid_dataset", "valid.tsv",
                      "--target_tokens_per_batch", "40000", "--beam", "4",
                      "--lm_rescore", lm_dir, "--rescore_alpha", "0.8",
                      "--rescore_word_bonus", "0.2", "--device_beam",
                      device_beam]
    ours = test_cli.evaluate(common + ["--device", "cpu"])
    theirs = jax_evaluate(common + ["--lane_align", "false"])
    assert set(theirs) == {"cer", "wer", "step", "werr_rescore_4"}
    assert {k: ours[k] for k in theirs} == theirs
    assert ours["utterances"] == 6
    assert set(ours["rescore_seconds"]) == {"beam", "ctc", "lm"}


def test_transcribe_and_serve_with_the_device_beam(run):
    root, ckpt, _, _ = run
    wavs = [str(root / "audio" / f"valid{i}.wav") for i in (1, 5)]
    base = wavs + SMALL + ["--checkpoint", ckpt, "--dict_file",
                           str(root / "dict.ltr.txt"), "--beam", "4"]
    host = transcribe.main(base)
    device = transcribe.main(base + ["--device_beam", "true"])
    assert device == host and [p for p, _ in device] == wavs
    service = serve_cli.build_service(serve_cli.parse_args(
        base[len(wavs):] + ["--device_beam", "true"]))
    try:
        assert service.decoder.device == torch.device("cpu")
        for path, text in host:
            _, pcm = wavfile.read(path)
            buf = io.BytesIO()
            wavfile.write(buf, 16000, pcm)
            assert service.transcribe(buf.getvalue())["text"] == text
    finally:
        if service.transcriber.batcher is not None:
            service.transcriber.batcher.close()
