"""The port's RNN-T entry points end to end on the CPU (``--device
cpu``), on a tiny synthetic letter corpus:

* ``cli.train_transducer`` takes 4 steps (1 frozen, then unfrozen;
  dropout and time masking on; the beam-decoded validation of
  ``--valid_beam 2``), writes transducer ``.pt`` checkpoints with resume
  files, and resumes from its directory at the step it saved;
* ``cli.transcribe --transducer``: greedy, the beam's 1-best,
  ``--timestamps`` (word times from the greedy alignment) and
  ``--chunk_seconds`` (the ``TransducerStreamer``);
* ``cli.serve --transducer``: ``/transcribe`` and ``/stream`` give the
  streamer's text;
* ``cli.test --transducer``, greedy, ``--beam``, and ``--beam`` with
  ``--lm_rescore`` a ``cli.train_lm`` basedir;
* JAX's refusals: CTC-path flags under ``--transducer`` exit,
  ``--device_beam`` among them.

The export's CLIs are in ``test_torch_transducer_export.py``.
"""
import io
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio8_tpu_torch.cli import serve as serve_cli
from audio8_tpu_torch.cli import test as test_cli
from audio8_tpu_torch.cli import train_lm, train_transducer
from audio8_tpu_torch.cli import transcribe
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

MODEL = ["--d_model", "32", "--num_heads", "2", "--num_layers", "1",
         "--d_ff", "64", "--pred_layers", "1", "--pred_dim", "32",
         "--pred_embed_dim", "16", "--d_joint", "32", "--device", "cpu"]
WORDS = ["CAT", "DOG", "GO ON", "HI", "SO SO", "NO WAY"]


@pytest.fixture(autouse=True)
def _restore_port_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


def write_corpus(root):
    """Six train and six valid WAVs of 0.5-1.5 s with letter transcripts
    under ``root``, their manifests and the letter dict."""
    audio = root / "audio"
    audio.mkdir()
    rng = np.random.default_rng(0)
    letters = sorted(set("".join(w.replace(" ", "") for w in WORDS)) | {"|"})
    with open(root / "dict.ltr.txt", "w") as f:
        f.writelines(f"{ch} 1\n" for ch in letters)
    for split in ("train", "valid"):
        with open(root / f"{split}.tsv", "w") as tf, \
                open(root / f"{split}.ltr", "w") as lf:
            tf.write(str(audio) + "\n")
            for i, w in enumerate(WORDS):
                n = 8000 + 2000 * i
                name = f"{split}{i}.wav"
                wavfile.write(str(audio / name), 16000,
                              (rng.normal(size=n) * 5000).astype(np.int16))
                tf.write(f"{name}\t{n}\n")
                lf.write(" ".join(list(w.replace(" ", "|"))) + " |\n")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The corpus and a 4-step run: (corpus dir, run dir, train state)."""
    root = tmp_path_factory.mktemp("corpus")
    write_corpus(root)
    basedir = str(root / "run")
    state = train_transducer.train(_train_args(root, basedir, 4))
    return root, basedir, state


def _train_args(root, basedir, steps):
    return MODEL + ["--basedir", basedir, "--root_dir", str(root),
                    "--train_dataset", "train.tsv",
                    "--valid_dataset", "valid.tsv",
                    "--pad_to_multiple", "4000",
                    "--target_tokens_per_batch", "40000",
                    "--train_steps", str(steps), "--grad_accum", "1",
                    "--steps_per_checkpoint", "2", "--valid_steps", "10",
                    "--warmup_steps", "2", "--unfreeze_enc_after_step", "0",
                    "--timestep_masking", "0.1", "--num_train_workers", "1",
                    "--max_decode_len", "16", "--valid_beam", "2"]


def _ckpt(root, basedir):
    return ["--checkpoint", os.path.join(basedir, "checkpoint-step-4.pt"),
            "--dict_file", str(root / "dict.ltr.txt")]


def test_train_checkpoints_and_resumes(run, tmp_path):
    root, basedir, state = run
    assert state.step == 4 and [r["frozen"] for r in state.log] == \
        [True, False, False, False]
    assert all(np.isfinite(r["loss"]) for r in state.log)
    assert [v["beam"] for v in state.valid] == [2, 2]
    assert all(np.isfinite(v["wer"]) and v["utterances"] == 6
               for v in state.valid)
    for step in (2, 4):
        for ext in (".pt", ".resume"):
            assert os.path.exists(os.path.join(
                basedir, f"checkpoint-step-{step}{ext}"))
    blob = torch.load(os.path.join(basedir, "checkpoint-step-4.pt"),
                      weights_only=True)
    assert blob["kind"] == "transducer"
    assert "predictor.rnn_0.cell.hi.bias" in blob["model"]
    resumed = train_transducer.train(_train_args(root, basedir, 5)
                                     + ["--restart_from", basedir])
    assert resumed.step == 5 and [r["step"] for r in resumed.log] == [5]


def test_transcribe_greedy_beam_timestamps_chunked(run, capsys):
    root, basedir, _ = run
    wavs = [str(root / "audio" / "valid0.wav"),
            str(root / "audio" / "valid5.wav")]
    base = wavs + MODEL + _ckpt(root, basedir) + ["--transducer", "true",
                                                  "--max_decode_len", "16"]
    greedy = transcribe.main(base)
    assert [p for p, _ in greedy] == wavs
    assert all(isinstance(t, str) for _, t in greedy)
    beam = transcribe.main(base + ["--beam", "3"])
    assert [p for p, _ in beam] == wavs
    rows = transcribe.main(base + ["--timestamps", "true"])
    assert [r["text"] for r in rows] == [t for _, t in greedy]
    for r in rows:
        assert all(0 <= w["start"] <= w["end"] for w in r["words"])
    chunked = transcribe.main(base + ["--chunk_seconds", "1",
                                      "--context_seconds", "0.2"])
    assert len(chunked) == 2
    with pytest.raises(SystemExit, match="whole-utterance greedy"):
        transcribe.main(base + ["--timestamps", "true", "--beam", "2"])
    with pytest.raises(SystemExit, match="CTC-path"):
        transcribe.main(base + ["--lm", "lm.arpa"])
    with pytest.raises(SystemExit, match="CTC-path"):
        transcribe.main(base + ["--device_beam", "true"])


def _serve(argv):
    service = serve_cli.build_service(serve_cli.parse_args(argv))
    srv = serve_cli.make_server(service, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return service, srv


def _post(port, path, data):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data)
    return urllib.request.urlopen(req, timeout=60).read().decode()


def _serve_texts(argv, wav):
    service, srv = _serve(argv)
    port = srv.server_address[1]
    try:
        buf = io.BytesIO()
        wavfile.write(buf, 16000, wav)
        one = json.loads(_post(port, "/transcribe", buf.getvalue()))
        lines = [json.loads(x) for x in _post(
            port, "/stream", wav.astype("<i2").tobytes()).splitlines() if x]
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=60).read())
    finally:
        srv.shutdown()
        srv.server_close()
        service.transcriber.batcher.close()
    assert lines[-1]["final"] and lines[-1]["text"] == one["text"]
    return one["text"], health


def test_serve_transcribe_and_stream(run):
    root, basedir, _ = run
    _, wav = wavfile.read(str(root / "audio" / "valid5.wav"))
    argv = MODEL + _ckpt(root, basedir) + [
        "--transducer", "true", "--chunk_seconds", "1",
        "--context_seconds", "0.2"]
    text, health = _serve_texts(argv, wav)
    assert health["model"] == "wav2vec2-transducer"
    live = transcribe.main([str(root / "audio" / "valid5.wav")] + argv)
    assert live[0][1] == text
    with pytest.raises(SystemExit, match="CTC-path"):
        serve_cli.build_service(serve_cli.parse_args(argv + ["--beam", "2"]))


def test_test_cli_greedy_and_beam(run):
    root, basedir, _ = run
    argv = MODEL + ["--root_dir", str(root), "--valid_dataset", "valid.tsv",
                    "--basedir", basedir, "--pad_to_multiple", "4000",
                    "--transducer", "true", "--max_decode_len", "16"]
    greedy = test_cli.evaluate(argv)
    beam = test_cli.evaluate(argv + ["--beam", "3"])
    for m in (greedy, beam):
        assert m["utterances"] == 6 and np.isfinite(m["wer"])
    lm_dir = str(root / "lm")
    train_lm.train(["--text", str(root / "train.ltr"), "--dict_file",
                    str(root / "dict.ltr.txt"), "--basedir", lm_dir,
                    "--d_model", "16", "--num_heads", "2", "--num_layers",
                    "1", "--d_ff", "32", "--block_len", "16",
                    "--batch_size", "4", "--train_steps", "2",
                    "--steps_per_checkpoint", "2", "--warmup_steps", "1",
                    "--device", "cpu"])
    rescored = test_cli.evaluate(argv + ["--beam", "3", "--lm_rescore",
                                         lm_dir])
    assert rescored["utterances"] == 6 and np.isfinite(rescored["wer"])
    with pytest.raises(ValueError, match="CTC-path"):
        test_cli.evaluate(argv + ["--lm", "lm.arpa"])
