"""The port's host tools against the JAX package's: ``cli.manifest``
(manifests, ``.wrd``/``.ltr`` and ``dict.ltr.txt`` byte-equal to JAX's
on a LibriSpeech-layout corpus of WAV and FLAC files), ``ops.ngram`` and
``cli.train_ngram`` (the ARPA byte-equal to JAX's ``train_kneser_ney``),
``cli.average_checkpoints`` (the numpy mean of the port's own
checkpoints, loaded by ``cli.test`` and ``cli.transcribe``) and
``cli.inspect_checkpoint`` (JAX's output, text and JSON, on the fairseq
golden fixtures)."""
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio8_tpu.cli import inspect_checkpoint as jax_inspect
from audio8_tpu.cli import manifest as jax_manifest
from audio8_tpu.cli import train_ngram as jax_train_ngram
from audio8_tpu.ops import ngram as jax_ngram
from audio8_tpu_torch.cli import average_checkpoints, inspect_checkpoint
from audio8_tpu_torch.cli import manifest, train_ngram, transcribe
from audio8_tpu_torch.cli import test as test_cli
from audio8_tpu_torch.config import AcousticConfig
from audio8_tpu_torch.models.convert import load_fairseq_ctc, save_fairseq_ctc
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.ops import ngram
from audio8_tpu_torch.utils import Offsets
from tests.test_native import encode_flac
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_train_cli import corpus  # noqa: F401 - a fixture

cap_torch_threads()

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "fairseq_golden")
SMALL = ["--d_model", "32", "--num_heads", "2", "--num_layers", "1",
         "--d_ff", "64"]


@pytest.fixture(autouse=True)
def _restore_port_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


def _librispeech(root):
    """Two speakers' chapters of WAV and FLAC utterances with their
    ``*.trans.txt``."""
    rng = np.random.default_rng(0)
    words = ["THE", "CAT", "SAT", "ON", "A", "MAT", "DOG'S", "RAN"]
    for spk, chap, ext in (("19", "198", ".wav"), ("26", "495", ".flac")):
        d = root / spk / chap
        os.makedirs(d)
        with open(d / f"{spk}-{chap}.trans.txt", "w") as f:
            for u in range(4):
                utt = f"{spk}-{chap}-{u:04d}"
                x = (rng.normal(size=4000 + 1500 * u) * 1000).astype(np.int16)
                if ext == ".wav":
                    wavfile.write(str(d / (utt + ext)), 16_000, x)
                else:
                    (d / (utt + ext)).write_bytes(encode_flac(x))
                f.write(utt + " " + " ".join(rng.choice(words, size=3)) + "\n")


def test_manifests_byte_equal_jax(tmp_path):
    root = tmp_path / "LibriSpeech"
    _librispeech(root)
    args = ["--root", str(root), "--valid_fraction", "0.25", "--labels",
            "librispeech", "--write_dict", "--min_samples", "5000"]
    jax_manifest.main(args + ["--output", str(tmp_path / "jax")])
    manifest.main(args + ["--output", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "dict.ltr.txt", "train.ltr", "train.tsv", "train.wrd", "valid.ltr",
        "valid.tsv", "valid.wrd"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert manifest.flac_num_samples(str(
        root / "26" / "495" / "26-495-0002.flac")) == 7000


def test_arpa_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    vocab = [f"w{i}" for i in range(40)]
    lines = [" ".join(rng.choice(vocab, size=rng.integers(1, 12)))
             for _ in range(300)]
    wrd = tmp_path / "train.wrd"
    wrd.write_text("\n".join(lines) + "\n\n")
    for order in (1, 3, 4):
        jax_train_ngram.main(["--input", str(wrd), "--output",
                              str(tmp_path / "jax.arpa"), "--order",
                              str(order)])
        train_ngram.main(["--input", str(wrd), "--output",
                          str(tmp_path / "port.arpa"), "--order",
                          str(order)])
        assert (tmp_path / "port.arpa").read_text() == \
            (tmp_path / "jax.arpa").read_text()
    sents = [ln.split() for ln in lines]
    mine, theirs = ngram.train_kneser_ney(sents, 3), \
        jax_ngram.train_kneser_ney(sents, 3)
    assert mine.prob == theirs.prob and mine.backoff == theirs.backoff
    with pytest.raises(ValueError, match="reserved"):
        ngram.train_kneser_ney([["a", "</s>"]], 2)


def _ctc_checkpoints(corpus, n):
    """``n`` random CTC models of the corpus' vocabulary as the trainer's
    ``checkpoint-step-N.pt`` files; returns the directory and states."""
    letters = [ln.split()[0] for ln in
               (corpus / "dict.ltr.txt").read_text().splitlines()]
    cfg = AcousticConfig(num_labels=4 + len(letters), d_model=32,
                         num_heads=2, num_layers=1, d_ff=64,
                         timestep_masking=0.0, channel_masking=0.0)
    run = corpus / "run"
    run.mkdir()
    states = []
    for step in range(1, n + 1):
        model = Wav2Vec2AcousticModel(
            cfg, generator=torch.Generator().manual_seed(step))
        save_fairseq_ctc(model, str(run / f"checkpoint-step-{step * 10}.pt"))
        states.append(model.state_dict())
    return run, states


def test_average_is_the_mean_and_loads(corpus):  # noqa: F811
    run, states = _ctc_checkpoints(corpus, 3)
    out = average_checkpoints.main(["--basedir", str(run), "--last", "2",
                                    "--output", str(run / "checkpoint")])
    assert out == str(run / "checkpoint-avg-30.pt")
    avg = load_fairseq_ctc(out)
    for k, v in states[1].items():
        want = np.mean(np.stack([v.numpy(), states[2][k].numpy()]).astype(
            np.float64), axis=0).astype(np.float32)
        np.testing.assert_array_equal(avg[k].numpy(), want)
    assert not os.path.exists(str(run / "checkpoint-avg-30.resume"))
    metrics = test_cli.evaluate(SMALL + [
        "--device", "cpu", "--checkpoint", out, "--root_dir", str(corpus),
        "--valid_dataset", "valid.tsv", "--pad_to_multiple", "4000",
        "--target_tokens_per_batch", "40000"])
    assert np.isfinite(metrics["cer"]) and metrics["utterances"] == 6
    audio = (corpus / "valid.tsv").read_text().splitlines()[0]
    rows = transcribe.main(SMALL + ["--device", "cpu", "--checkpoint", out,
                                    "--dict_file",
                                    str(corpus / "dict.ltr.txt"),
                                    f"{audio}/valid0.wav"])
    assert rows[0][0].endswith("valid0.wav")


def test_average_explicit_files_keep_their_layout(tmp_path):
    paths = []
    for step, fill in ((5, 1.0), (9, 4.0)):
        paths.append(str(tmp_path / f"checkpoint-step-{step}.pt"))
        torch.save({"kind": "seq2seq", "model": {
            "w": torch.full((2, 3), fill), "n": torch.tensor([step])}},
            paths[-1])
    out = average_checkpoints.main(["--checkpoints", *paths, "--output",
                                    str(tmp_path / "x")])
    blob = torch.load(out, weights_only=True)
    assert out.endswith("x-avg-9.pt") and blob["kind"] == "seq2seq"
    assert torch.equal(blob["model"]["w"], torch.full((2, 3), 2.5))
    assert torch.equal(blob["model"]["n"], torch.tensor([5]))
    (tmp_path / "one").mkdir()
    with pytest.raises(SystemExit, match=">=2 step checkpoints"):
        average_checkpoints.main(["--basedir", str(tmp_path / "one"),
                                  "--output", "x"])


@pytest.mark.parametrize("name", ["ctc_tiny.pt", "pretrained_tiny.pt"])
@pytest.mark.parametrize("flags", [[], ["--json"], ["--tree"]])
def test_inspect_equals_jax(name, flags, capsys):
    path = os.path.join(FIX, name)
    theirs = jax_inspect.main([path, *flags])
    out_jax = capsys.readouterr().out
    mine = inspect_checkpoint.main([path, *flags])
    assert capsys.readouterr().out == out_jax
    assert mine == theirs and mine["step"] is None


def test_inspect_reads_the_port_checkpoints(tmp_path):
    path = str(tmp_path / "checkpoint-step-7.pt")
    torch.save({"kind": "paired", "model": {"a": torch.zeros(3, 2)}}, path)
    torch.save({}, str(tmp_path / "checkpoint-step-7.resume"))
    s = inspect_checkpoint.main([path, "--json"])
    assert s["format"] == "audio8_tpu_torch paired .pt" and s["step"] == 7
    assert s["total_params"] == 6 and s["optimizer_state"]
    (tmp_path / "hf").mkdir()  # neither an HF directory nor a run
    with pytest.raises(SystemExit, match="not a recognizable"):
        inspect_checkpoint.main([str(tmp_path / "hf")])
