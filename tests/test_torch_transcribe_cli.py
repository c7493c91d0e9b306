"""``cli.transcribe`` of the port against the JAX package's on the
committed fairseq golden CTC checkpoint (``tests/fixtures/
fairseq_golden``; its 2-layer, 32-channel extractor is given to both
CLIs' ``AcousticConfig``): ``--vad true --timestamps true`` JSON rows on
two files with silences (file, text and segments equal; words equal in
text and times, confidences within 1e-3), the same with ``--beam 4
--lm`` (no VAD), VAD text lines, and ``--quantize int8`` text within the
characters JAX's own quantization changes; ``--timestamps`` with
``--target_type bpe`` exits as in JAX. The JAX side runs with
``--lane_align false`` (not ported)."""
import functools
import json
import os

import numpy as np
import pytest
from scipy.io import wavfile

import audio8_tpu.cli.transcribe as jax_transcribe
import audio8_tpu_torch.cli.transcribe as transcribe
from audio8_tpu.config import AcousticConfig as JaxConfig
from audio8_tpu_torch.config import AcousticConfig
from audio8_tpu_torch.ops.ngram import train_kneser_ney
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "fairseq_golden")
LETTERS = ["|", "E", "T", "A", "O", "N", "I", "H"]  # 12 labels in all
SIZE = ["--d_model", "64", "--num_heads", "4", "--num_layers", "2",
        "--d_ff", "256"]
CONF_TOL = 1e-3


@pytest.fixture(autouse=True)
def _golden_geometry(monkeypatch):
    with open(os.path.join(FIX, "MANIFEST.json")) as f:
        fx = tuple(tuple(b) for b in json.load(f)["geometry"]["fx"])
    monkeypatch.setattr(jax_transcribe, "AcousticConfig", functools.partial(
        JaxConfig, custom_conv_features=fx))
    monkeypatch.setattr(transcribe, "AcousticConfig", functools.partial(
        AcousticConfig, custom_conv_features=fx))
    saved = (Offsets.PAD, Offsets.GO, list(Offsets.VALUES))
    yield
    Offsets.PAD, Offsets.GO = saved[:2]
    Offsets.VALUES[:] = saved[2]


def speech_with_silences(seed: int) -> np.ndarray:
    """3 s: tone-and-noise bursts of 0.3-0.5 s between near-silences, so
    each VAD segment pads to one second and the whole file to three (one
    JAX compile for each)."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(3):
        parts.append(rng.normal(size=int(rng.uniform(0.3, 0.45) * 16_000))
                     * 1e-3)
        n = int(rng.uniform(0.3, 0.5) * 16_000)
        t = np.arange(n) / 16_000
        parts.append(0.3 * np.sin(2 * np.pi * rng.uniform(150, 700) * t)
                     + 0.1 * rng.normal(size=n))
    wav = np.concatenate(parts)
    tail = rng.normal(size=3 * 16_000 - len(wav)) * 1e-3
    return np.concatenate([wav, tail]).astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("golden_cli")
    dict_file = str(tmp / "dict.ltr.txt")
    with open(dict_file, "w") as f:
        f.writelines(f"{c} {100 - i}\n" for i, c in enumerate(LETTERS))
    wavs = []
    for seed in (0, 1):
        path = str(tmp / f"utt{seed}.wav")
        wav = speech_with_silences(seed)
        wavfile.write(path, 16_000, (wav * 32767).astype(np.int16))
        wavs.append(path)
    rng = np.random.default_rng(2)
    words = ["".join(rng.choice(LETTERS[1:], size=rng.integers(1, 4)))
             for _ in range(40)]
    lm = str(tmp / "lm.arpa")
    train_kneser_ney([list(rng.choice(words, size=6)) for _ in range(300)],
                     3).write_arpa(lm)
    base = ["--checkpoint", os.path.join(FIX, "ctc_tiny.pt"), "--dict_file",
            dict_file, *SIZE]
    return base, wavs, lm


def run_both(args, wavs):
    theirs = jax_transcribe.main(args + ["--lane_align", "false"] + wavs)
    mine = transcribe.main(args + ["--device", "cpu"] + wavs)
    return mine, theirs


def assert_rows_equal(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert (a["file"], a["text"], a.get("segments")) == \
            (b["file"], b["text"], b.get("segments"))
        assert [(w["word"], w["start"], w["end"]) for w in a["words"]] == \
            [(w["word"], w["start"], w["end"]) for w in b["words"]]
        for wa, wb in zip(a["words"], b["words"]):
            assert abs(wa["confidence"] - wb["confidence"]) <= CONF_TOL


def test_vad_timestamps_rows_equal_jax(files, capsys):
    base, wavs, _ = files
    mine, theirs = run_both(base + ["--vad", "true", "--timestamps", "true"],
                            wavs)
    assert_rows_equal(mine, theirs)
    assert any(len(r["segments"]) > 1 for r in mine)
    for row in mine:
        for w in row["words"]:  # global times: each starts in a segment
            assert any(a <= w["start"] <= b for a, b in row["segments"])
    printed = [json.loads(line) for line in capsys.readouterr().out
               .splitlines() if line.startswith("{")]
    assert printed[-len(mine):] == mine
    # the plain text lines carry the rows' texts
    lines = transcribe.main(base + ["--device", "cpu", "--vad", "true"]
                            + wavs)
    assert lines == [(r["file"], r["text"]) for r in theirs]


def test_beam_lm_timestamps_rows_equal_jax(files):
    base, wavs, lm = files
    mine, theirs = run_both(base + ["--timestamps", "true", "--beam", "4",
                                    "--lm", lm], wavs)
    assert_rows_equal(mine, theirs)


def char_errors(a: str, b: str) -> int:
    row = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, cb in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1,
                                       prev + (ca != cb))
    return row[-1]


def test_int8_text(files):
    """``--quantize int8``: activation codes move by one step where the
    float paths differ by 1e-6 (``tests/test_torch_quant.py``), so the
    port's int8 text is held to JAX's int8 text within the characters
    that JAX's own quantization changes (JAX int8 vs JAX float)."""
    base, wavs, _ = files
    mine, theirs = run_both(base + ["--quantize", "int8"], wavs[:1])
    float_text = jax_transcribe.main(base + ["--lane_align", "false"]
                                     + wavs[:1])[0][1]
    assert mine[0][0] == theirs[0][0]
    assert char_errors(mine[0][1], theirs[0][1]) <= char_errors(
        theirs[0][1], float_text)


def test_timestamps_need_letters(files):
    base, wavs, _ = files
    with pytest.raises(SystemExit, match="--target_type ltr"):
        transcribe.main(base + ["--device", "cpu", "--timestamps", "true",
                                "--target_type", "bpe"] + wavs)
