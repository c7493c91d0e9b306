"""The port's host library (``audio8_tpu_torch/csrc/*.cc`` through
``csrc/native.py``) against the JAX package's native library and the
plain Python versions, on the CPU.

* The library is built by ``g++`` from the port's own copies of the
  sources into ``build/audio8_tpu_torch/``, under a content hash; when it
  cannot be built the first call raises (no Python fallback).
* Edit distance on random token lists equals JAX's and the two-row DP.
* The prefix beam search, without an LM, with the ARPA text of
  ``tests/test_beam_differential.py`` (plain and gzipped) and with KenLM
  binaries written by the port's writer (PROBING, TRIE),
  gives JAX's n-best lists, and its 1-best equals the plain Python
  search scoring with the pure-Python ARPA LM. The LMs' scores agree
  within 1e-5. The JAX package's C++ reader takes a gzipped ARPA as
  text (it reads no n-gram from it); the port decompresses it first, so
  its gzipped case is held to JAX on the plain file.
* FLAC (mono, stereo; verbatim, fixed and constant subframes, written by
  ``tests.test_native.encode_flac``), SPHERE (linear PCM of 1, 2 and 4
  bytes in both byte orders, mu-law) and AIFF decode to JAX's arrays
  bitwise.
"""
import gzip
import os
import shutil
import struct

import numpy as np
import pytest

from audio8_tpu.csrc import native as jax_native
from audio8_tpu.data.audio import read_audio as jax_read_audio
from audio8_tpu.ops.beam import PrefixBeamSearch as JaxBeamSearch
from audio8_tpu_torch.ops.kenlm_bin import write_kenlm_binary
from audio8_tpu.utils import Offsets as JaxOffsets
from audio8_tpu_torch.csrc import build as port_build
from audio8_tpu_torch.csrc import native
from audio8_tpu_torch.data.audio import read_audio
from audio8_tpu_torch.ops.beam import (PrefixBeamSearch,
                                       _prefix_beam_search_py)
from audio8_tpu_torch.ops.lm import ArpaLM
from audio8_tpu_torch.ops.metrics import edit_distance, edit_distance_plain
from audio8_tpu_torch.utils import Offsets

from tests.test_beam_differential import ARPA
from tests.test_data import _write_sphere
from tests.test_native import encode_flac
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

LETTERS = ["A", "C", "D", "E", "G", "H", "O", "S", "T", "|"]


@pytest.fixture(autouse=True)
def _fairseq_offsets():
    """Both registries in the fairseq CTC layout (blank = 0)."""
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    Offsets.remap_fairseq_ctc()
    JaxOffsets.remap_fairseq_ctc()
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


def test_host_library_builds_from_the_port_sources():
    path = native.lib()._name
    assert path == port_build.host_library_path()
    assert os.path.dirname(path) == port_build.build_dir()
    hashed = [n for s in port_build.HOST_SOURCES
              for n in port_build.local_includes(s)]
    assert "lm_iface.h" in hashed and set(port_build.HOST_SOURCES) <= \
        set(hashed)
    for name in hashed:  # the port's own copies, not the JAX package's
        assert os.path.exists(os.path.join(port_build.CSRC, name))


def test_no_fallback_when_the_library_cannot_be_built(monkeypatch,
                                                      tmp_path):
    monkeypatch.setattr(port_build, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_loaded", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.edit_distance([1, 2], [2, 1])
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.flac_read(str(tmp_path / "x.flac"))


@pytest.mark.parametrize("seed", range(4))
def test_edit_distance_matches_jax_and_plain(seed):
    rng = np.random.default_rng(seed)
    words = ["CAT", "DOG", "SAT", "THE", "A"]
    for _ in range(40):
        a = rng.integers(0, 6, size=rng.integers(0, 25)).tolist()
        b = rng.integers(0, 6, size=rng.integers(0, 25)).tolist()
        want = edit_distance_plain(a, b)
        assert edit_distance(a, b) == want == jax_native.edit_distance(a, b)
        wa = [words[i % 5] for i in a]
        wb = [words[i % 5] for i in b]
        assert edit_distance(wa, wb) == edit_distance_plain(wa, wb)


def _log_probs(seed, t, v):
    x = np.random.default_rng(seed).normal(size=(t, v)).astype(
        np.float32) * 2.0
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _lm_file(tmp_path, kind):
    arpa = tmp_path / "lm.arpa"
    arpa.write_text(ARPA)
    if kind == "arpa":
        return str(arpa)
    if kind == "arpa.gz":
        with gzip.open(tmp_path / "lm.arpa.gz", "wt") as f:
            f.write(ARPA)
        return str(tmp_path / "lm.arpa.gz")
    out = str(tmp_path / f"lm.{kind}.bin")
    write_kenlm_binary(str(arpa), out, search=kind)
    return out


@pytest.mark.parametrize("lm", [None, "arpa", "arpa.gz", "probing", "trie"])
@pytest.mark.parametrize("seed", [1, 2])
def test_beam_search_matches_jax_and_plain(tmp_path, lm, seed):
    vocab = list(Offsets.VALUES) + LETTERS
    kw = dict(alpha=0.7, beta=1.5, beam=8)
    if lm is not None:
        kw["lm_file"] = _lm_file(tmp_path, lm)
    ours = PrefixBeamSearch(vocab, **kw)
    if lm == "arpa.gz":
        kw["lm_file"] = str(tmp_path / "lm.arpa")
    theirs = JaxBeamSearch(vocab, **kw)
    if lm is not None:
        assert isinstance(ours.lm, native.NativeKenLM if lm in (
            "probing", "trie") else native.NativeArpaLM)
    lp = _log_probs(seed, 120, len(vocab))
    lengths = np.asarray([120, 77])
    batch = np.stack([lp, _log_probs(seed + 10, 120, len(vocab))])
    got = ours.run(batch, lengths, n_best=4, return_ids=True)
    assert got == theirs.run(batch, lengths, n_best=4, return_ids=True)
    assert ours.run(batch, lengths, n_best=1) == theirs.run(batch, lengths,
                                                           n_best=1)
    plain_lm = ArpaLM(str(tmp_path / "lm.arpa")) if lm else None
    for b in range(2):
        plain = _prefix_beam_search_py(
            batch[b, :lengths[b]], ours.blank, ours.beam, ours.bar_off,
            ours.alpha, ours.beta, plain_lm, ours.vocab_list)
        assert got[b][0] == plain[0]
    if lm is not None:
        for word, ctx in [("CAT", ("THE",)), ("SAT", ("THE", "CAT")),
                          ("DOG", ()), ("ZEBRA", ("CAT",))]:
            assert abs(ours.lm.logp(word, ctx)
                       - plain_lm.logp(word, ctx)) < 1e-5


@pytest.mark.parametrize("channels,subframe", [(1, "verbatim"),
                                               (1, "fixed1"), (2, "verbatim"),
                                               (1, "constant")])
def test_flac_matches_jax(tmp_path, channels, subframe):
    rng = np.random.default_rng(channels)
    if subframe == "constant":
        x = np.full(700, -321, np.int16)
    else:
        x = (rng.normal(size=(1000, channels)) * 3000).astype(np.int16)
        x = x[:, 0] if channels == 1 else x
    p = str(tmp_path / "x.flac")
    with open(p, "wb") as f:
        f.write(encode_flac(x, subframe=subframe))
    data, sr, bps = native.flac_read(p)
    assert (sr, bps) == (16000, 16) and data.shape == x.shape
    want = jax_native.read_flac(p)
    assert np.array_equal(data, want[0]) and (sr, bps) == want[1:]
    np.testing.assert_array_equal(data, x.astype(np.int32))
    wav, sr = read_audio(p)
    jwav, jsr = jax_read_audio(p)
    assert wav.dtype == np.float32 and sr == jsr
    assert np.array_equal(wav, jwav)


def _aiff(path, pcm, bits):
    sr80 = struct.pack(">HQ", 16383 + 13, 16000 << 50)
    comm = struct.pack(">hIh", 1, len(pcm), bits) + sr80
    ssnd = struct.pack(">II", 0, 0) + pcm.tobytes()
    body = (b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(body)) + body)


@pytest.mark.parametrize("fmt", ["sph-le16", "sph-be16", "sph-i8",
                                 "sph-le32", "sph-ulaw", "aiff16", "aiff32"])
def test_sphere_and_aiff_match_jax(tmp_path, fmt):
    rng = np.random.default_rng(len(fmt))
    noise = rng.normal(size=400)
    path = str(tmp_path / ("x.sph" if fmt.startswith("sph") else "x.aiff"))
    if fmt == "sph-le16":
        _write_sphere(path, (noise * 8000).astype("<i2"))
    elif fmt == "sph-be16":
        _write_sphere(path, (noise * 8000).astype(">i2"), byte_fmt="10")
    elif fmt == "sph-i8":
        _write_sphere(path, (noise * 60).astype(np.int8), sample_bytes=1)
    elif fmt == "sph-le32":
        _write_sphere(path, (noise * 2 ** 25).astype("<i4"), sample_bytes=4)
    elif fmt == "sph-ulaw":
        _write_sphere(path, rng.integers(0, 256, 400).astype(np.uint8),
                      coding="ulaw")
    elif fmt == "aiff16":
        _aiff(path, (noise * 8000).astype(">i2"), 16)
    else:
        _aiff(path, (noise * 2 ** 25).astype(">i4"), 32)
    wav, sr = read_audio(path)
    jwav, jsr = jax_read_audio(path)
    assert sr == jsr == 16000 and wav.dtype == jwav.dtype == np.float32
    assert wav.shape == jwav.shape == (400,)
    assert np.array_equal(wav, jwav)
