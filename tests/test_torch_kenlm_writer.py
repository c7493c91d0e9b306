"""The port's KenLM binary writer (``audio8_tpu_torch/ops/kenlm_bin.py``)
and ``cli.build_binary`` against the JAX package's
``write_kenlm_binary``, on the CPU.

* Bytes equal to JAX's on the same ARPA: PROBING at ``-p`` 1.5 and 3.0,
  TRIE, QUANT_TRIE at 8/8 and 4/4 bits (4 bits forces kenlm's
  equal-count bins: more distinct values than centers), each with and
  without the vocab strings, on the Kneser-Ney trigram that
  ``cli.train_ngram`` trains from a seeded corpus and on the hand ARPA
  of ``tests/test_beam_differential.py``.
* ``cli.build_binary``'s file equals the function's for each layout,
  also run as ``python -m audio8_tpu_torch.cli.build_binary``.
* The port's native reader (``csrc/kenlm_bin.cc``) scores the lossless
  layouts as the ARPA within 1e-5, and a 4-bit QUANT_TRIE as JAX's
  Python reader scores the same file.
"""
import numpy as np
import pytest

from audio8_tpu.ops.kenlm_bin import KenLMBinaryLM
from audio8_tpu.ops.kenlm_bin import write_kenlm_binary as jax_write
from audio8_tpu_torch.cli import build_binary, train_ngram
from audio8_tpu_torch.csrc import native
from audio8_tpu_torch.ops import kenlm_bin
from audio8_tpu_torch.ops.lm import ArpaLM
from tests.test_beam_differential import ARPA
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

WORDS = [f"w{i}" for i in range(40)] + ["THE", "CAT", "<unk>"]
LAYOUTS = {
    "probing": dict(search="probing"),
    "probing_p3": dict(search="probing", probing_multiplier=3.0),
    "trie": dict(search="trie"),
    "quant8": dict(search="trie", quantize=True),
    "quant4": dict(search="trie", quantize=True, prob_bits=4,
                   backoff_bits=4),
}
CLI_FLAGS = {"probing": [], "probing_p3": ["-p", "3.0"], "trie": ["--trie"],
             "quant8": ["--trie", "-q"],
             "quant4": ["--trie", "-q", "--prob_bits", "4",
                        "--backoff_bits", "4"]}


@pytest.fixture(scope="module")
def kn_arpa(tmp_path_factory):
    """A trigram trained by the port's ``cli.train_ngram`` on 300 seeded
    sentences (Zipf-like word draws, so the counts spread)."""
    d = tmp_path_factory.mktemp("kn")
    rng = np.random.default_rng(0)
    p = 1.0 / np.arange(1, len(WORDS))
    p /= p.sum()
    lines = [" ".join(rng.choice(WORDS[:-1], size=rng.integers(3, 12), p=p))
             for _ in range(300)]
    (d / "train.wrd").write_text("\n".join(lines) + "\n")
    train_ngram.main(["--input", str(d / "train.wrd"), "--output",
                      str(d / "lm.arpa"), "--order", "3"])
    return str(d / "lm.arpa")


@pytest.fixture(scope="module")
def hand_arpa(tmp_path_factory):
    path = tmp_path_factory.mktemp("hand") / "lm.arpa"
    path.write_text(ARPA)
    return str(path)


@pytest.mark.parametrize("vocab_strings", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("which", ["kn", "hand"])
def test_bytes_equal_jax(tmp_path, kn_arpa, hand_arpa, which, layout,
                         vocab_strings):
    arpa = kn_arpa if which == "kn" else hand_arpa
    kw = dict(LAYOUTS[layout], write_vocab_strings=vocab_strings)
    ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
    info = kenlm_bin.write_kenlm_binary(arpa, str(ours), **kw)
    assert info == jax_write(arpa, str(theirs), **kw)
    assert ours.read_bytes() == theirs.read_bytes()
    if which == "kn":
        assert info["order"] == 3 and min(info["counts"]) > 10


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cli_equals_function(tmp_path, kn_arpa, layout):
    out = tmp_path / "cli.bin"
    assert build_binary.main([kn_arpa, str(out)] + CLI_FLAGS[layout]) == 0
    kenlm_bin.write_kenlm_binary(kn_arpa, str(tmp_path / "fn.bin"),
                                 **LAYOUTS[layout])
    assert out.read_bytes() == (tmp_path / "fn.bin").read_bytes()


@pytest.mark.parametrize("argv", [["-q"], ["--prob_bits", "4"],
                                  ["--trie", "-p", "2"], ["-p", "1.0"]])
def test_cli_refuses_ignored_flags(tmp_path, kn_arpa, argv):
    with pytest.raises(ValueError):
        build_binary.main([kn_arpa, str(tmp_path / "x.bin")] + argv)


def _queries(arpa):
    lm = ArpaLM(arpa)
    words = sorted({w for g in lm.ngrams for w in g}) + ["OOV"]
    rng = np.random.default_rng(1)
    return [(str(rng.choice(words)),
             tuple(str(w) for w in rng.choice(words, size=rng.integers(0, 3))))
            for _ in range(300)]


@pytest.mark.parametrize("layout", ["probing", "probing_p3", "trie",
                                    "quant4"])
def test_native_reader_scores(tmp_path, kn_arpa, layout):
    path = str(tmp_path / "lm.bin")
    kenlm_bin.write_kenlm_binary(kn_arpa, path, **LAYOUTS[layout])
    lm = native.NativeKenLM(path)
    ref = (KenLMBinaryLM(path) if layout == "quant4"
           else native.NativeArpaLM(kn_arpa))
    got = [lm.logp(w, c) for w, c in _queries(kn_arpa)]
    want = [ref.logp(w, c) for w, c in _queries(kn_arpa)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert len(set(np.round(got, 4))) > 20  # the queries hit many n-grams


def test_module_entry_point(tmp_path, hand_arpa):
    """``python -m audio8_tpu_torch.cli.build_binary`` writes the file."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "lm.trie"
    run = subprocess.run([sys.executable, "-m",
                          "audio8_tpu_torch.cli.build_binary", hand_arpa,
                          str(out), "--trie"], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    kenlm_bin.write_kenlm_binary(hand_arpa, str(tmp_path / "fn.trie"),
                                 search="trie")
    assert out.read_bytes() == (tmp_path / "fn.trie").read_bytes()
