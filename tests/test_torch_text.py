"""The port's text host code against the JAX package's: ``learn_bpe``,
``SubwordBPE``, ``BPEVectorizer`` and ``read_vocab_file`` give the same
merges, pieces and ids, and the ``learn_bpe`` and ``wrd2bpe`` entry
points write byte-equal files from the same inputs.
"""
import os

import numpy as np
import pytest

from audio8_tpu.cli import learn_bpe as jax_learn_cli
from audio8_tpu.cli import wrd2bpe as jax_wrd2bpe_cli
from audio8_tpu.models import text as jax_text
from audio8_tpu_torch.cli import learn_bpe as learn_cli
from audio8_tpu_torch.cli import wrd2bpe as wrd2bpe_cli
from audio8_tpu_torch.models import text
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

WORDS = ["THE", "CAT", "SAT", "ON", "A", "MAT", "THAT", "CATS", "THEN",
         "SATAN", "MATTER", "AT", "HAT", "THAN", "TO", "TOTAL"]


def _lines(seed, n):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(len(WORDS)))
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(1, 9)), p=p))
            for _ in range(n)]


@pytest.fixture
def corpus(tmp_path):
    for split, seed, n in (("train", 0, 60), ("valid", 1, 12)):
        with open(tmp_path / f"{split}.wrd", "w") as f:
            f.writelines(line + "\n" for line in _lines(seed, n))
        (tmp_path / f"{split}.tsv").write_text(str(tmp_path) + "\n")
    return tmp_path


@pytest.mark.parametrize("merges,min_freq", [(5, 2), (40, 2), (500, 1)])
def test_learn_bpe_matches_jax(merges, min_freq):
    counts = {}
    for line in _lines(2, 80):
        for w in line.split():
            counts[w] = counts.get(w, 0) + 1
    want = jax_text.learn_bpe(counts, merges, min_freq)
    assert text.learn_bpe(counts, merges, min_freq) == want
    assert want  # the table learned something


@pytest.mark.parametrize("merges,min_freq", [(2000, 2), (3000, 1)])
def test_learn_bpe_matches_jax_on_a_large_table(merges, min_freq):
    """2 324 Zipf-weighted random words: thousands of merges, many of
    them between pairs of equal count (at min_frequency 1, the words
    seen once), so the heap's order of ties is held to JAX's scan."""
    rng = np.random.default_rng(5)
    letters = list("ETAONIHSRDLUMWCFGYPBVKXJQZ")
    w = 1.0 / (np.arange(len(letters)) + 3.0)
    words = sorted({"".join(rng.choice(letters, size=int(rng.integers(2, 11)),
                                       p=w / w.sum())) for _ in range(3000)})
    zipf = 1.0 / np.arange(1, len(words) + 1)
    counts = {}
    for i in rng.choice(len(words), size=20_000, p=zipf / zipf.sum()):
        counts[words[i]] = counts.get(words[i], 0) + 1
    want = jax_text.learn_bpe(counts, merges, min_freq)
    assert len(want) == merges
    assert text.learn_bpe(counts, merges, min_freq) == want


def test_subword_bpe_and_vectorizer_match_jax(tmp_path):
    counts = {w: i + 1 for i, w in enumerate(WORDS)}
    codes = str(tmp_path / "codes")
    text.write_bpe_codes(codes, text.learn_bpe(counts, 12))
    jbpe, bpe = jax_text.SubwordBPE(codes), text.SubwordBPE(codes)
    for w in WORDS + ["CATHAT", "Q", ""]:
        assert bpe.segment_word(w) == jbpe.segment_word(w)
    vocab = tmp_path / "dict.bpe.txt"
    pieces = sorted({p for w in WORDS for p in bpe.segment_word(w)})
    vocab.write_text("".join(f"{p} 1\n" for p in pieces[:-2]))
    assert text.read_vocab_file(str(vocab)) == jax_text.read_vocab_file(
        str(vocab))
    jvec = jax_text.BPEVectorizer(codes, str(vocab), ["<s>"], ["</s>"])
    vec = text.BPEVectorizer(codes, str(vocab), ["<s>"], ["</s>"])
    for line in _lines(3, 10) + ["CATHAT Q"]:
        assert vec.segment(line.split()) == jvec.segment(line.split())
        got, want = vec.run(line.split()), jvec.run(line.split())
        assert got.dtype == want.dtype and (got == want).all()


def test_cli_outputs_are_byte_equal(corpus):
    """``learn_bpe`` (codes and vocabulary), then ``wrd2bpe`` (dict and
    .bpe transcripts) from both packages on the same corpus."""
    outs = {}
    for name, learn, wrd2bpe in (("jax", jax_learn_cli, jax_wrd2bpe_cli),
                                 ("port", learn_cli, wrd2bpe_cli)):
        d = corpus / name
        os.makedirs(d)
        for f in ("train.wrd", "valid.wrd", "train.tsv", "valid.tsv"):
            (d / f).write_bytes((corpus / f).read_bytes())
        learn.main(["--input", str(d / "train.wrd"), "--output",
                    str(d / "codes.bpe"), "--num_merges", "8",
                    "--write_vocab", str(d / "vocab.bpe")])
        wrd2bpe.main(["--root_dir", str(d), "--train_dataset", "train.tsv",
                      "--valid_dataset", "valid.tsv", "--subword_model_file",
                      str(d / "codes.bpe"), "--subword_vocab_file",
                      str(d / "vocab.bpe"), "--emit_end_tok", "</s>"])
        outs[name] = {f: (d / f).read_bytes() for f in (
            "codes.bpe", "vocab.bpe", "dict.bpe.txt", "train.bpe",
            "valid.bpe")}
    assert outs["port"] == outs["jax"]
    assert outs["port"]["train.bpe"].count(b"@@") > 0
