"""The datasets' row-block contract (data parallelism): with ``row_shard``
over 1, 2 and 3 shards the port's ``AudioTextLetterDataset``,
``AudioFileDataset`` and ``BucketingAudioDataset`` give the JAX
datasets' batches: each shard's block of rows, ``row_offset`` and the
global ``num_real``; the blocks of all shards together are the global
batch (padding rows at its tail), and the round-robin striping without
``row_shard`` is JAX's too."""
import numpy as np
import pytest
from scipy.io import wavfile

from audio8_tpu.data.datasets import AudioFileDataset as JaxFileDataset
from audio8_tpu.data.datasets import AudioTextLetterDataset as JaxDataset
from audio8_tpu.data.datasets import \
    BucketingAudioDataset as JaxBucketingDataset
from audio8_tpu.models.text import TextVectorizer as JaxVectorizer
from audio8_tpu.models.text import read_vocab_list as jax_vocab
from audio8_tpu_torch.data.datasets import (AudioFileDataset,
                                            AudioTextLetterDataset,
                                            BucketingAudioDataset)
from audio8_tpu_torch.models.text import TextVectorizer, read_vocab_list
from audio8_tpu_torch.parallel.sharding import row_block
from tests.test_torch_text_lm import default_offsets  # noqa: F401
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_corpus")
    rng = np.random.default_rng(0)
    letters = ["|", "A", "B", "C", "D"]
    (root / "dict.ltr.txt").write_text("".join(f"{c} 1\n" for c in letters))
    with open(root / "train.tsv", "w") as tf, \
            open(root / "train.ltr", "w") as lf:
        tf.write(str(root) + "\n")
        for i in range(13):
            n = int(rng.integers(3000, 20000))
            wavfile.write(str(root / f"{i}.wav"), 16000,
                          (rng.normal(size=n) * 3000).astype(np.int16))
            tf.write(f"{i}.wav\t{n}\n")
            lf.write(" ".join(rng.choice(letters, size=int(rng.integers(
                1, 9)))) + " |\n")
    return root


def _letter_sets(corpus, shard, shards, row_shard):
    tsv, vocab_file = str(corpus / "train.tsv"), str(corpus /
                                                     "dict.ltr.txt")
    kw = dict(pad_to_multiple=4000, text_pad_multiple=8, seed=3,
              read_workers=1, shard_index=shard, num_shards=shards,
              row_shard=row_shard, max_sentences=5)
    jvocab = {v: i for i, v in enumerate(jax_vocab(vocab_file))}
    vocab = {v: i for i, v in enumerate(read_vocab_list(vocab_file))}
    return (iter(AudioTextLetterDataset(tsv, TextVectorizer(vocab), 40000,
                                        **kw)),
            iter(JaxDataset(tsv, JaxVectorizer(jvocab), 40000,
                            lane_align=False, **kw)))


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_letter_dataset_row_blocks_match_jax(corpus, shards):
    streams = [_letter_sets(corpus, r, shards, True) for r in range(shards)]
    for _ in range(7):  # past one epoch: the reshuffle must match too
        blocks = []
        for r, (ours, theirs) in enumerate(streams):
            a, b = next(ours), next(theirs)
            assert a["files"] == b["files"]
            assert a["num_real"] == b["num_real"]
            assert a["row_offset"] == b["row_offset"]
            for k in ("signal", "signal_lengths", "token_ids",
                      "token_lengths"):
                assert np.array_equal(a[k], b[k]), k
            blocks.append(a)
        b_local = blocks[0]["signal"].shape[0]
        b_global = b_local * shards
        assert b_global % shards == 0
        for r, a in enumerate(blocks):
            lo, n_local, n_here = row_block(a["num_real"], b_global, r,
                                            shards)
            assert (a["row_offset"], a["signal"].shape[0]) == (lo, n_local)
            assert int((a["signal_lengths"] > 0).sum()) == n_here
            assert len(a["files"]) == n_here
        # the padding rows sit at the global tail
        lengths = np.concatenate([a["signal_lengths"] for a in blocks])
        n_real = blocks[0]["num_real"]
        assert (lengths[:n_real] > 0).all() and (lengths[n_real:] == 0).all()


def test_letter_dataset_striping_matches_jax(corpus):
    for shard in range(2):
        ours, theirs = _letter_sets(corpus, shard, 2, False)
        for _ in range(4):
            a, b = next(ours), next(theirs)
            assert a["files"] == b["files"] and a["row_offset"] == 0
            assert np.array_equal(a["signal"], b["signal"])


@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("bucketing", [False, True])
def test_pretraining_datasets_row_blocks_match_jax(corpus, shards,
                                                   bucketing):
    """The min-crop (or bucket) and the rows are the global batch's; each
    shard reads its block."""
    tsv = str(corpus / "train.tsv")

    def make(cls, r, **kw):
        kw = dict(dict(num_shards=shards, row_shard=True, shard_index=r,
                       seed=5, read_workers=1), **kw)
        if bucketing:
            return iter(cls([4000, 8000, 12000], tsv, 20000, 24000, **kw))
        return iter(cls(tsv, 20000, 30000, **kw))

    ours_cls, theirs_cls = ((BucketingAudioDataset, JaxBucketingDataset)
                            if bucketing else
                            (AudioFileDataset, JaxFileDataset))
    ours = [make(ours_cls, r) for r in range(shards)]
    theirs = [make(theirs_cls, r) for r in range(shards)]
    # one process composing the same global batches
    whole = make(ours_cls, 0, num_shards=1, row_shard=False,
                 batch_multiple=shards)
    for _ in range(6):
        blocks = [next(o) for o in ours]
        for a, t in zip(blocks, theirs):
            assert np.array_equal(a, next(t))
        assert len({a.shape for a in blocks}) == 1
        assert np.array_equal(np.concatenate(blocks), next(whole))
