"""Training batches (the single-process slice of
``audio8_tpu/data/datasets.py``).

Same batch composition and seed semantics as the JAX package, so both
packages draw the same batches from the same manifest and seed.
Supervised (``AudioTextLetterDataset``): batches come from
descending-length order with a seeded shuffled tie-break
(``batch_by_size``), each pads its audio to a multiple (or a length grid)
and its batch size up a geometric grid (``snap_batch_size``; added rows
have zero signal and lengths), and the epoch order reshuffles from a
seeded ``random.Random``. Pretraining (``AudioFileDataset``,
``BucketingAudioDataset``): dense min-cropped (B, T) batches with no
padding. Supervised training batches may be augmented by speed
perturbation and additive noise, drawn in the sequential batch plan as
the JAX package draws them. Left out: multi-process sharding
(``row_shard``, ``num_shards``, ``batch_multiple``) and ``lane_align``
(TPU tiling).
"""
from __future__ import annotations

import concurrent.futures
import logging
import math
import os
import queue
import random
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from audio8_tpu_torch.data.audio import (AudioResampleReader,
                                         SoundfileAudioReader,
                                         speed_perturb_wav)
from audio8_tpu_torch.utils import Offsets

logger = logging.getLogger(__name__)


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


# batch-size grid: ratio <= ~1.25, a bounded set of batch shapes
B_GRID = [1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 40, 48, 56,
          64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384, 448, 512,
          640, 768, 896, 1024]


def snap_batch_size(b: int, multiple: int = 1,
                    grid: Sequence[int] = B_GRID) -> int:
    """Smallest grid entry >= b that is a multiple of ``multiple``; plain
    round-up past the grid."""
    target = _round_up(b, max(multiple, 1))
    for g in grid:
        if g >= target and g % max(multiple, 1) == 0:
            return g
    return target


def snap_batch_size_down(b: int, multiple: int = 1,
                         grid: Sequence[int] = B_GRID) -> int:
    """Largest grid entry <= b that is a multiple of ``multiple`` (0 if
    none): the dense pretraining stream carries leftover rows into the
    next batch instead of padding."""
    best = 0
    m = max(multiple, 1)
    for g in grid:
        if g <= b and g % m == 0:
            best = g
    return best


def find_fit(v: int, fits: Sequence[int]) -> int:
    """Largest bucket <= v, 0 if none."""
    best = 0
    for f in fits:
        if f <= v:
            best = max(best, f)
    return best


def batch_by_size(indices, sizes, max_tokens=None,
                  max_sentences=128) -> List[List[int]]:
    """Token-budget batching over length-ordered indices: a batch closes
    when it holds ``max_sentences``, or when admitting the next sample
    would push ``(num_sentences + 1) * running_max_len`` past
    ``max_tokens``."""
    use_tokens = max_tokens is not None and max_tokens > 0
    use_sentences = max_sentences is not None and max_sentences > 0
    batches: List[List[int]] = []
    cur: List[int] = []
    cur_max = 0
    for idx in indices:
        n = sizes[idx]
        if use_tokens and n > max_tokens:
            raise AssertionError(
                f"sentence at index {idx} of size {n} exceeds max_tokens "
                f"limit of {max_tokens}!")
        new_max = max(cur_max, n)
        full = cur and (
            (use_sentences and len(cur) == max_sentences)
            or (use_tokens and (len(cur) + 1) * new_max > max_tokens))
        if full:
            batches.append(cur)
            cur, new_max = [], n
        cur.append(idx)
        cur_max = new_max
    if cur:
        batches.append(cur)
    return batches


class AudioTextLetterDataset:
    """(audio, transcript) batches from a TSV manifest (first line the
    audio root, then ``relative_path\\tnum_samples``) zipped with the
    sibling ``.ltr``/``.wrd``/``.bpe`` transcript file.

    ``speed_perturb``: speed factors (e.g. ``(0.9, 1.0, 1.1)``); each
    utterance draws one per read and is resampled by
    ``data.audio.speed_perturb_wav``; the audio pad scales by the slowest
    factor's stretch, transcripts are unchanged. ``noise_mixer``: a
    ``data.audio.NoiseMixer`` (any length-keeping ``(wav, rng) -> wav``)
    applied after the speed change, with one child ``default_rng`` per
    row. Both are for training sets only."""

    TGT_LETTER = "ltr"
    TGT_BPE = "bpe"
    TGT_WRD = "wrd"

    def __init__(self, tsv_file: str, vec, target_tokens_per_batch: int,
                 max_src_length: Optional[int] = None, shuffle: bool = True,
                 max_dst_length: int = 1200, tgt_type: str = TGT_LETTER,
                 input_sample_rate: int = 16_000,
                 target_sample_rate: int = 16_000, is_infinite: bool = True,
                 max_sentences: int = 128, pad_to_multiple: int = 16_000,
                 text_pad_multiple: int = 64,
                 length_grid: Optional[Sequence[int]] = None,
                 seed: int = 0, read_workers: int = 4,
                 speed_perturb: Sequence[float] = (), noise_mixer=None):
        self.sample_factor = target_sample_rate / input_sample_rate
        self.reader = (AudioResampleReader(self.sample_factor)
                       if input_sample_rate != target_sample_rate
                       else SoundfileAudioReader())
        self.vec = vec
        self.max_src_length = max_src_length
        self.max_dst_length = max_dst_length
        self.tgt_type = tgt_type
        self.shuffle = shuffle
        self.is_infinite = is_infinite
        self.max_elems_per_batch = target_tokens_per_batch
        self.max_sentences = max_sentences
        self.pad_to_multiple = pad_to_multiple
        self.text_pad_multiple = text_pad_multiple
        self.length_grid = sorted(length_grid) if length_grid else None
        self.speed_perturb = [float(f) for f in speed_perturb]
        if any(f <= 0 for f in self.speed_perturb):
            raise ValueError(f"speed factors must be > 0: {speed_perturb}")
        self.noise_mixer = noise_mixer
        # a factor f divides the duration by f: pads fit the slowest one
        self._max_stretch = (max(1.0 / min(self.speed_perturb), 1.0)
                             if self.speed_perturb else 1.0)
        self._rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self._pool = (concurrent.futures.ThreadPoolExecutor(read_workers)
                      if read_workers > 1 else None)
        self._read_tsv_file(tsv_file)

    def get_or_unk(self, t: str) -> int:
        return self.vec.vocab.get(t, Offsets.UNK)

    def _read_tsv_file(self, tsv_file: str) -> None:
        self.files: List[str] = []
        self.sizes: List[int] = []
        self.tokens: List[np.ndarray] = []
        transcription_file = os.path.splitext(tsv_file)[0] + "." + \
            self.tgt_type
        with open(tsv_file) as f, open(transcription_file) as rf:
            directory = f.readline().strip()
            for audio, transcription in zip(f, rf):
                basename, x_length = audio.split("\t")
                x_length = int(int(x_length) * self.sample_factor)
                if self.max_src_length and x_length > self.max_src_length:
                    continue
                text = transcription.split()
                if self.tgt_type != self.TGT_BPE:
                    tokens = self.vec.run(text)
                else:
                    go = [self.vec.vocab[t] for t in self.vec.emit_begin_tok]
                    end = [self.vec.vocab[t] for t in self.vec.emit_end_tok]
                    tokens = np.array(go + [self.get_or_unk(t) for t in text]
                                      + end, dtype=np.int32)
                self.files.append(os.path.join(directory, basename))
                self.sizes.append(x_length)
                self.tokens.append(tokens)
        keys = (self._np_rng.permutation(len(self.files)) if self.shuffle
                else np.arange(len(self.files)))
        # descending length, shuffled ties
        indices = np.lexsort((keys, self.sizes))[::-1]
        self.batches = batch_by_size(indices, self.sizes,
                                     self.max_elems_per_batch,
                                     max_sentences=self.max_sentences)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for plan in self.batch_plans():
            yield self.materialize(plan)

    def batch_plans(self) -> Iterator[dict]:
        """Sequential batch plans (rows and shapes, no decoding): all the
        stream's randomness is drawn here, so ``materialize`` may run on
        worker threads without changing the stream."""
        order = list(range(len(self.batches)))
        while True:
            if self.shuffle:
                self._rng.shuffle(order)
            for rd in order:
                yield self._plan_batch(self.batches[rd])
            if not self.is_infinite:
                return

    def _plan_batch(self, batch: Sequence[int]) -> dict:
        n_real = len(batch)
        max_audio = int(math.ceil(max(self.sizes[idx] for idx in batch)
                                  * self._max_stretch))
        if self.length_grid:
            fits = [g for g in self.length_grid if g >= max_audio]
            t_audio = fits[0] if fits else _round_up(max_audio,
                                                     self.pad_to_multiple)
        else:
            t_audio = _round_up(max_audio, self.pad_to_multiple)
        max_text = max(min(len(self.tokens[idx]), self.max_dst_length)
                       for idx in batch)
        t_text = min(_round_up(max_text, self.text_pad_multiple),
                     _round_up(self.max_dst_length, self.text_pad_multiple))
        # the augmentations' draws, in the JAX package's order: the speed
        # factors, then one child generator per row for the noise
        factors = (self._np_rng.choice(self.speed_perturb, size=n_real)
                   if self.speed_perturb else None)
        noise_rngs = ([np.random.default_rng(s) for s in
                       self._np_rng.integers(0, 2**63, size=n_real)]
                      if self.noise_mixer is not None else None)
        return {"rows": list(batch), "files": [self.files[i] for i in batch],
                "factors": factors, "noise_rngs": noise_rngs,
                "b_local": snap_batch_size(n_real), "t_audio": t_audio,
                "t_text": t_text, "n_real": n_real}

    def materialize(self, plan: dict) -> Dict[str, np.ndarray]:
        """Decode, augment (speed, then noise) and pad one planned
        batch."""
        rows, files = plan["rows"], plan["files"]
        factors, noise_rngs = plan["factors"], plan["noise_rngs"]
        b_local, t_audio, t_text = (plan["b_local"], plan["t_audio"],
                                    plan["t_text"])

        def read(i_path):
            i, path = i_path
            wav = self.reader.read(path, self.max_src_length or -1).squeeze()
            if factors is not None and factors[i] != 1.0:
                wav = speed_perturb_wav(wav, float(factors[i]))
            if noise_rngs is not None:
                wav = self.noise_mixer(wav, noise_rngs[i])
            return wav

        audios = (list(self._pool.map(read, enumerate(files)))
                  if self._pool is not None
                  else [read(ip) for ip in enumerate(files)])
        signal = np.zeros((b_local, t_audio), np.float32)
        audio_lengths = np.zeros(b_local, np.int32)
        token_ids = np.full((b_local, t_text), Offsets.PAD, np.int32)
        text_lengths = np.zeros(b_local, np.int32)
        for i, idx in enumerate(rows):
            a = audios[i][:t_audio]
            audio_lengths[i] = len(a)
            signal[i, :len(a)] = a
            toks = self.tokens[idx][: self.max_dst_length]
            text_lengths[i] = len(toks)
            token_ids[i, :len(toks)] = toks
        return {"signal": signal, "signal_lengths": audio_lengths,
                "token_ids": token_ids, "token_lengths": text_lengths,
                "files": files, "num_real": plan["n_real"], "row_offset": 0}


class AudioFileDataset:
    """Unsupervised pretraining stream: an infinite file order reshuffled
    each epoch from a seeded ``random.Random``, and dense min-cropped (B, T)
    float32 batches with no padding.

    Samples accumulate (across epoch boundaries) until ``rows * shortest``
    reaches the sample budget; the batch takes the largest ``B_GRID`` size
    that fits, the rest carry into the next batch, and the sample that
    triggered the batch is discarded (the reference's quirk). Every row is
    cropped to the batch's shortest predicted length, snapped down to
    ``length_grid`` when one is given."""

    def __init__(self, manifest: str, max_length: int,
                 target_tokens_per_batch: int, shuffle: bool = True,
                 min_length: int = 0, input_sample_rate: int = 16_000,
                 target_sample_rate: int = 16_000,
                 length_grid: Optional[Sequence[int]] = None, seed: int = 0,
                 read_workers: int = 4):
        self.sample_factor = target_sample_rate / input_sample_rate
        self.reader = (AudioResampleReader(self.sample_factor)
                       if input_sample_rate != target_sample_rate
                       else SoundfileAudioReader())
        self.max_length = max_length
        self.shuffle = shuffle
        self.target_tokens_per_batch = target_tokens_per_batch
        self.length_grid = sorted(length_grid) if length_grid else None
        self._rng = random.Random(seed)
        self._pool = (concurrent.futures.ThreadPoolExecutor(read_workers)
                      if read_workers > 1 else None)
        self._read_manifest(manifest, min_length)

    def _read_manifest(self, manifest: str, min_length: int) -> None:
        skipped = 0
        self.files: List[Tuple[str, int]] = []
        with open(manifest) as f:
            directory = f.readline().strip()
            for line in f:
                items = line.strip().split("\t")
                sz = int(int(items[1]) * self.sample_factor)
                if min_length is not None and sz < min_length:
                    skipped += 1
                    continue
                self.files.append((os.path.join(directory, items[0]), sz))
        logger.info("loaded %d, skipped %d samples", len(self.files), skipped)

    def _snap(self, length: int) -> int:
        if not self.length_grid:
            return length
        snapped = find_fit(length, self.length_grid)
        return snapped if snapped > 0 else length

    def _index_stream(self) -> Iterator[int]:
        if not self.files:
            raise RuntimeError("empty manifest")
        while True:
            order = list(range(len(self.files)))
            if self.shuffle:
                self._rng.shuffle(order)
            yield from order

    def _compose(self, stream) -> Iterator[Tuple[List[int], int]]:
        """(row file indices, crop length) from manifest lengths alone."""
        samples: List[Tuple[int, int]] = []  # (file index, predicted length)
        min_len = self.max_length
        for idx in stream:
            predlen = min(self.files[idx][1], self.max_length)
            if len(samples) * min_len >= self.target_tokens_per_batch:
                b = snap_batch_size_down(len(samples))
                if b > 0:
                    emitted, samples = samples[:b], samples[b:]
                    yield ([i for i, _ in emitted],
                           self._snap(min(p for _, p in emitted)))
                    min_len = min([p for _, p in samples] + [self.max_length])
                    continue  # the triggering sample is discarded
            samples.append((idx, predlen))
            min_len = min(min_len, predlen)

    def __iter__(self):
        for plan in self.batch_plans():
            yield self.materialize(plan)

    def batch_plans(self) -> Iterator[Tuple[List[int], int]]:
        """Sequential (rows, crop length) plans; all the stream's
        randomness is drawn here, so ``materialize`` may run on worker
        threads without changing the stream."""
        yield from self._compose(self._index_stream())

    def materialize(self, plan: Tuple[List[int], int]) -> np.ndarray:
        rows, t = plan
        paths = [self.files[i][0] for i in rows]

        def read(path):
            return np.asarray(self.reader.read(path, self.max_length)).squeeze()

        audios = (list(self._pool.map(read, paths)) if self._pool is not None
                  else [read(p) for p in paths])
        batch = np.zeros((len(rows), t), np.float32)
        for i, a in enumerate(audios):
            a = a[:t]  # the manifest length is a prediction
            batch[i, :len(a)] = a
        return batch


class BucketingAudioDataset(AudioFileDataset):
    """Each file goes to the largest bucket <= its length (shorter files
    are skipped); batches are fixed-size chunks per bucket, emitted as the
    shuffled stream fills them, cropped to the bucket length."""

    def __init__(self, buckets, manifest, max_length, target_tokens_per_batch,
                 shuffle=True, min_length=0, seed=0, read_workers=4,
                 input_sample_rate=16_000, target_sample_rate=16_000):
        self.bucket_lengths = sorted(buckets)
        super().__init__(manifest, max_length, target_tokens_per_batch,
                         shuffle=shuffle, min_length=min_length, seed=seed,
                         read_workers=read_workers,
                         input_sample_rate=input_sample_rate,
                         target_sample_rate=target_sample_rate)

    def _read_manifest(self, manifest: str, _min_length) -> None:
        skipped = num_samples = 0
        self.files = []
        self.bucket_of: List[int] = []
        with open(manifest) as f:
            directory = f.readline().strip()
            for line in f:
                num_samples += 1
                items = line.strip().split("\t")
                sz = int(int(items[1]) * self.sample_factor)
                bucket = find_fit(sz, self.bucket_lengths)
                if bucket == 0:
                    skipped += 1
                    continue
                self.files.append((os.path.join(directory, items[0]), sz))
                self.bucket_of.append(bucket)
        logger.info("Num samples %d, skipped %d", num_samples, skipped)

    def _rows_per(self, bucket: int) -> int:
        return max(snap_batch_size_down(
            max(self.target_tokens_per_batch // bucket, 1)), 1)

    def _compose(self, stream) -> Iterator[Tuple[List[int], int]]:
        pending: Dict[int, List[int]] = {}
        for idx in stream:
            bucket = self.bucket_of[idx]
            lst = pending.setdefault(bucket, [])
            lst.append(idx)
            if len(lst) >= self._rows_per(bucket):
                yield list(lst), bucket
                lst.clear()


class PrefetchLoader:
    """Background prefetcher: plans drawn in order, batches materialized
    on ``num_workers`` threads, emitted in order, so the stream equals
    ``iter(dataset)`` whatever the worker count."""

    _DONE = object()

    def __init__(self, dataset, num_workers: int = 2, prefetch: int = 4):
        self.dataset = dataset
        self.num_workers = max(1, min(int(num_workers), os.cpu_count() or 1))
        self.prefetch = max(prefetch, 1)

    def __iter__(self):
        if self.num_workers > 1:
            yield from self._parallel_iter()
        else:
            yield from self._single_iter()

    def _parallel_iter(self):
        from collections import deque

        depth = self.num_workers + self.prefetch
        pending: deque = deque()
        pool = concurrent.futures.ThreadPoolExecutor(self.num_workers)
        try:
            for plan in self.dataset.batch_plans():
                pending.append(pool.submit(self.dataset.materialize, plan))
                if len(pending) >= depth:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()
            pool.shutdown(wait=False)

    def _single_iter(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for item in self.dataset:
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            finally:
                try:
                    q.put(self._DONE, timeout=0.5)
                except queue.Full:
                    pass

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    return
                yield item
        finally:
            stop.set()
