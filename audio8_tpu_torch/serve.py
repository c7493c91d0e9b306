"""Serving helpers of the port (``audio8_tpu/serve.py``): cross-request
chunk batching, long-audio transcription through fixed-size chunks and
incremental (streaming) transcription.

:class:`ChunkedTranscriber` slices a waveform into ``chunk_samples``
windows with ``context_samples`` of overlap on each side, runs the
acoustic forward on ``(batch, chunk)`` blocks, drops the margin frames of
interior chunks and stitches the per-frame log-probs; the geometry is the
JAX package's, so both packages cut a waveform at the same frames.
:class:`StreamingTranscriber` produces the same stitched log-probs from
audio fed as it arrives, holding O(chunk) samples. :class:`MicroBatcher`
packs chunk rows from concurrent callers into shared dispatches. Blocks
reach the model as torch tensors on its device. Text decodes greedily,
or through a ``ops.beam.PrefixBeamSearch`` on the host.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from audio8_tpu_torch.config import conv_output_length
from audio8_tpu_torch.ops.ctc import greedy_collapse
from audio8_tpu_torch.ops.metrics import postproc_letters
from audio8_tpu_torch.utils import Offsets


def run_block(forward: Callable, segs: List[np.ndarray], batch: int,
              chunk: int, device: torch.device) -> List[np.ndarray]:
    """Pad up to ``batch`` rows of at most ``chunk`` samples into one
    ``(batch, chunk)`` block (filler rows have length 0), run ``forward``
    on ``device`` and return each real row's ``(T', V)`` log-probs."""
    sig = np.zeros((batch, chunk), np.float32)
    lens = np.zeros((batch,), np.int64)
    for j, seg in enumerate(segs):
        sig[j, :len(seg)] = seg
        lens[j] = len(seg)
    lp, _ = forward(torch.from_numpy(sig).to(device),
                    torch.from_numpy(lens).to(device))
    lp = lp.float().cpu().numpy()
    return [lp[j] for j in range(len(segs))]


class MicroBatcher:
    """Cross-request chunk batching: one dispatcher thread packs up to
    ``batch_size`` pending rows from any caller into one forward on
    ``device`` and hands each caller its row back.

    A lone row waits at most ``max_wait_ms`` for company; rows already
    queued pack at once. The dispatcher is the only thread that calls
    ``forward(signal (B, chunk) f32, lengths (B,) int64) -> (log_probs
    (B, T', V), frames (B,))``."""

    def __init__(self, forward: Callable, chunk_samples: int,
                 batch_size: int = 4, max_wait_ms: float = 2.0,
                 device: torch.device | str = "cpu"):
        self.forward = forward
        self.chunk = int(chunk_samples)
        self.batch = int(batch_size)
        self.max_wait = max_wait_ms / 1e3
        self.device = torch.device(device)
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self.dispatches = 0  # forwards run
        self.rows = 0        # rows served
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="a8t-microbatcher")
        self._thread.start()

    def submit_many(self, segs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Enqueue chunk rows (each 1-D, len <= chunk); block until all
        are served; return per-row ``(T_chunk', V)`` log-probs."""
        items = []
        for seg in segs:
            if len(seg) > self.chunk:
                raise ValueError(f"row of {len(seg)} > chunk {self.chunk}")
            items.append([np.asarray(seg, np.float32), None,
                          threading.Event()])
        for it in items:
            self._q.put(it)
        for it in items:
            it[2].wait()
            if isinstance(it[1], BaseException):
                raise it[1]
        return [it[1] for it in items]

    def submit(self, seg: np.ndarray) -> np.ndarray:
        return self.submit_many([seg])[0]

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=5)

    def _loop(self) -> None:
        while True:
            first = self._q.get()
            if first is None:
                return
            block = [first]
            deadline = time.monotonic() + self.max_wait
            while len(block) < self.batch:
                try:
                    nxt = self._q.get(
                        timeout=max(deadline - time.monotonic(), 0))
                except queue.Empty:
                    break
                if nxt is None:
                    self._drain(block, None)
                    return
                block.append(nxt)
            try:
                rows = run_block(self.forward, [it[0] for it in block],
                                 self.batch, self.chunk, self.device)
            except Exception as e:  # propagate to every waiting caller
                self._drain(block, e)
                continue
            self.dispatches += 1
            self.rows += len(block)
            for it, row in zip(block, rows):
                it[1] = row
                it[2].set()

    @staticmethod
    def _drain(block, exc) -> None:
        err = exc or RuntimeError("MicroBatcher closed")
        for it in block:
            it[1] = err
            it[2].set()


class ChunkedTranscriber:
    """Stitched log-probs + transcription for arbitrarily long audio,
    with the forward on ``device``. Chunk geometry is in samples."""

    def __init__(self, forward: Callable, conv_features: Sequence,
                 chunk_samples: int = 480_000, context_samples: int = 32_000,
                 batch_size: int = 4, batcher: Optional[MicroBatcher] = None,
                 device: torch.device | str = "cpu"):
        if chunk_samples <= 2 * context_samples:
            raise ValueError("chunk must exceed twice the context margin")
        if batcher is not None and batcher.chunk != int(chunk_samples):
            raise ValueError("batcher chunk size mismatch")
        self.forward = forward
        self.batcher = batcher
        self.device = torch.device(device)
        self.chunk = int(chunk_samples)
        self.context = int(context_samples)
        self.batch = int(batch_size)
        self.conv_features = list(conv_features)
        self.frames_per_chunk = conv_output_length(self.chunk,
                                                   self.conv_features)
        # the product of the strides, not chunk // frames: the receptive
        # field eats part of a frame and the ratio would misplace seams
        self.stride = 1
        for _, _, s in self.conv_features:
            self.stride *= s
        self.margin_frames = self.context // self.stride
        self.core = self.chunk - 2 * self.context
        # chunk starts stay frame-aligned: local frame j of the chunk at
        # sample s is global frame s // stride + j
        self.core -= self.core % self.stride
        deficit = self.chunk // self.stride - self.frames_per_chunk
        if self.margin_frames <= deficit:
            raise ValueError(
                f"context_samples too small: margin {self.margin_frames} "
                f"frames must exceed the receptive-field deficit {deficit}")

    def _chunk_starts(self, n: int) -> List[int]:
        if n <= self.chunk:
            return [0]
        return list(range(0, n - 2 * self.context, self.core))

    def log_probs(self, wav: np.ndarray) -> np.ndarray:
        """(T_total', V) stitched frame log-probs of a 1-D waveform,
        exactly ``conv_output_length(len(wav))`` frames long."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        n = len(wav)
        starts = self._chunk_starts(n)
        # global frame where chunk k stops and chunk k+1 takes over
        cuts = [0] + [s // self.stride + self.margin_frames
                      for s in starts[1:]]
        cuts.append(conv_output_length(n, self.conv_features))
        segs = [wav[s:s + self.chunk] for s in starts]
        rows = self._row_log_probs(segs)
        pieces = [self._kept(row, len(seg), s, cuts[k], cuts[k + 1])
                  for k, (s, seg, row) in enumerate(zip(starts, segs, rows))]
        return np.concatenate(pieces, axis=0) if pieces else np.zeros(
            (0, 1), np.float32)

    def _kept(self, row: np.ndarray, seg_len: int, start: int, lo: int,
              hi: int) -> np.ndarray:
        """The frames of the chunk row at sample ``start`` between global
        frames ``lo`` and ``hi``. The chunk's exact conv frame count
        bounds them: the reshape-all pad mask may undercount the tail
        frame, which still belongs here."""
        exact = conv_output_length(seg_len, self.conv_features)
        valid = row[:min(exact, len(row))]
        base = start // self.stride
        return valid[lo - base:min(hi - base, len(valid))]

    def _row_log_probs(self, segs: List[np.ndarray]) -> List[np.ndarray]:
        """Per-chunk ``(T_chunk', V)`` rows, through the shared batcher or
        this transcriber's own ``(batch, chunk)`` dispatches."""
        if self.batcher is not None:
            return self.batcher.submit_many(segs)
        rows: List[np.ndarray] = []
        for i0 in range(0, len(segs), self.batch):
            rows.extend(run_block(self.forward, segs[i0:i0 + self.batch],
                                  self.batch, self.chunk, self.device))
        return rows

    def transcribe(self, wav: np.ndarray, index2vocab: dict,
                   decoder=None, blank: Optional[int] = None,
                   postproc: Optional[Callable] = None) -> str:
        """Waveform -> text by greedy collapse (or a PrefixBeamSearch)."""
        return decode_stitched(self.log_probs(wav), index2vocab, decoder,
                               blank, postproc)


def decode_stitched(lp: np.ndarray, index2vocab: dict, decoder=None,
                    blank: Optional[int] = None,
                    postproc: Optional[Callable] = None) -> str:
    """(T', V) stitched frame log-probs -> text (greedy or beam decode)."""
    if len(lp) == 0:
        return ""
    if decoder is not None:
        chars = decoder.run(lp[None, ...], [len(lp)], n_best=1)[0]
    else:
        b = Offsets.GO if blank is None else blank
        ids = greedy_collapse(np.argmax(lp, -1).astype(np.int32), b)
        chars = [index2vocab[i] for i in ids]
    return (postproc or postproc_letters)(chars)


class StreamingTranscriber(ChunkedTranscriber):
    """Incremental transcription: feed audio as it arrives, read partials.

    Gives the same stitched log-probs as ``ChunkedTranscriber`` on the
    whole waveform. A chunk is forwarded once its samples and one more
    (which proves it is not the last chunk) have arrived; its kept frames
    join the stable prefix and the samples before the next chunk's start
    are dropped, so a stream holds O(chunk) samples. ``finish`` flushes
    the tail when the stream ends. Without a batcher each chunk is a
    ``(1, chunk)`` dispatch."""

    def __init__(self, forward: Callable, conv_features: Sequence,
                 chunk_samples: int = 480_000, context_samples: int = 32_000,
                 batcher: Optional[MicroBatcher] = None,
                 device: torch.device | str = "cpu"):
        super().__init__(forward, conv_features, chunk_samples=chunk_samples,
                         context_samples=context_samples, batch_size=1,
                         batcher=batcher, device=device)
        self.reset()

    def reset(self) -> None:
        """Forget the stream; ready for a new utterance."""
        self._tail = np.zeros((0,), np.float32)  # retained samples
        self._tail_base = 0                      # absolute index of _tail[0]
        self._next_chunk = 0                     # next chunk to emit
        self._pieces: List[np.ndarray] = []      # stable stitched frames
        self._final: Optional[np.ndarray] = None

    @property
    def samples_fed(self) -> int:
        return self._tail_base + len(self._tail)

    def feed(self, samples: np.ndarray) -> None:
        """Append samples; forward the chunks that became complete."""
        if self._final is not None:
            raise RuntimeError("stream already finished; call reset()")
        samples = np.asarray(samples, np.float32).reshape(-1)
        if len(samples) == 0:
            return
        self._tail = np.concatenate([self._tail, samples])
        # chunk k is interior once one sample past its window arrived: the
        # stream's end only grows, so the offline cut points hold
        while (self.samples_fed
               >= self._next_chunk * self.core + self.chunk + 1):
            start = self._next_chunk * self.core
            upper = (start + self.core) // self.stride + self.margin_frames
            self._emit(start, self.chunk, upper)
            self._next_chunk += 1
            drop = self._next_chunk * self.core - self._tail_base
            if drop > 0:
                self._tail = self._tail[drop:]
                self._tail_base += drop

    def _emit(self, start: int, seg_len: int, upper_cut: int) -> None:
        lo_s = start - self._tail_base
        seg = self._tail[lo_s:lo_s + seg_len]
        lower_cut = start // self.stride + (self.margin_frames if start
                                            else 0)
        self._pieces.append(self._kept(self._row_log_probs([seg])[0],
                                       len(seg), start, lower_cut, upper_cut))

    def log_probs_so_far(self) -> np.ndarray:
        """(T_stable', V) stable stitched prefix (exact vs offline)."""
        if not self._pieces:
            return np.zeros((0, 1), np.float32)
        return np.concatenate(self._pieces, axis=0)

    def text_so_far(self, index2vocab: dict, decoder=None,
                    blank: Optional[int] = None,
                    postproc: Optional[Callable] = None) -> str:
        return decode_stitched(self.log_probs_so_far(), index2vocab,
                               decoder, blank, postproc)

    def finish(self) -> np.ndarray:
        """End of stream: flush the remaining chunks, return the full
        (T', V) log-probs."""
        if self._final is not None:
            return self._final
        n = self.samples_fed
        if n == 0:
            self._final = np.zeros((0, 1), np.float32)
            return self._final
        starts = self._chunk_starts(n)
        total = conv_output_length(n, self.conv_features)
        for k in range(self._next_chunk, len(starts)):
            start = starts[k]
            upper = (starts[k + 1] // self.stride + self.margin_frames
                     if k + 1 < len(starts) else total)
            self._emit(start, min(n - start, self.chunk), upper)
        self._next_chunk = len(starts)
        self._final = self.log_probs_so_far()
        return self._final

    def finish_text(self, index2vocab: dict, decoder=None,
                    blank: Optional[int] = None,
                    postproc: Optional[Callable] = None) -> str:
        return decode_stitched(self.finish(), index2vocab, decoder, blank,
                               postproc)
