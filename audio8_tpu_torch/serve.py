"""Serving helpers of the port (``audio8_tpu/serve.py``): cross-request
chunk batching and long-audio transcription through fixed-size chunks.

:class:`ChunkedTranscriber` slices a waveform into ``chunk_samples``
windows with ``context_samples`` of overlap on each side, runs the
acoustic forward on ``(batch, chunk)`` blocks, drops the margin frames of
interior chunks and stitches the per-frame log-probs; the geometry is the
JAX package's, so both packages cut a waveform at the same frames.
:class:`MicroBatcher` packs chunk rows from concurrent callers into
shared dispatches. Blocks reach the model as torch tensors on its device.
``StreamingTranscriber`` is not ported yet.
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
        pieces: List[np.ndarray] = []
        for k, (s, seg, row) in enumerate(zip(starts, segs, rows)):
            # the chunk's exact conv frame count: the reshape-all pad mask
            # may undercount the tail frame, which still belongs here
            exact = conv_output_length(len(seg), self.conv_features)
            valid = row[:min(exact, len(row))]
            base = s // self.stride
            pieces.append(valid[cuts[k] - base:
                                min(cuts[k + 1] - base, len(valid))])
        return np.concatenate(pieces, axis=0) if pieces else np.zeros(
            (0, 1), np.float32)

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
                   blank: Optional[int] = None,
                   postproc: Optional[Callable] = None) -> str:
        """Waveform -> text by greedy CTC collapse (beam search waits)."""
        return decode_stitched(self.log_probs(wav), index2vocab, blank,
                               postproc)


def decode_stitched(lp: np.ndarray, index2vocab: dict,
                    blank: Optional[int] = None,
                    postproc: Optional[Callable] = None) -> str:
    """(T', V) stitched frame log-probs -> text by greedy collapse."""
    if len(lp) == 0:
        return ""
    b = Offsets.GO if blank is None else blank
    ids = greedy_collapse(np.argmax(lp, -1).astype(np.int32), b)
    return (postproc or postproc_letters)([index2vocab[i] for i in ids])
