"""Serving helpers of the port (``audio8_tpu/serve.py``): cross-request
chunk batching and long-audio transcription through fixed-size chunks.

The chunk geometry and stitching are the JAX package's own: the port's
:class:`ChunkedTranscriber` subclasses ``audio8_tpu.serve.ChunkedTranscriber``
(a host-only module) and changes only how a block of chunks reaches the
model: as torch tensors on the model's device. :class:`MicroBatcher` does
the same for the shared dispatcher. ``StreamingTranscriber`` is not ported
yet.
"""
from __future__ import annotations

import queue
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from audio8_tpu import serve as _host
from audio8_tpu.utils import Offsets
from audio8_tpu_torch.ops.ctc import greedy_collapse
from audio8_tpu_torch.ops.metrics import postproc_letters


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


class MicroBatcher(_host.MicroBatcher):
    """Cross-request chunk batching (``audio8_tpu.serve.MicroBatcher``):
    one dispatcher thread packs up to ``batch_size`` pending rows from any
    caller into one forward on ``device``. ``forward(signal (B, chunk) f32,
    lengths (B,) int64) -> (log_probs (B, T', V), frames (B,))`` takes and
    returns torch tensors."""

    def __init__(self, forward: Callable, chunk_samples: int,
                 batch_size: int = 4, max_wait_ms: float = 2.0,
                 device: torch.device | str = "cpu"):
        self.device = torch.device(device)  # read by the dispatcher thread
        super().__init__(forward, chunk_samples, batch_size, max_wait_ms)

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


class ChunkedTranscriber(_host.ChunkedTranscriber):
    """Stitched log-probs + transcription for arbitrarily long audio
    (``audio8_tpu.serve.ChunkedTranscriber``) with the forward on
    ``device``."""

    def __init__(self, forward: Callable, conv_features,
                 chunk_samples: int = 480_000, context_samples: int = 32_000,
                 batch_size: int = 4, batcher: Optional[MicroBatcher] = None,
                 device: torch.device | str = "cpu"):
        super().__init__(forward, conv_features, chunk_samples,
                         context_samples, batch_size, batcher)
        self.device = torch.device(device)

    def _row_log_probs(self, segs: List[np.ndarray]) -> List[np.ndarray]:
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
