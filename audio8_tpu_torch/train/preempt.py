"""Preemption-safe training: checkpoint on SIGTERM and exit cleanly
(``audio8_tpu/train/preempt.py``).

A trainer polls :class:`PreemptionGuard` once per optimizer step; after
a SIGTERM it saves its checkpoint and resume file at that step boundary
and returns, so the process exits 0 and ``--restart_from <basedir>``
continues from the saved step. Under data parallelism (a process
``group``) the ranks agree on one step, as the JAX guard's multi-process
branch does: each poll all-reduces the flag (its maximum), so the step
at which any rank saw the signal is the step every rank stops at, and
the checkpoint (rank 0's) and the barrier after it cannot wait on a rank
that went on.
"""
from __future__ import annotations

import logging
import signal
import threading

import torch
import torch.distributed as dist

logger = logging.getLogger("audio8_tpu_torch")


class PreemptionGuard:
    """``should_save(step)`` is True exactly once, at the first step
    polled after a SIGTERM (on any rank of ``group``'s run: every rank of
    the world decides, the model ranks of a tensor-parallel run too)."""

    def __init__(self, group=None):
        self._group = None if group is None else dist.group.WORLD
        self._flag = threading.Event()
        self._fired = False
        self._prev = None
        try:
            self._prev = signal.signal(signal.SIGTERM, self._on_signal)
        except ValueError:  # not the main thread (tests, servers)
            pass

    def _on_signal(self, signum, frame):
        logger.warning("SIGTERM received: checkpointing at the next step "
                       "boundary, then exiting")
        self._flag.set()

    def should_save(self, step: int) -> bool:
        """True when the trainer must checkpoint and stop at ``step``."""
        if self._fired:
            return False  # fire once; the trainer is already stopping
        hit = self._flag.is_set()
        if self._group is not None:
            from audio8_tpu_torch.parallel.sharding import collective_device

            flag = torch.tensor([int(hit)], dtype=torch.int32,
                                device=collective_device(self._group))
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._group)
            hit = bool(flag.item())
        self._fired = hit
        return hit

    def close(self) -> None:
        """Give SIGTERM back to the handler it had before."""
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None
