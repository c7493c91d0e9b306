"""Preemption-safe training: checkpoint on SIGTERM and exit cleanly
(``audio8_tpu/train/preempt.py``, single process).

A trainer polls :class:`PreemptionGuard` once per optimizer step; after
a SIGTERM it saves its checkpoint and resume file at that step boundary
and returns, so the process exits 0 and ``--restart_from <basedir>``
continues from the saved step. Agreeing on one step across processes
waits for data parallelism (ROADMAP.md queue 1, item 3).
"""
from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger("audio8_tpu_torch")


class PreemptionGuard:
    """``should_save(step)`` is True exactly once, at the first step
    polled after a SIGTERM."""

    def __init__(self):
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
        self._fired = self._flag.is_set()
        return self._fired

    def close(self) -> None:
        """Give SIGTERM back to the handler it had before."""
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None
