"""Step profiling of the trainers (``audio8_tpu/train/profiler.py``):
``torch.profiler`` over a window of steps, written as a Chrome trace
(viewable in Perfetto or ``chrome://tracing``), where the JAX package
captures a ``jax.profiler`` trace. On the card the trace holds the CUDA
kernels and memory copies beside the host's ops.

  profiler = StepProfiler(args.profile_dir)
  ...  # after each optimizer step:
  profiler.step(global_step)
  ...
  profiler.close()
"""
from __future__ import annotations

import contextlib
import logging
import os
from typing import Optional

import torch

logger = logging.getLogger("audio8_tpu_torch.profiler")


class StepProfiler:
    """Traces the steps after ``step(start)`` until ``step(start + num)``
    (the JAX defaults: 10 and 5), one ``ProfilerStep#`` span per step,
    into ``trace_dir/trace-steps-{start}-{stop}.json``. CUDA activity is
    recorded when ``device`` is a CUDA device. Without ``trace_dir`` it
    does nothing."""

    def __init__(self, trace_dir: Optional[str], start_step: int = 10,
                 num_steps: int = 5, device=None):
        self.trace_dir = trace_dir
        self.start = start_step
        self.stop = start_step + num_steps
        self.device = torch.device(device) if device is not None else None
        self.path: Optional[str] = None
        self._prof = None

    def step(self, global_step: int) -> None:
        if not self.trace_dir:
            return
        if self._prof is None and global_step == self.start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device is not None and self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(self.trace_dir, exist_ok=True)
            logger.info("Starting profiler trace -> %s", self.trace_dir)
            # a schedule that always records: the steps get their spans
            self._prof = torch.profiler.profile(
                activities=activities,
                schedule=lambda _: torch.profiler.ProfilerAction.RECORD)
            self._prof.start()
        elif self._prof is not None:
            if global_step >= self.stop:
                self.close()
            else:
                self._prof.step()

    def close(self) -> None:
        """End an open window and write its trace."""
        if self._prof is None:
            return
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        self.path = os.path.join(self.trace_dir,
                                 f"trace-steps-{self.start}-{self.stop}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        logger.info("Profiler trace written to %s", self.path)


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the profiler's timeline."""
    with torch.profiler.record_function(name):
        yield
