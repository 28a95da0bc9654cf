"""Step timing and profiler hooks (the JAX package's ``utils/profiling.py``).

* :class:`StepTimer`: ms per batch and images per second over a rolling
  window of steps, with the JAX package's arithmetic; the trainer's log line
  reads it.
* :func:`trace`: a ``torch.profiler`` trace of the enclosed work (CPU and,
  on a card, CUDA activity), written to a directory as a Chrome trace
  (``*.pt.trace.json``, which TensorBoard's profiler plugin and Perfetto
  read).
* :func:`annotate`: a named range (``torch.profiler.record_function``), so
  that host phases show on the timeline; the trainer marks its sample
  rendering and checkpoint writes with it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


class StepTimer:
    """Rolling step timing: ms/batch and images/sec."""

    def __init__(self, window: int = 50):
        self.window = window
        self._start: Optional[float] = None
        self._count = 0.0
        self._images = 0.0
        self._elapsed = 0.0

    def tick(self, batch_size: int = 0) -> None:
        """Record the end of one step of ``batch_size`` images; the first
        call only starts the clock."""
        now = time.perf_counter()
        if self._start is not None:
            self._elapsed += now - self._start
            self._count += 1
            self._images += batch_size
            if self._count > self.window:
                # decay toward the window (rolling average)
                scale = self.window / self._count
                self._elapsed *= scale
                self._images *= scale
                self._count = self.window
        self._start = now

    @property
    def ms_per_batch(self) -> float:
        if self._count == 0:
            return float("nan")
        return 1000.0 * self._elapsed / self._count

    def images_per_sec(self) -> float:
        """Throughput from the image counts given to :meth:`tick`."""
        if self._elapsed == 0:
            return float("nan")
        return self._images / self._elapsed


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed work: CPU activity, and CUDA activity where a
    card is present, written to ``log_dir`` as a Chrome trace when the block
    ends.  Yields the profiler (``key_averages()`` reads it)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """A named range on the profiler's timeline (a no-op outside a trace)."""
    return torch.profiler.record_function(name)
