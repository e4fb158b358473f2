"""Profiling / tracing hooks.

The reference has no tracing (SURVEY.md §5 — its closest artifact is
per-iteration metric printing).  The equivalent here: a thin wrapper over
``jax.profiler`` so any training or inference region can be captured and
inspected with TensorBoard/XProf, plus a simple wall-clock timer used by the
trainers' callbacks.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Capture a device profile into ``logdir`` (no-op when None)."""
    if logdir is None:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class IterationTimer:
    """Wall-clock timer for per-iteration reporting."""

    def __init__(self) -> None:
        self._last = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        return dt
