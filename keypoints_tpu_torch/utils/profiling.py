"""Profiling and timing — port of ``keypoints_tpu/utils/profiling.py``.

* :func:`trace` — a ``torch.profiler`` trace of the block (host, and the
  card's kernels when CUDA is available), written to
  ``{logdir}/trace.json`` (chrome://tracing, Perfetto).
* :func:`fetch_sync` — wait for the device by a one-element
  device-to-host read of each tensor, a fence whatever stream made it.
* :func:`timed` — best wall-clock seconds of a call, each call ended by
  :func:`fetch_sync`.
* :class:`StepTimer` — rolling frames/sec for training loops.
* :func:`span` — a named host span of the program, recorded only while a
  ``torch.profiler`` runs: into the profiler's trace (a host event on the
  kernels' clock) and into totals by name (:func:`span_totals`,
  :func:`reset_spans`).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator

import torch
from torch.utils._pytree import tree_leaves

_profiler_enabled = torch._C._autograd._profiler_enabled
#: a span's event in the profiler's trace: torch's fast record function (a
#: ``cpu_op``, ~2 µs on a CPU) where this torch has it, else
#: ``record_function`` (a ``user_annotation``, ~15 µs)
_annotation = getattr(torch._C._profiler, "_RecordFunctionFast",
                      torch.autograd.profiler.record_function)
_OFF = contextlib.nullcontext()
#: name -> [calls, seconds, self seconds], over every thread
_totals: dict[str, list] = {}
_totals_lock = threading.Lock()
#: per thread: the child seconds of each open span, innermost last
_open = threading.local()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; ``{logdir}/trace.json`` is written when it ends,
    also when it raises. Yields the profiler (``key_averages()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def fetch_sync(x) -> None:
    """Force device completion: read one element of each tensor leaf of
    ``x`` (a tensor, or nested lists, tuples and dicts) to the host."""
    for leaf in tree_leaves(x):
        if isinstance(leaf, torch.Tensor):
            leaf.detach().reshape(-1)[:1].cpu()


def timed(fn, *args, reps: int = 5, **kwargs) -> tuple[float, object]:
    """→ (best seconds, last output); a warmup call + ``reps`` timed calls."""
    out = fn(*args, **kwargs)
    fetch_sync(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        fetch_sync(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


class StepTimer:
    """Rolling throughput: call :meth:`mark` every logged step."""

    def __init__(self, batch_size: int):
        self.batch = batch_size
        self._t = time.perf_counter()
        self._step = 0

    def mark(self, step: int) -> float:
        now = time.perf_counter()
        fps = (step - self._step) * self.batch / max(now - self._t, 1e-9)
        self._t, self._step = now, step
        return fps


def span(name: str):
    """A context manager around one piece of the program's host work.

    While no profiler records this thread it is a shared no-op: the one
    cost is torch's check for a running profiler. While one does
    (``torch.profiler.profile``, :func:`trace`: the thread that started
    it) the block is a host event of the profiler's trace named ``name``,
    around the kernels and copies it launched, and its host seconds and
    its self seconds (less the spans opened inside it on the same thread)
    are added to :func:`span_totals` under ``name``.
    """
    if not _profiler_enabled():
        return _OFF
    return _Span(name)


class _Span:
    """An open span: its own seconds are timed inside its event, and its
    parent's self seconds lose the span with its event's cost."""
    __slots__ = ("name", "annotation", "t_outer", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t_outer = time.perf_counter()
        self.annotation = _annotation(self.name)
        self.annotation.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        stack.append(0.0)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        self.annotation.__exit__(*exc)
        stack = _open.stack
        children = stack.pop()
        if stack:
            stack[-1] += time.perf_counter() - self.t_outer
        with _totals_lock:
            entry = _totals.setdefault(self.name, [0, 0.0, 0.0])
            entry[0] += 1
            entry[1] += seconds
            entry[2] += seconds - children


def span_totals() -> dict[str, dict]:
    """→ ``{name: {"calls", "seconds", "self_seconds"}}`` of the spans
    recorded since the last :func:`reset_spans`, over all threads."""
    with _totals_lock:
        return {name: dict(zip(("calls", "seconds", "self_seconds"), entry))
                for name, entry in _totals.items()}


def reset_spans() -> None:
    """Forget every span recorded so far."""
    with _totals_lock:
        _totals.clear()
