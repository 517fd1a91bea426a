"""Profiling helpers and the program's spans (port of
``snappier_tpu/utils/profiling.py``).

:func:`device_trace` records a ``torch.profiler`` trace of a region (the
card's kernels and copies, and the host's operators) into a Chrome trace
file; :class:`Throughput` measures bytes per second over a region, to the
end of the device work it queued.

Spans: :func:`span` marks a region of the codec (the block facade's
fragmenting, copies, encode, wait, fetch and join; the candidate search;
the batched codec's encode and pack). It records only while
:func:`metrics_enabled`: ``SNAPPIER_METRICS=1`` in the environment (read at
import) or a ``torch.profiler`` recording. Off, it hands back one shared
null context and records nothing. On, each span adds (calls, seconds,
bytes) to its name's totals (:func:`metrics_snapshot`) and one record to a
bounded ring (:func:`spans_snapshot`): its name, its parent, the root call
it belongs to, its host start and end on ``time.perf_counter_ns`` and its
bytes; under a recording profiler it is also a ``record_function`` range,
so the trace names the host's time by span; a span given a CUDA device
also times its stream with two CUDA events, which cost the host tens of
microseconds a span, so only the spans whose device time is read take one. Host times are wall-clock, so a
root that ends with its result on the host includes the device work and the
transfers.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import pathlib
import threading
import time
from collections import defaultdict, deque

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def device_trace(log_dir, device=None):
    """Trace the region with ``torch.profiler`` and write a Chrome trace
    (``trace-<pid>-<n>.json``) under ``log_dir``; yields the profiler, whose
    ``key_averages()`` the caller may read after the region.

    On a CUDA device the trace holds the card's kernels (the port's own,
    launched through their C launchers, included) and copies beside the host
    activity, and the device is synchronised before the trace starts and
    before it stops, so the region's queued work lands inside it.
    ``device="cpu"`` traces host activity only. The default device is the
    card; without one it raises."""
    from torch.profiler import ProfilerActivity, profile

    from snappier_tpu_torch.models.codec import resolve_device

    dev = resolve_device(device)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        prof.export_chrome_trace(str(out / f"trace-{os.getpid()}-{next(_trace_ids)}.json"))


class Throughput:
    """Context manager measuring bytes/s over a region.

    >>> with Throughput(len(data)) as t:
    ...     codec.compress_batch(...)
    >>> t.gbps

    On a CUDA device it calls ``torch.cuda.synchronize(device)`` before it
    reads the clock on entry and on exit, so a region that only queues
    kernels is timed to their end (and not charged for work queued before
    it). ``device="cpu"`` reads the host clock alone. The default device is
    the card; without one it raises."""

    def __init__(self, nbytes: int, device=None):
        self.nbytes = nbytes
        self.seconds = 0.0
        from snappier_tpu_torch.models.codec import resolve_device

        self.device = resolve_device(device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.seconds = time.perf_counter() - self._t0

    @property
    def gbps(self) -> float:
        return self.nbytes / max(self.seconds, 1e-12) / 1e9


_ENABLED = bool(os.environ.get("SNAPPIER_METRICS"))
_lock = threading.Lock()
_stats: dict = defaultdict(lambda: [0, 0, 0])  # name -> [calls, ns, bytes]
_trace_ids = itertools.count(1)  # numbers this process's trace files

#: Records the span ring holds: a 50 s traced window of the batch codec
#: makes about 16,000 (three a compress call, one a decompress call).
SPAN_RING = 1 << 16
_ring: deque = deque(maxlen=SPAN_RING)
_appended = 0  # records ever appended since the last spans_reset
_span_ids = itertools.count()
_local = threading.local()  # .stack: this thread's open spans


def metrics_enabled() -> bool:
    """The one gate of :func:`span`: ``SNAPPIER_METRICS`` or a
    ``torch.profiler`` recording."""
    return _ENABLED or _autograd_profiler._is_profiler_enabled


class _NullSpan:
    """The context :func:`span` returns while metrics are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One span; once closed, it is its own record in the ring."""

    __slots__ = ("name", "nbytes", "device", "id", "parent", "call", "t0", "t1",
                 "events", "stream_ms", "_range")

    def __init__(self, name: str, nbytes: int, device):
        self.name, self.nbytes, self.device = name, nbytes, device
        self.events = self.stream_ms = self._range = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_span_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = -1, self.id
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if (self.device and torch.device(self.device).type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _appended
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _local.stack.pop()
        with _lock:
            s = _stats[self.name]
            s[0] += 1
            s[1] += self.t1 - self.t0
            s[2] += self.nbytes
            _ring.append(self)
            _appended += 1
        return False


def span(name: str, nbytes: int = 0, device=False):
    """A context manager timing a region of the codec as ``name`` (``bytes``
    it moved or took: ``nbytes``). ``device``: the device the region's work
    runs on; on a CUDA device the span times its current stream with two
    timing events (none while the stream is captured into a graph), which
    gives the record a device time. Spans opened inside it, on the same
    thread, are its children. While :func:`metrics_enabled` is false it returns one shared
    null context and records nothing."""
    if not metrics_enabled():
        return _NULL_SPAN
    return _Span(name, nbytes, device)


def timed_call(name: str, nbytes: int = 0):
    """The JAX package's name for a public entry point's span:
    ``span(name, nbytes)``."""
    return span(name, nbytes)


def metrics_snapshot() -> dict:
    """{name: {calls, seconds, bytes, MBps}} accumulated so far, a name a
    span."""
    with _lock:
        return {
            k: {
                "calls": v[0],
                "seconds": round(v[1] * 1e-9, 6),
                "bytes": v[2],
                "MBps": round(v[2] / max(v[1] * 1e-9, 1e-12) / 1e6, 2),
            }
            for k, v in _stats.items()
        }


def metrics_reset() -> None:
    with _lock:
        _stats.clear()


def spans_snapshot() -> list[dict]:
    """The ring's records, oldest first: ``name``, ``id``, ``parent`` (the
    enclosing span's ``id``, -1 at a root), ``call`` (the root's ``id``),
    ``t0_ns`` and ``t1_ns`` (``time.perf_counter_ns``), ``nbytes`` and
    ``stream_ms``, the card's time between the span's edges: the current
    stream's, by its events (resolving them waits for them); None for a
    host span, a span on the CPU or one inside a graph capture."""
    with _lock:
        for r in _ring:
            if r.events is not None:
                r.events[1].synchronize()
                r.stream_ms = r.events[0].elapsed_time(r.events[1])
                r.events = None
        return [{"name": r.name, "id": r.id, "parent": r.parent, "call": r.call,
                 "t0_ns": r.t0, "t1_ns": r.t1, "nbytes": r.nbytes, "stream_ms": r.stream_ms}
                for r in _ring]


def spans_dropped() -> int:
    """Records the ring let go since the last :func:`spans_reset` (the
    oldest first): a reader of a window needs 0."""
    with _lock:
        return _appended - len(_ring)


def spans_reset() -> None:
    global _appended
    with _lock:
        _ring.clear()
        _appended = 0
