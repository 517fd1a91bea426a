"""Profiling helpers and per-call metrics of the public entry points (port
of ``snappier_tpu/utils/profiling.py``).

:func:`device_trace` records a ``torch.profiler`` trace of a region (the
card's kernels and copies, and the host's operators) into a Chrome trace
file; :class:`Throughput` measures bytes per second over a region, to the
end of the device work it queued.

Call metrics: opt in with ``SNAPPIER_METRICS=1``: the block facade wraps
each call in :func:`timed_call`, which then accumulates (calls, seconds,
bytes) per entry point; disabled, the hot paths pay one falsy check. Times
are host wall-clock around calls that end with their results on the host,
so they include the device work and the transfers.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import pathlib
import threading
import time
from collections import defaultdict


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
    import torch
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
            import torch

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
_stats: dict = defaultdict(lambda: [0, 0.0, 0])  # name -> [calls, secs, bytes]
_trace_ids = itertools.count(1)  # numbers this process's trace files


def metrics_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def timed_call(name: str, nbytes: int = 0):
    """Accumulate (calls, seconds, bytes) for ``name`` when
    SNAPPIER_METRICS=1; a no-op otherwise."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            s = _stats[name]
            s[0] += 1
            s[1] += dt
            s[2] += nbytes


def metrics_snapshot() -> dict:
    """{name: {calls, seconds, bytes, MBps}} accumulated so far."""
    with _lock:
        return {
            k: {
                "calls": v[0],
                "seconds": round(v[1], 6),
                "bytes": v[2],
                "MBps": round(v[2] / max(v[1], 1e-12) / 1e6, 2),
            }
            for k, v in _stats.items()
        }


def metrics_reset() -> None:
    with _lock:
        _stats.clear()
