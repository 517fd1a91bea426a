"""Per-call metrics of the public entry points (port of the call
accounting in ``snappier_tpu/utils/profiling.py``).

Opt in with ``SNAPPIER_METRICS=1``: the block facade wraps each call in
:func:`timed_call`, which then accumulates (calls, seconds, bytes) per
entry point; disabled, the hot paths pay one falsy check. Times are host
wall-clock around calls that end with their results on the host, so they
include the device work and the transfers.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

_ENABLED = bool(os.environ.get("SNAPPIER_METRICS"))
_lock = threading.Lock()
_stats: dict = defaultdict(lambda: [0, 0.0, 0])  # name -> [calls, secs, bytes]


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
