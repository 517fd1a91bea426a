"""The program's own spans over a run's window, for the metric readers
that time one span of the program (the block facade's steps, the candidate
search, the batched codec's pack).

The program records spans while a ``torch.profiler`` recording is on, so
they exist in the traced run alone; ``spans_snapshot()`` of
``snappier_tpu_torch.utils.profiling`` hands them over, each with its host
start and end on ``time.perf_counter_ns`` (the clock of the phases' ``t0``
and ``t1``) and, for a span of device work, the device's time. A reader
keeps the records that lie inside the window, from the first phase's
``t0`` to the last phase's ``t1``, and divides their sum by the window's
calls of one kind. It reads nothing (None) from a program that keeps no
spans, where the program's ring dropped a record, or where no record of
the span lies inside the window.
"""

from __future__ import annotations


def window_records(rec, name: str) -> list[dict] | None:
    """The records of the span ``name`` inside the window, or None where
    they cannot be read whole."""
    from snappier_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "spans_snapshot", None)
    dropped = getattr(profiling, "spans_dropped", None)
    if snapshot is None or dropped is None or dropped() or not rec.phases:
        return None
    w0, w1 = rec.phases[0]["t0"], rec.phases[-1]["t1"]
    return [r for r in snapshot()
            if r["name"] == name and r["t0_ns"] * 1e-9 >= w0 and r["t1_ns"] * 1e-9 <= w1]


def _per_call(rec, name: str, kind: str, ms_of) -> float | None:
    recs = window_records(rec, name)
    calls = sum(p["calls"] for p in rec.phases if p["kind"] == kind)
    if not recs or not calls:
        return None
    ms = [ms_of(r) for r in recs]
    return None if None in ms else sum(ms) / calls


def host_ms(rec, name: str, kind: str) -> float | None:
    """Host milliseconds inside the span ``name`` per call of ``kind``."""
    return _per_call(rec, name, kind, lambda r: (r["t1_ns"] - r["t0_ns"]) * 1e-6)


def device_ms(rec, name: str, kind: str) -> float | None:
    """The device's milliseconds between the edges of the span ``name``
    (on the card, its stream's time) per call of ``kind``."""
    return _per_call(rec, name, kind, lambda r: r["stream_ms"])
