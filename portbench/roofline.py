"""The yardstick of every roofline metric, the card's published peak and
the least time a phase's bytes need, and the sums over phases that the
metric readers share.

A codec phase is bound by memory: it reads each input byte once and writes
each output byte once, and the count stops there whatever a kernel reads
again. The least time is those bytes over the peak bandwidth of one NVIDIA
H100 SXM (80 GB HBM3 at 3.35 TB/s, NVIDIA's data sheet, at the full 700 W
power limit; ``device.power_limit_w`` of a run says what the card was set
to). A share is that least time over the device-busy time the trace
measured for the same phases, in percent.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float) -> float:
    return nbytes / PEAK_BYTES_PER_S


def share_pct(nbytes: float, busy_s: float) -> float | None:
    """The roofline share in percent, or None where nothing ran."""
    if busy_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * least_seconds(nbytes) / busy_s


def phases_share(rec, kind: str) -> float | None:
    """Share of the phases of ``kind``: bytes in and out over their
    device-busy time."""
    ph = [p for p in rec.phases if p["kind"] == kind and p.get("busy_s") is not None]
    if not ph:
        return None
    return share_pct(sum(p["bytes_in"] + p["bytes_out"] for p in ph), sum(p["busy_s"] for p in ph))


def idle_pct(rec, kind: str) -> float | None:
    """The share of the phases' wall time in which the card ran nothing."""
    ph = [p for p in rec.phases if p["kind"] == kind and p.get("busy_s") is not None]
    wall = sum(p["t1_trace"] - p["t0_trace"] for p in ph)
    if not ph or wall <= 0:
        return None
    return 100.0 * (1.0 - sum(p["busy_s"] for p in ph) / wall)


def rate_gbps(rec, kind: str, field: str) -> float | None:
    """The phases of ``kind``: their bytes ``field`` (``bytes_in`` taken,
    ``bytes_out`` produced) over their summed wall time, in GB/s."""
    ph = [p for p in rec.phases if p["kind"] == kind]
    secs = sum(p["t1"] - p["t0"] for p in ph)
    return sum(p[field] for p in ph) / secs / 1e9 if secs > 0 else None
