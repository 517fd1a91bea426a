"""The traced run: ``torch.profiler`` around the window, read back into
device-busy intervals, per-phase busy time and kernel time, and the
breakdown of the result line.

The harness marks its own spans with ``record_function`` (``phase.<kind>``
around each phase, ``dispatch`` and ``sync`` inside the batch phases,
``call`` around each facade call). Device activity comes from the
profiler's CUDA events (kernels, copies, memsets), in the profiler's clock,
which its CPU events share; each phase record gets its interval in that
clock (``t0_trace``, ``t1_trace``), its busy seconds (the union of device
activity inside it) and its kernel seconds by name.
"""

from __future__ import annotations

import contextlib

import numpy as np

PHASE = "phase."
HARNESS_SPANS = ("dispatch", "sync", "call")  # besides phase.<kind>
BREAKDOWN_ENTRIES = 10


def span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


@contextlib.contextmanager
def profiled(device):
    """Yield a holder whose ``events`` is filled once the region ends:
    a list of (is_device, name, start_s, end_s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    holder = type("Trace", (), {})()
    prof = profile(activities=acts)
    prof.start()
    try:
        yield holder
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        holder.events = _events(prof)


def _events(prof) -> list:
    """(on the device, name, start s, end s) of every event but the device
    side of the harness's own spans: a span's ``gpu_user_annotation``
    covers the device activity it enqueued, gaps included, and is no
    device work of its own."""
    from torch.autograd import DeviceType

    evs = list(prof.profiler.kineto_results.events())
    spans = {e.name() for e in evs if e.device_type() != DeviceType.CUDA and e.is_user_annotation()}
    out = []
    for e in evs:
        dev = e.device_type() == DeviceType.CUDA
        name = e.name()
        if dev and (e.is_user_annotation() or name in spans or name.startswith(PHASE)
                    or name in HARNESS_SPANS):
            continue
        out.append((dev, name, e.start_ns() * 1e-9, e.end_ns() * 1e-9))
    return out


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge [start, end] rows into disjoint sorted intervals."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(new)
    stops = np.maximum.reduceat(iv[:, 1], last) if len(last) else np.empty(0)
    return np.stack([starts, stops], axis=1)


def _covered(merged: np.ndarray, a: float, b: float) -> float:
    if len(merged) == 0 or b <= a:
        return 0.0
    lo = np.clip(merged[:, 0], a, b)
    hi = np.clip(merged[:, 1], a, b)
    return float(np.sum(hi - lo))


def annotate(phases: list[dict], events: list) -> dict:
    """Give each phase its trace interval, busy seconds and kernel seconds;
    return the window's ``busy_s``, ``window_s`` and ``breakdown``."""
    spans = sorted((s, e, n) for d, n, s, e in events if not d and n.startswith(PHASE))
    if len(spans) != len(phases):
        raise RuntimeError(f"the trace holds {len(spans)} phase spans for {len(phases)} phases")
    dev = [(n, s, e) for d, n, s, e in events if d and e > s]
    dev_iv = np.array([[s, e] for _, s, e in dev], float).reshape(-1, 2)
    merged = _union(dev_iv)
    starts = np.array([s for _, s, _ in dev])
    for p, (s, e, n) in zip(phases, spans):
        if n != PHASE + p["kind"]:
            raise RuntimeError(f"phase span {n} where a {p['kind']} phase was recorded")
        p["t0_trace"], p["t1_trace"] = s, e
        p["busy_s"] = _covered(merged, s, e)
        inside = (starts >= s) & (starts < e) if len(starts) else np.zeros(0, bool)
        kern = {}
        for i in np.flatnonzero(inside):
            name, a, b = dev[i]
            if not name.startswith(("Memcpy", "Memset")):
                kern[name] = kern.get(name, 0.0) + (b - a)
        p["kernels"] = kern
    w0, w1 = spans[0][0], spans[-1][1]
    busy = _covered(merged, w0, w1)
    return {"busy_s": busy, "window_s": w1 - w0,
            "breakdown": _breakdown(events, dev, merged, w0, w1)}


def _breakdown(events, dev, merged, w0, w1) -> dict:
    by_name: dict = {}
    for name, s, e in dev:
        if s >= w0 and e <= w1:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    inside = merged[(merged[:, 1] > w0) & (merged[:, 0] < w1)] if len(merged) else merged
    edges = np.concatenate([[w0], np.clip(inside.ravel(), w0, w1), [w1]]).reshape(-1, 2)
    gaps = [(b - a, a, b) for a, b in edges if b > a]
    gaps = sorted(gaps, reverse=True)[:BREAKDOWN_ENTRIES]
    host = [(s, e, n) for d, n, s, e in events if not d and e > s]
    hs = np.array([s for s, _, _ in host])
    he = np.array([e for _, e, _ in host])
    named = []
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        cover = np.flatnonzero((hs <= mid) & (he >= mid)) if len(hs) else []
        if len(cover):
            k = cover[np.argmin(he[cover] - hs[cover])]  # the innermost span or operator
            named.append([host[k][2], length])
        else:
            named.append(["(no host span)", length])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
