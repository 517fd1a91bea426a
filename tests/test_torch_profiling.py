"""The port's profiling helpers (``snappier_tpu_torch/utils/profiling.py``)
on the CPU: the twin of ``tests/test_utils.py``'s ``Throughput``,
``device_trace`` and metrics tests, and the port's spans: off, one shared
null context that records and allocates nothing; on (``SNAPPIER_METRICS``
or a recording ``torch.profiler``), records with their parents and call
ids in a bounded ring.

``Throughput`` and ``device_trace`` take the device as the port's codec
does: the card by default, which raises without one, or ``device="cpu"``
(the host clock alone; a trace of host activity). On the card,
``tests/test_torch_cuda.py -k device_trace`` holds the trace to the kernels'
names.
"""

from __future__ import annotations

import collections
import gc
import itertools
import json
import threading
import tracemalloc
import types

import pytest
import torch

import snappier_tpu_torch.utils.profiling as prof
from snappier_tpu.utils import profiling as jax_prof


def test_throughput_on_a_cpu_region():
    with prof.Throughput(1_000_000, device="cpu") as t:
        sum(range(1000))
    assert t.seconds > 0 and t.gbps > 0
    assert t.gbps == pytest.approx(1_000_000 / t.seconds / 1e9)
    assert t.device == torch.device("cpu")


def test_device_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    with prof.device_trace(tmp_path / "traces", device="cpu") as p:
        (torch.arange(64) * 3).sum()
    files = sorted((tmp_path / "traces").glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mul" in str(e.get("name")) for e in events)
    assert any("aten::mul" in e.key for e in p.key_averages())
    with prof.device_trace(tmp_path / "traces", device="cpu"):
        pass
    assert len(list((tmp_path / "traces").glob("trace-*.json"))) == 2  # a new file a trace


@pytest.mark.parametrize("helper", ["device_trace", "Throughput"])
def test_default_device_raises_without_a_card(monkeypatch, tmp_path, helper):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if helper == "device_trace":
            with prof.device_trace(tmp_path):
                pass
        else:
            prof.Throughput(1)
    assert not list(tmp_path.glob("trace-*.json"))


@pytest.mark.parametrize("enabled", [False, True])
def test_metrics_enabled_follows_the_flag(monkeypatch, enabled):
    monkeypatch.setattr(prof, "_ENABLED", enabled)
    monkeypatch.setattr(jax_prof, "_ENABLED", enabled)
    assert prof.metrics_enabled() is enabled is jax_prof.metrics_enabled()


def test_public_names_match_the_jax_module():
    public = {n for n in vars(jax_prof) if not n.startswith("_") and callable(vars(jax_prof)[n])}
    assert public == {"device_trace", "Throughput", "metrics_enabled", "timed_call",
                      "metrics_snapshot", "metrics_reset"}
    assert all(callable(getattr(prof, n, None)) for n in public)


def test_span_off_is_one_null_object_that_records_nothing(monkeypatch):
    monkeypatch.setattr(prof, "_ENABLED", False)
    prof.metrics_reset()
    prof.spans_reset()
    null = prof.span("block.fragment")
    assert prof.span("codec.pack", 12, device="cpu") is null
    assert prof.timed_call("block.compress[cuda]", 3) is null
    with null as entered:
        with prof.span("best.candidates", device=torch.device("cpu")):
            pass
    assert entered is null
    assert prof.metrics_snapshot() == {} and prof.spans_snapshot() == []
    assert prof.spans_dropped() == 0


def test_span_off_allocates_nothing(monkeypatch):
    """Off, ``span`` allocates nothing; a ``with`` over it leaves nothing
    behind, and its peak (the interpreter's bound ``__enter__`` and
    ``__exit__``) is the same over 10 spans as over 10,000."""
    monkeypatch.setattr(prof, "_ENABLED", False)
    span, dev = prof.span, torch.device("cpu")

    def calls(loop):
        for _ in loop:
            span("block.fetch", 4, device=dev)

    def spans(loop):
        for _ in loop:
            with span("block.fetch", 4, device=dev):
                pass

    def traced(run, n):
        loop = itertools.repeat(None, n)
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        run(loop)
        now, peak = tracemalloc.get_traced_memory()
        return now - base, peak - base

    for run in (calls, spans):  # warm every path first
        run(itertools.repeat(None, 100))
    tracemalloc.start()
    try:
        assert traced(calls, 10_000) == (0, 0)
        few, many = traced(spans, 10), traced(spans, 10_000)
    finally:
        tracemalloc.stop()
    assert few[0] == many[0] == 0 and many[1] == few[1] <= 256


def test_nested_spans_carry_their_parent_and_one_call_id_a_root(monkeypatch):
    monkeypatch.setattr(prof, "_ENABLED", True)
    prof.metrics_reset()
    prof.spans_reset()
    for _ in range(2):
        with prof.timed_call("root", 100):
            with prof.span("a", 10):
                with prof.span("a.inner"):
                    pass
            with prof.span("b", device="cpu"):
                pass
    other = threading.Thread(target=lambda: prof.span("elsewhere").__enter__().__exit__())
    with prof.span("root"):
        other.start()
        other.join(timeout=30)
    assert not other.is_alive()
    recs = prof.spans_snapshot()
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] == -1]
    assert [r["name"] for r in roots] == ["root", "root", "elsewhere", "root"]
    assert all(r["call"] == r["id"] for r in roots)
    for r in recs:
        if r["parent"] != -1:
            up = by_id[r["parent"]]
            assert r["call"] == up["call"]
            assert up["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= up["t1_ns"]
    first = [r["name"] for r in recs if r["call"] == roots[0]["id"]]
    assert first == ["a.inner", "a", "b", "root"]  # a record is added as its span ends
    names = {r["name"]: r for r in recs}
    assert names["a.inner"]["parent"] == names["a"]["id"]
    assert names["b"]["stream_ms"] is None  # a device span on the CPU: no stream to time
    assert names["a"]["stream_ms"] is None and names["a"]["nbytes"] == 10
    snap = prof.metrics_snapshot()
    assert snap["root"]["calls"] == 3 and snap["root"]["bytes"] == 200 and snap["a"]["calls"] == 2
    prof.metrics_reset()
    prof.spans_reset()


def test_the_ring_drops_and_counts_past_its_size(monkeypatch):
    monkeypatch.setattr(prof, "_ENABLED", True)
    monkeypatch.setattr(prof, "_ring", collections.deque(maxlen=5))
    prof.spans_reset()
    for i in range(8):
        with prof.span(f"s{i}"):
            pass
    assert [r["name"] for r in prof.spans_snapshot()] == ["s3", "s4", "s5", "s6", "s7"]
    assert prof.spans_dropped() == 3
    prof.spans_reset()
    assert prof.spans_snapshot() == [] and prof.spans_dropped() == 0
    assert prof.SPAN_RING >= 90_000 * 2  # a traced 50 s window of the batch codec, with room


def test_the_ring_holds_records_the_collector_does_not_walk(monkeypatch):
    """A full ring of a traced window must not lengthen the collector's
    passes: its records are tuples of numbers and names, which a
    collection stops tracking."""
    monkeypatch.setattr(prof, "_ENABLED", True)
    prof.spans_reset()
    for _ in range(100):
        with prof.span("outer", 8):
            with prof.span("inner", device="cpu"):
                pass
    gc.collect()
    assert len(prof._ring) == 200
    assert all(type(r) is tuple and not gc.is_tracked(r) for r in prof._ring)
    prof.spans_reset()


class _FakeEvent:
    """A CUDA timing event the test completes by hand."""

    made: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.done, self.records = False, 0
        _FakeEvent.made.append(self)

    def record(self, stream):
        self.done, self.records = False, self.records + 1

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return 2.5


def test_device_spans_wait_for_their_end_event_and_reuse_it(monkeypatch):
    """A device span's record enters the ring once the card has reached its
    end event (or a snapshot waits for it), at most ``RESOLVE_STEP`` a
    span's close, and its two events go back to a pool for the next device
    span; the ring keeps the order spans closed."""
    stream = types.SimpleNamespace(device_index=0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(_FakeEvent, "made", [])
    monkeypatch.setattr(prof, "_ENABLED", True)
    monkeypatch.setattr(prof, "_event_pool", collections.defaultdict(list))
    prof.spans_reset()
    made = _FakeEvent.made
    with prof.span("root"):
        for name in ("dev.a", "dev.b"):
            with prof.span(name, device="cuda"):
                pass
    assert [r[1] for r in prof._ring] == ["root"] and len(prof._pending) == 2
    made[1].done = True  # the card reaches dev.a's end; dev.b's not yet
    with prof.span("dev.c", device="cuda"):
        pass
    assert [r[1] for r in prof._ring] == ["root", "dev.a"] and len(prof._pending) == 2
    assert len(made) == 6 and len(prof._event_pool[0]) == 2
    with prof.span("dev.d", device="cuda"):  # takes dev.a's events
        pass
    assert len(made) == 6 and made[0].records == made[1].records == 2
    recs = prof.spans_snapshot()
    assert [r["name"] for r in recs] == ["dev.a", "dev.b", "root", "dev.c", "dev.d"]
    assert [r["stream_ms"] for r in recs] == [2.5, 2.5, None, 2.5, 2.5]
    assert not prof._pending and len(prof._event_pool[0]) == 6
    assert prof.spans_dropped() == 0
    monkeypatch.setattr(prof, "PENDING_MAX", 2)
    prof.spans_reset()
    for _ in range(3):  # past the bound the oldest is waited for
        with prof.span("dev.e", device="cuda"):
            pass
    assert len(prof._pending) == 2 and len(prof._ring) == 1
    monkeypatch.setattr(prof, "PENDING_MAX", 4096)
    prof.spans_reset()
    for _ in range(4):  # a backlog the card has passed drains a step a span
        with prof.span("dev.f", device="cuda"):
            pass
    for ev in made:
        ev.done = True
    with prof.span("dev.g", device="cuda"):
        pass
    assert len(prof._ring) == prof.RESOLVE_STEP == 2 and len(prof._pending) == 3
    assert len(prof.spans_snapshot()) == 5 and not prof._pending
    prof.spans_reset()


def test_a_recording_profiler_turns_the_spans_on(monkeypatch):
    monkeypatch.setattr(prof, "_ENABLED", False)
    prof.spans_reset()
    assert prof.metrics_enabled() is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        assert prof.metrics_enabled() is True
        with prof.span("outer"):
            with prof.span("inner"):
                (torch.arange(64) * 3).sum()
    assert prof.metrics_enabled() is False
    assert [r["name"] for r in prof.spans_snapshot()] == ["inner", "outer"]
    ev = {e.name: e for e in p.events() if e.name in ("outer", "inner")}
    assert set(ev) == {"outer", "inner"}
    assert ev["outer"].time_range.start <= ev["inner"].time_range.start
    assert ev["inner"].time_range.end <= ev["outer"].time_range.end
    prof.spans_reset()
