"""The readers of the program's spans (``portbench/spans.py`` and the seven
metrics over it) on a made-up span store, and each cell's tiny traced run
on the CPU, where the program records its spans under the profiler (host
times only: a device time is the card's stream's)."""

from __future__ import annotations

import pytest

from portbench_tiny import REPO, run_tiny, tiny_root
from portbench import run
from snappier_tpu_torch.utils import profiling

#: metric -> (span, cell, host or device time)
READERS = {
    "fragment_ms.facade": ("block.fragment", "facade-best-corpus", "host"),
    "copy_in_ms.facade": ("block.copy_in", "facade-best-corpus", "host"),
    "wait_ms.facade": ("block.wait", "facade-best-corpus", "host"),
    "fetch_ms.facade": ("block.fetch", "facade-best-corpus", "host"),
    "join_ms.facade": ("block.join", "facade-best-corpus", "host"),
    "candidates_ms.best": ("best.candidates", "facade-best-corpus", "device"),
    "pack_ms.compress": ("codec.pack", "block-corpus", "device"),
}


class Rec:
    """The window: two compress phases of 3 and 1 calls with a decompress
    phase between, 10 s to 13 s on the host clock."""

    phases = [{"kind": "compress", "t0": 10.0, "t1": 11.0, "calls": 3},
              {"kind": "decompress", "t0": 11.0, "t1": 12.0, "calls": 7},
              {"kind": "compress", "t0": 12.0, "t1": 13.0, "calls": 1}]


def _record(name, t0_s, host_ms, stream_ms, i):
    t0 = int(t0_s * 1e9)
    return {"name": name, "id": i, "parent": -1, "call": i, "t0_ns": t0,
            "t1_ns": t0 + int(host_ms * 1e6), "nbytes": 0, "stream_ms": stream_ms}


def _store(span):
    """Four records of ``span`` inside the window (host 1, 2, 3, 6 ms;
    device 0.5 ms each), one of another span inside it, one of ``span``
    before it and one ending after it."""
    inside = [_record(span, t, h, 0.5, i)
              for i, (t, h) in enumerate([(10.1, 1), (10.5, 2), (12.2, 3), (12.9, 6)])]
    return inside + [_record("other", 10.2, 50, 9.0, 10), _record(span, 9.99, 1, 7.0, 11),
                     _record(span, 12.9999, 1, 7.0, 12)]


def _reader(name):
    return run.load_module(REPO / "portbench" / "metrics" / f"{name}.py")


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_on_a_made_up_span_store(monkeypatch, metric):
    span, cell, kind = READERS[metric]
    dropped = [0]
    monkeypatch.setattr(profiling, "spans_snapshot", lambda: _store(span))
    monkeypatch.setattr(profiling, "spans_dropped", lambda: dropped[0])
    want = 12.0 / 4 if kind == "host" else 2.0 / 4  # over the 4 compress calls
    assert _reader(metric).read(Rec()) == pytest.approx(want)
    dropped[0] = 1
    assert _reader(metric).read(Rec()) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_nothing_without_the_spans(monkeypatch, metric):
    span, _, kind = READERS[metric]
    monkeypatch.setattr(profiling, "spans_dropped", lambda: 0)
    monkeypatch.setattr(profiling, "spans_snapshot", lambda: [
        r for r in _store(span) if r["name"] != span or r["id"] >= 10])
    assert _reader(metric).read(Rec()) is None  # none inside the window
    if kind == "device":
        monkeypatch.setattr(profiling, "spans_snapshot", lambda: [
            dict(r, stream_ms=None) for r in _store(span)])
        assert _reader(metric).read(Rec()) is None  # a span with no device time
    monkeypatch.delattr(profiling, "spans_snapshot")  # a program that keeps no spans
    assert _reader(metric).read(Rec()) is None


@pytest.mark.parametrize("cell", ["block-corpus", "facade-best-corpus"])
def test_span_metrics_in_a_tiny_traced_run(tmp_path, cell):
    r = run_tiny(tiny_root(tmp_path), cell, traced=True)
    assert r["correct"]
    new = {m for m, (_, c, _) in READERS.items() if c == cell}
    host = {m for m in new if READERS[m][2] == "host"}
    assert host <= set(r["metrics"])
    assert all(r["metrics"][m]["value"] > 0 and r["metrics"][m]["unit"] == "ms" for m in host)
    assert not (new - host) & set(r["metrics"])  # no stream on the CPU: the device readers read None
    recorded = {rec["name"] for rec in profiling.spans_snapshot()}
    assert {READERS[m][0] for m in new} <= recorded
    assert profiling.spans_dropped() == 0
    profiling.spans_reset()
