"""The readers of the codec's walk spans, ``encode_ms.compress``
(``codec.encode`` a compress call) and ``decode_ms.decompress``
(``codec.decode`` a decompress call), on a made-up span store, and the
block cells' tiny traced runs on the CPU, where the program records both
spans with no device time; the reader of the encode kernel's table width,
``encode_table_bits``, on made-up launch counts."""

from __future__ import annotations

import collections

import pytest

from portbench_tiny import REPO, run_tiny, tiny_root
from portbench import run
from snappier_tpu_torch.utils import profiling

#: metric -> (span, kind of call)
READERS = {"encode_ms.compress": ("codec.encode", "compress"),
           "decode_ms.decompress": ("codec.decode", "decompress")}


class Rec:
    """The window: compress phases of 3 and 1 calls around a decompress
    phase of 4, 10 s to 13 s on the host clock."""

    phases = [{"kind": "compress", "t0": 10.0, "t1": 11.0, "calls": 3},
              {"kind": "decompress", "t0": 11.0, "t1": 12.0, "calls": 4},
              {"kind": "compress", "t0": 12.0, "t1": 13.0, "calls": 1}]


def _record(name, t0_s, stream_ms, i):
    t0 = int(t0_s * 1e9)
    return {"name": name, "id": i, "parent": -1, "call": i, "t0_ns": t0,
            "t1_ns": t0 + 1_000_000, "nbytes": 0, "stream_ms": stream_ms}


def _store():
    """Inside the window: four ``codec.encode`` records (0.5 ms of stream
    each), four ``codec.decode`` (0.25 ms each) and a ``codec.pack``
    (9 ms); outside it, one of each walk before and one ending after."""
    recs = [_record("codec.encode", t, 0.5, i) for i, t in enumerate([10.1, 10.4, 10.7, 12.5])]
    recs += [_record("codec.decode", t, 0.25, 4 + i) for i, t in enumerate([11.1, 11.3, 11.5, 11.7])]
    recs.append(_record("codec.pack", 10.2, 9.0, 8))
    for i, name in enumerate(("codec.encode", "codec.decode")):
        recs += [_record(name, 9.99, 7.0, 10 + i), _record(name, 12.9995, 7.0, 12 + i)]
    return recs


def _reader(name):
    return run.load_module(REPO / "portbench" / "metrics" / f"{name}.py")


@pytest.mark.parametrize("metric,want", [("encode_ms.compress", 0.5),
                                         ("decode_ms.decompress", 0.25)])
def test_walk_reader_reads_its_span_per_call_of_its_kind(monkeypatch, metric, want):
    dropped = [0]
    monkeypatch.setattr(profiling, "spans_snapshot", _store)
    monkeypatch.setattr(profiling, "spans_dropped", lambda: dropped[0])
    assert _reader(metric).read(Rec()) == pytest.approx(want)  # 4 records over 4 calls
    dropped[0] = 1
    assert _reader(metric).read(Rec()) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_walk_reader_reads_nothing_without_its_span(monkeypatch, metric):
    span, _ = READERS[metric]
    monkeypatch.setattr(profiling, "spans_dropped", lambda: 0)
    monkeypatch.setattr(profiling, "spans_snapshot", lambda: [
        r for r in _store() if r["name"] != span or r["id"] >= 10])
    assert _reader(metric).read(Rec()) is None  # none inside the window
    monkeypatch.setattr(profiling, "spans_snapshot", lambda: [
        dict(r, stream_ms=None) for r in _store()])
    assert _reader(metric).read(Rec()) is None  # a span with no device time
    monkeypatch.delattr(profiling, "spans_snapshot")  # a program that keeps no spans
    assert _reader(metric).read(Rec()) is None


@pytest.mark.parametrize("cell", ["block-corpus", "block-rocksdb-4k"])
def test_walk_spans_in_a_tiny_traced_run(tmp_path, cell):
    profiling.spans_reset()
    r = run_tiny(tiny_root(tmp_path), cell, traced=True)
    assert r["correct"]
    assert not set(READERS) & set(r["metrics"])  # no stream on the CPU: both read None
    recs = profiling.spans_snapshot()
    for span, kind in READERS.values():
        mine = [x for x in recs if x["name"] == span]
        assert mine and all(x["stream_ms"] is None for x in mine)
    assert profiling.spans_dropped() == 0
    profiling.spans_reset()


def test_table_bits_reader_reads_the_launches_mean_width(monkeypatch):
    from snappier_tpu_torch.ops.cuda import _build

    reader = _reader("encode_table_bits")
    monkeypatch.setattr(_build, "ENCODE_TABLE_BITS", collections.Counter({13: 3}))
    assert reader.read(Rec()) == 13
    monkeypatch.setattr(_build, "ENCODE_TABLE_BITS", collections.Counter({13: 1, 15: 3}))
    assert reader.read(Rec()) == pytest.approx(14.5)
    monkeypatch.setattr(_build, "ENCODE_TABLE_BITS", collections.Counter())
    assert reader.read(Rec()) is None  # no encode kernel launched (the CPU's plain walk)
    monkeypatch.delattr(_build, "ENCODE_TABLE_BITS")  # a program that keeps no such count
    assert reader.read(Rec()) is None
