"""Parity of the port's public block facade (``snappier_tpu_torch`` ->
``runtime/block.py``), its native bindings and its prescan with the JAX
package's.

The port runs with ``device="cpu"`` (each kernel's plain version). Off a
TPU the JAX facade picks its scan encoder, so the byte-equality tests pin
it to the scalar kernels (the ones the port ports) by patching
``snappier_tpu.runtime.block._device_kernel`` and clearing the caches that
captured it; the JAX package itself is untouched. Tolerance is exact
equality.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import snappier_tpu as jst
import snappier_tpu.runtime.block as jblock
import snappier_tpu_torch as st
from snappier_tpu.runtime import native as jnative
from snappier_tpu.runtime import prescan as jprescan
from snappier_tpu_torch.format.varint import write_varint
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.runtime import block, native, prescan
from snappier_tpu_torch.utils import profiling
from tests.test_match_length import VECTORS, _layout
from tests.test_prescan import _window_crossing_stream
from tests.torch_cases import html_like

CPU = {"device": "cpu"}
_CACHED = ("_encode_batch_fn", "_encode_compact_fn", "_decode_batch_fn",
           "_decode_batch_packed_fn", "_decode_compact_fn")


@pytest.fixture
def jax_scalar(monkeypatch):
    """The JAX facade's device engine on its scalar kernels, restored (and
    its caches cleared again) afterwards."""
    for name in _CACHED:
        getattr(jblock, name).cache_clear()
    monkeypatch.setattr(jblock, "_device_kernel", lambda: "scalar")
    yield
    monkeypatch.undo()
    for name in _CACHED:
        getattr(jblock, name).cache_clear()


def _small_inputs():
    rng = np.random.default_rng(21)
    return [
        b"",
        b"a",
        b"hello hello hello hello hello",
        html_like(16384, 2).tobytes(),
        html_like(9000, 3).tobytes(),
        rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
        bytes(12000),
        bytes(range(1, 8)) * 1000,
    ]


def _multi_fragment(seed: int = 4) -> bytes:
    """About 150 KB (three fragments) of markup with a random stretch."""
    rng = np.random.default_rng(seed)
    return (html_like(100_000, seed).tobytes()
            + rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes()
            + html_like(30_000, seed + 1).tobytes())


@pytest.mark.parametrize("level", ["fast", "best"])
def test_compress_matches_jax_bytes(jax_scalar, level):
    for data in _small_inputs():
        ref = jst.compress(data, engine="tpu", level=level)
        got = st.compress(data, level=level, **CPU)
        assert got == ref, (level, len(data))
        assert st.decompress(got, **CPU) == data


def test_best_is_no_larger_than_fast():
    data = _multi_fragment()
    fast = st.compress(data, **CPU)
    best = st.compress(data, level="best", **CPU)
    assert len(best) <= len(fast)


@pytest.mark.parametrize("level", ["fast", "best"])
def test_multi_fragment_round_trip(level):
    data = _multi_fragment()
    _build.reset_launches()
    comp = st.compress(data, level=level, **CPU)
    assert st.decompress(comp, **CPU) == data
    assert jst.decompress(comp, engine="oracle") == data
    if jnative.available():
        assert jst.decompress(comp, engine="native") == data
    assert sum(_build.LAUNCHES.values()) == 0  # CPU: the plain versions only


def test_multi_fragment_decode_of_reference_streams():
    data = _multi_fragment(7)
    for comp in (jst.compress(data, engine="oracle"), _straddling_literal_stream(data)):
        assert st.decompress(comp, **CPU) == data


def _straddling_literal_stream(data: bytes) -> bytes:
    """One literal over several 64 KiB output lines (split by the prescan
    into synthetic lead and tail literals)."""
    return (write_varint(len(data)) + bytes([(59 + 4) << 2])
            + (len(data) - 1).to_bytes(4, "little") + data)


def test_window_crossing_stream_decodes_on_the_host():
    comp, full = _window_crossing_stream()
    assert prescan.scan_fragments(np.frombuffer(comp, np.uint8)) is None
    assert st.decompress(comp, **CPU) == full == jst.decompress(comp, engine="oracle")
    out = bytearray(len(full))
    assert st.decompress_into(comp, out, **CPU) == len(full) and bytes(out) == full


@pytest.mark.parametrize("engine", ["native", "oracle"])
def test_host_engines_match_jax(engine):
    if engine == "native" and not native.available():
        pytest.skip("native runtime unavailable")
    for data in _small_inputs() + [_multi_fragment()]:
        comp = st.compress(data, engine=engine)
        assert comp == jst.compress(data, engine=engine)
        assert st.decompress(comp, engine=engine) == data


def test_into_try_and_memory_match_jax(jax_scalar):
    data = html_like(12000, 9).tobytes()
    ref = jst.compress(data, engine="tpu")
    for engine in ("auto", "cuda", "oracle"):
        out = bytearray(st.get_max_compressed_length(len(data)))
        n = st.compress_into(data, out, engine=engine, **CPU)
        assert bytes(out[:n]) == (ref if engine != "oracle" else jst.compress(data, "oracle"))
        assert st.try_compress(data, out, engine=engine, **CPU) == (True, n)
        plain = np.zeros(len(data), np.uint8)
        assert st.decompress_into(bytes(out[:n]), plain, engine=engine, **CPU) == len(data)
        assert plain.tobytes() == data
        assert st.try_decompress(bytes(out[:n]), bytearray(len(data)), engine=engine,
                                 **CPU) == (True, len(data))
    small = bytearray(10)
    assert st.try_compress(data, small, **CPU) == jst.try_compress(data, small) == (False, 0)
    assert st.try_decompress(ref, small, **CPU) == jst.try_decompress(ref, small) == (False, 0)
    # The minimum-size check passes, the real result does not fit.
    tight = bytearray(len(ref) - 1)
    assert st.try_compress(data, tight, **CPU) == (False, 0)
    assert jst.try_compress(data, bytearray(len(ref) - 1), engine="tpu") == (False, 0)

    with st.compress_to_memory(data, **CPU) as m:
        assert bytes(m) == ref == bytes(jst.compress_to_memory(data, engine="tpu"))
    with pytest.raises(st.InvalidOperationError):
        m.memory
    with st.decompress_to_memory(ref, **CPU) as m:
        assert bytes(m) == data == bytes(jst.decompress_to_memory(ref, engine="oracle"))
    # An int32 destination gets one byte per element, as on every engine.
    wide = np.zeros(len(data), np.int32)
    assert st.decompress_into(ref, wide, **CPU) == len(data)
    assert (wide == np.frombuffer(data, np.uint8)).all()


def test_size_queries_match_jax():
    for n in (0, 1, 59, 60, 65535, 65536, 1 << 20, (1 << 32) - 1):
        assert st.get_max_compressed_length(n) == jst.get_max_compressed_length(n)
    for data in _small_inputs():
        comp = jst.compress(data, engine="oracle")
        assert st.get_uncompressed_length(comp) == jst.get_uncompressed_length(comp) == len(data)


def _corrupt_inputs():
    good = jst.compress(html_like(3000, 1).tobytes(), engine="oracle")
    big = jst.compress(_multi_fragment(), engine="oracle")
    return [
        b"",  # no preamble
        b"\xff\xff\xff\xff\xff\xff",  # varint too long
        good[:-5],  # truncated tail
        good[:1] + b"\x00" + good[2:],  # tags no longer match the preamble
        bytes([0x80, 0x80, 0x04]) + b"\x00" * 8,  # claim far past what 8 bytes hold
        bytes([8, (4 - 1) << 2]) + b"abcd" + bytes([1, 5]),  # offset past the output
        big[:-3],  # multi-fragment, truncated
        (write_varint(150_000) + bytes([(59 + 3) << 2]) + (69_999).to_bytes(3, "little")
         + bytes(70_000) + bytes([1, 0])),  # multi-fragment, a copy with offset 0
    ]


@pytest.mark.parametrize("engine", ["cuda", "native", "oracle"])
def test_corrupt_input_raises_like_jax(engine):
    if engine == "native" and not native.available():
        pytest.skip("native runtime unavailable")
    jengine = "oracle" if engine == "cuda" else engine
    for comp in _corrupt_inputs():
        with pytest.raises(jst.InvalidDataError):
            jst.decompress(comp, engine=jengine)
        with pytest.raises(st.InvalidDataError):
            st.decompress(comp, engine=engine, **CPU)
        with pytest.raises(st.InvalidDataError):
            st.decompress_into(comp, bytearray(1 << 20), engine=engine, **CPU)


def test_buffer_and_overlap_errors_match_jax():
    data = html_like(4000, 5).tobytes()
    comp = jst.compress(data, engine="oracle")
    for fn, args in [(st.compress_into, (data, bytearray(3))),
                     (st.decompress_into, (comp, bytearray(10)))]:
        with pytest.raises(st.BufferTooSmallError):
            fn(*args, **CPU)
    with pytest.raises(jst.BufferTooSmallError):
        jst.compress_into(data, bytearray(3))
    with pytest.raises(jst.BufferTooSmallError):
        jst.decompress_into(comp, bytearray(10))
    buf = bytearray(20000)
    buf[:4000] = data
    src, dst = memoryview(buf)[:4000], memoryview(buf)[2000:]
    for mod in (st, jst):
        with pytest.raises(mod.InvalidOperationError):
            mod.compress_into(src, dst)
        with pytest.raises(mod.InvalidOperationError):
            mod.try_decompress(memoryview(buf)[:100], memoryview(buf)[50:])


def test_argument_errors_match_jax():
    for mod in (st, jst):
        with pytest.raises(ValueError):
            mod.compress(b"x", level="max")
        with pytest.raises(ValueError):
            mod.compress(b"x", engine="native", level="best")
    with pytest.raises(ValueError):
        st.compress(b"x", engine="tpu")  # the port's device engine is "cuda"


def test_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    comp = st.compress(b"abc" * 50, engine="oracle")
    for call in (lambda: st.compress(b"abc"), lambda: st.compress(b"abc", level="best"),
                 lambda: st.decompress(comp), lambda: st.compress_into(b"abc", bytearray(64)),
                 lambda: block.compress_fragments(np.zeros((1, 64), np.uint8), [64])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert st.decompress(comp, engine="oracle") == b"abc" * 50


def test_compress_fragments_matches_jax(jax_scalar):
    frags = np.stack([html_like(65536, 6), np.zeros(65536, np.uint8)])
    lens = np.array([30000, 70], np.int32)
    for kernel in (None, "best"):
        rb, rl = (np.asarray(x) for x in jblock.compress_fragments(frags, lens, kernel=kernel))
        gb, gl = block.compress_fragments(frags, lens, kernel=kernel, **CPU)
        assert gb.dtype == torch.uint8 and gb.shape == rb.shape
        assert (gl.numpy() == rl).all()
        for i, n in enumerate(rl):
            assert (gb.numpy()[i, :n] == rb[i, :n]).all()
    comp = np.zeros((2, 32768), np.uint8)
    comp_lens = np.zeros(2, np.int32)
    for i, n in enumerate(lens):
        blk = write_varint(int(n)) + gb.numpy()[i, : int(gl[i])].tobytes()
        comp[i, : len(blk)] = np.frombuffer(blk, np.uint8)
        comp_lens[i] = len(blk)
    ref = [np.asarray(x) for x in jblock.decompress_blocks(comp, comp_lens, 32768)]
    got = [x.numpy() for x in block.decompress_blocks(comp, comp_lens, 32768, **CPU)]
    assert (got[1] == ref[1]).all() and (got[2] == ref[2]).all() and (got[1] == lens).all()
    for i, n in enumerate(lens):
        assert (got[0][i, :n] == ref[0][i, :n]).all()
        assert (got[0][i, :n] == frags[i, :n]).all()
    # The scan engine is ported too (tests/test_torch_scan_codec.py holds it
    # against the JAX one): its bodies decode, and are no larger than greedy.
    sb, sl = block.compress_fragments(frags, lens, kernel="scan", **CPU)
    assert sb.dtype == torch.uint8 and sb.shape == gb.shape
    for i, n in enumerate(lens):
        blk = write_varint(int(n)) + sb.numpy()[i, : int(sl[i])].tobytes()
        assert st.decompress(blk, engine="oracle") == frags[i, :n].tobytes()
    assert (sl <= block.compress_fragments(frags, lens, kernel="scalar", **CPU)[1]).all()
    with pytest.raises(ValueError):
        block.compress_fragments(frags, lens, kernel="nope", **CPU)
    with pytest.raises(RuntimeError):
        block.check_body_lens(10, np.array([11]))


def test_metrics_snapshot_counts_calls(monkeypatch):
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.metrics_reset()
    st.decompress(st.compress(b"abc" * 100, engine="oracle"), engine="oracle")
    snap = profiling.metrics_snapshot()
    profiling.metrics_reset()
    assert snap["block.compress[oracle]"]["calls"] == 1
    assert snap["block.decompress[oracle]"]["bytes"] > 0


def test_native_match_length_matches_jax():
    if not (native.available() and jnative.available()):
        pytest.skip("native runtime unavailable")
    for expected, s1, s2, length in VECTORS:
        buf, at, n = _layout(s1, s2, length)
        assert native.match_length_test(buf, 0, at, n) == expected
        assert native.match_length_test(buf, 0, at, n) == jnative.match_length_test(buf, 0, at, n)


def test_prescan_records_match_jax():
    data = _multi_fragment(3)
    streams = [jst.compress(data, engine="oracle"), _straddling_literal_stream(data),
               st.compress(data, level="best", **CPU)]
    for comp in streams:
        arr = np.frombuffer(comp, np.uint8)
        ref = jprescan.scan_fragments_py(arr)
        got = prescan.scan_fragments_py(arr)
        assert (got == ref).all() and len(got) == 3
        if native.available():
            assert (prescan.scan_fragments(arr) == ref).all()
        for a, b in zip(prescan.assemble_fragment_rows(arr, got),
                        jprescan.assemble_fragment_rows(arr, ref)):
            assert (np.asarray(a) == np.asarray(b)).all()


FACADE_STEPS = ["block.fragment", "block.copy_in", "block.encode", "block.wait", "block.fetch",
                "block.join"]


def test_facade_span_tree_under_the_cpu_profiler(monkeypatch):
    """A recording profiler turns the spans on: the best-level facade call
    is one root with its six steps in order, the candidate search inside
    the encode step, both in the span records and in the profiler's user
    annotations, each child inside its root and the steps covering at least
    95% of the root's host time."""
    monkeypatch.setattr(profiling, "_ENABLED", False)
    profiling.spans_reset()
    data = _multi_fragment(1)[: 65536 + 4000]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        out = st.compress(data, level="best", **CPU)
    assert st.decompress(out, engine="oracle") == data
    recs = profiling.spans_snapshot()
    profiling.spans_reset()
    (root,) = [r for r in recs if r["parent"] == -1]
    assert root["name"] == "block.compress[cuda]" and root["nbytes"] == len(data)
    assert all(r["call"] == root["id"] for r in recs)
    steps = sorted((r for r in recs if r["parent"] == root["id"]), key=lambda r: r["t0_ns"])
    assert [r["name"] for r in steps] == FACADE_STEPS
    (cand,) = [r for r in recs if r["name"] == "best.candidates"]
    assert cand["parent"] == steps[2]["id"]
    for r in recs:
        assert root["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= root["t1_ns"]
    covered = sum(r["t1_ns"] - r["t0_ns"] for r in steps)
    assert covered >= 0.95 * (root["t1_ns"] - root["t0_ns"])

    ann = [e for e in p.events() if e.name.startswith(("block.", "best."))]
    assert sorted(e.name for e in ann) == sorted(r["name"] for r in recs)
    (top,) = [e for e in ann if e.name == root["name"]]
    kids = sorted((e for e in ann if e.name in FACADE_STEPS), key=lambda e: e.time_range.start)
    assert [e.name for e in kids] == FACADE_STEPS
    for e in ann:
        assert top.time_range.start <= e.time_range.start <= e.time_range.end <= top.time_range.end
    assert sum(e.time_range.elapsed_us() for e in kids) >= 0.95 * top.time_range.elapsed_us()
    assert st.compress(data, level="best", **CPU) == out  # the profiler is gone: no spans
    assert profiling.spans_snapshot() == []
