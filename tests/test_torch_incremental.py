"""Parity of the port's incremental block decoder and iterator APIs
(``snappier_tpu_torch/runtime/incremental.py``) with
``snappier_tpu.runtime.incremental``, the mid-stream hand-over through
``convert.stream_from_reference``, and the framing layer's verdicts on
the mutation set of ``tests/test_stream_mutation_parity.py``.

The same seeded bytes go through both packages; outputs, internal state
and error classes must be equal (tolerance: none). The port's device
engine runs with ``device="cpu"``.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

import snappier_tpu as jst
import snappier_tpu.runtime.incremental as jinc
import snappier_tpu.runtime.stream as jstream
import snappier_tpu_torch as st
import snappier_tpu_torch.runtime.stream as S
from snappier_tpu_torch.constants import STREAM_HEADER
from snappier_tpu_torch.convert import stream_from_reference
from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.format.varint import write_varint
from snappier_tpu_torch.runtime import native
from snappier_tpu_torch.runtime.incremental import (
    BlockDecompressor,
    compress_iter,
    decompress_iter,
)
from tests.test_stream_mutation_parity import _mutants
from tests.torch_cases import html_like

CPU = {"device": "cpu"}
_STATE = ("_pre", "_expected", "_out", "_base", "_tail", "_remaining_literal", "_read_pos",
          "_extracted")


def _state(d) -> tuple:
    return tuple(bytes(v) if isinstance(v, (bytes, bytearray)) else v
                 for v in (getattr(d, k) for k in _STATE))


def _mixed(n: int = 9000, seed: int = 2) -> bytes:
    rng = np.random.default_rng(seed)
    return (html_like(n, seed).tobytes() + rng.integers(0, 256, 400, dtype=np.uint8).tobytes()
            + b"abcabcabcabc" * 30 + bytes(100) + b"tail")


def test_every_split_point_matches_reference():
    data = b"abcabcabcabc" * 30 + bytes(100) + html_like(300, 1).tobytes() + b"tail"
    comp = oracle.compress(data)
    for split in range(1, len(comp)):
        d, j = BlockDecompressor(), jinc.BlockDecompressor()
        assert d.decompress(comp[:split]) == j.decompress(comp[:split])
        assert _state(d) == _state(j), split
        assert d.decompress(comp[split:]) == j.decompress(comp[split:])
        d.finish()
        assert d.extract_data() == data == j.extract_data(), split


def test_varint_byte_at_a_time():
    data = _mixed(20000)
    comp = oracle.compress(data)
    assert len(write_varint(len(data))) == 3
    d, j = BlockDecompressor(), jinc.BlockDecompressor()
    for i in range(len(comp)):
        assert d.decompress(comp[i : i + 1]) == j.decompress(comp[i : i + 1])
        assert d.expected_length == j.expected_length == (len(data) if i >= 2 else None)
    assert d.all_data_decompressed and j.all_data_decompressed
    assert d.extract_data() == data


def test_long_literal_across_feeds():
    data = np.random.default_rng(1).integers(0, 256, 70000, np.uint8).tobytes()
    comp = oracle.compress(data)  # long literals with extra length bytes
    d, j = BlockDecompressor(), jinc.BlockDecompressor()
    for i in range(0, len(comp), 17):
        d.decompress(comp[i : i + 17])
        j.decompress(comp[i : i + 17])
        assert d._remaining_literal == j._remaining_literal
    assert d.extract_data() == data


def test_read_drain_and_lifecycle_errors():
    data = b"drain me " * 1000
    d = BlockDecompressor()
    with pytest.raises(st.InvalidOperationError):
        d.extract_data()  # nothing decompressed yet
    d.decompress(oracle.compress(data))
    out = bytearray()
    while piece := d.read(123):
        out += piece
    assert out == data
    with pytest.raises(st.InvalidOperationError):
        d.extract_data()  # partial reads forbid extraction
    with pytest.raises(st.InvalidOperationError):
        d.drain_to(lambda b: None, 0)
    d = BlockDecompressor()
    d.decompress(oracle.compress(b"xy"))
    assert d.extract_data() == b"xy"
    for call in (d.extract_data, lambda: d.decompress(b"\x00")):
        with pytest.raises(st.InvalidOperationError):
            call()  # double extract, feed after drain


_CORRUPT_FEEDS = {
    "overlong_varint": [b"\xff\xff\xff\xff\xff\x01"],
    "varint_overflow": [b"\xff\xff\xff\xff\x7f"],
    "copy_before_output": [bytes([4]), bytes([1, 1])],
    "trailing_garbage": [oracle.compress(b"full"), b"\x00"],
    "literal_overrun": [bytes([2, 3 << 2]) + b"abcd"],
    "copy_overrun": [bytes([5, 3 << 2]) + b"abcd" + bytes([1, 4])],
    "stuck_tail": [bytes([40]), bytes([0xFC]) * 9],
}


@pytest.mark.parametrize("name", sorted(_CORRUPT_FEEDS))
def test_corrupt_feeds_raise_like_reference(name):
    def run(d):
        for piece in _CORRUPT_FEEDS[name]:
            d.decompress(piece)

    with pytest.raises(jst.InvalidDataError) as r:
        run(jinc.BlockDecompressor())
    with pytest.raises(st.InvalidDataError) as p:
        run(BlockDecompressor())
    assert str(p.value) == str(r.value)


@pytest.mark.parametrize("feed", [b"", b"\x80", bytes([2, 0]) + b"a", bytes([3, 0xF0, 1])])
def test_finish_rejects_truncated_streams_like_reference(feed):
    d, j = BlockDecompressor(), jinc.BlockDecompressor()
    d.decompress(feed)
    j.decompress(feed)
    with pytest.raises(jst.InvalidDataError) as r:
        j.finish()
    with pytest.raises(st.InvalidDataError) as p:
        d.finish()
    assert str(p.value) == str(r.value)


def test_scratch_hooks_match_reference():
    """The scratch-poisoning regression (SnappyDecompressorTests.cs:42-58):
    only the first ``length`` bytes of a loaded scratch are live."""
    for scratch, length, feed in (([222, 222, 222, 222, 0, 0], 0, [150, 255, 0]),
                                  ([150, 255, 222, 222, 222, 222], 2, [0])):
        pair = BlockDecompressor(), jinc.BlockDecompressor()
        for d in pair:
            d.set_expected_length_for_test(1024)
            d.write_to_buffer_for_test(bytes(range(255)))
            d.load_scratch_for_test(bytes(scratch), length)
            assert d.decompress(bytes(feed)) == 38  # copy-2: length 38, offset 255
            assert not d.all_data_decompressed
        assert _state(pair[0]) == _state(pair[1])
        assert pair[0].read(-1)[-38:] == bytes(range(38))
    with pytest.raises(ValueError):
        BlockDecompressor().load_scratch_for_test(bytes(16), 16)


@pytest.mark.parametrize("engine", ["cuda", "oracle", "native"])
def test_compress_iter_matches_one_shot_and_reference(engine):
    if engine == "native" and not native.available():
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(11)
    parts = [html_like(70_001, 5).tobytes(),
             rng.integers(0, 256, 66_000, dtype=np.uint8).tobytes(), b"z" * 30_000, b"", b"q" * 77]
    whole = b"".join(parts)
    consumed = []

    def gen():
        for p in parts:
            consumed.append(len(p))
            yield p

    comp = compress_iter(gen(), engine=engine, batch_blocks=1, **CPU)
    assert comp == st.compress(whole, engine=engine, **CPU)
    if engine != "cuda":
        assert comp == jinc.compress_iter(parts, engine=engine, batch_blocks=1)
    assert sum(consumed) == len(whole)
    pieces = [comp[i : i + 999] for i in range(0, len(comp), 999)]
    assert decompress_iter(pieces) == whole == jinc.decompress_iter(pieces)
    assert compress_iter([], engine=engine, **CPU) == st.compress(b"", engine=engine, **CPU)
    assert compress_iter([b"", b"a", b""], engine=engine, **CPU) == st.compress(
        b"a", engine=engine, **CPU)


def test_compress_iter_writer_mode():
    data = _mixed(150_000, 7)
    chunks = [data[i : i + 30_000] for i in range(0, len(data), 30_000)]
    ref = compress_iter(chunks, engine="oracle", batch_blocks=1)
    assert ref == jinc.compress_iter(chunks, engine="oracle", batch_blocks=1)
    sink = io.BytesIO()
    assert compress_iter(chunks, engine="oracle", batch_blocks=1, writer=sink) == len(ref)
    assert sink.getvalue() == ref
    pieces: list[bytes] = []
    n = compress_iter(iter(chunks), engine="oracle", writer=pieces.append, total_length=len(data))
    assert n == len(ref) and b"".join(pieces) == ref
    with pytest.raises(st.InvalidOperationError):  # a generator has no length to promise
        compress_iter((c for c in chunks), engine="oracle", writer=lambda b: None)
    with pytest.raises(st.InvalidOperationError):  # a lying total_length is caught
        compress_iter(iter(chunks), engine="oracle", writer=lambda b: None, total_length=5)


def test_decompress_iter_writer_mode_and_lookback_window():
    data = _mixed(200_000, 9)
    comp = st.compress(data, engine="oracle")
    for step in (1_000, 100_000):
        chunks = [comp[i : i + step] for i in range(0, len(comp), step)]
        pieces: list[bytes] = []
        assert decompress_iter(chunks, writer=pieces.append) == len(data)
        assert b"".join(pieces) == data
        assert max(len(p) for p in pieces) <= step * 70  # streamed, not held to the end
    buf = io.BytesIO()
    assert decompress_iter([comp], writer=buf) == len(data) and buf.getvalue() == data

    lit = bytes(range(256)) * 280  # 71,680 literal bytes, then a copy-4 at offset 70,000
    stream = (write_varint(len(lit) + 8) + bytes([(59 + 3) << 2])
              + (len(lit) - 1).to_bytes(3, "little") + lit
              + bytes([(8 - 1) << 2 | 3]) + (70000).to_bytes(4, "little"))
    expect = lit + lit[len(lit) - 70000 : len(lit) - 70000 + 8]
    chunks = [stream[i : i + 4096] for i in range(0, len(stream), 4096)]
    assert decompress_iter(chunks) == expect == jinc.decompress_iter(chunks)
    for mod, err in ((decompress_iter, st.InvalidOperationError),
                     (jinc.decompress_iter, jst.InvalidOperationError)):
        with pytest.raises(err):
            mod(chunks, writer=lambda b: None)
    pieces = []
    assert decompress_iter(chunks, writer=pieces.append, lookback=131072) == len(expect)
    assert b"".join(pieces) == expect


# --- hand-over of a reference object taken mid-stream ---------------------------


@pytest.mark.parametrize("cut", [0, 1, 2, 3, 100, 2000, 5000])
def test_block_decompressor_hand_over(cut):
    data = _mixed(20000)
    comp = oracle.compress(data)
    j = jinc.BlockDecompressor()
    j.decompress(comp[:cut])
    d = stream_from_reference(j)
    assert isinstance(d, BlockDecompressor) and _state(d) == _state(j)
    d.decompress(comp[cut:])
    j.decompress(comp[cut:])
    d.finish()
    assert d.extract_data() == data == j.extract_data()


def test_block_decompressor_hand_over_keeps_the_verdict():
    comp = oracle.compress(_mixed(3000))
    bad = comp[:200] + bytes([comp[200] ^ 0x55]) + comp[201:400]
    j = jinc.BlockDecompressor()
    j.decompress(bad[:150])
    d = stream_from_reference(j)
    outcomes = []
    for dec, err in ((d, st.SnappyError), (j, jst.SnappyError)):
        try:
            dec.decompress(bad[150:])
            dec.finish()
            outcomes.append("accepted")
        except err as e:
            outcomes.append(f"{type(e).__name__}: {e}")
    assert outcomes[0] == outcomes[1] != "accepted"


@pytest.mark.parametrize("cut", [0, 5, 10, 14, 700, 17000])
def test_stream_decompressor_hand_over(cut):
    data = _mixed(70000, 4)
    framed = st.stream_compress(data, engine="oracle")
    assert len(framed) > cut + 100  # the cut falls inside the stream
    j = jstream.StreamDecompressor(engine="tpu")
    head = j.decompress(framed[:cut])
    d = stream_from_reference(j, **CPU)
    assert isinstance(d, S.StreamDecompressor) and d._engine == "cuda"
    assert bytes(d._pending) == bytes(j._pending) and d._seen_header == j._seen_header
    out = head + d.decompress(framed[cut:])
    d.finish()
    assert out == data == head + j.decompress(framed[cut:])
    bad = framed[:-1] + bytes([framed[-1] ^ 1])
    j = jstream.StreamDecompressor(engine="oracle")
    j.decompress(bad[:cut])
    with pytest.raises(st.InvalidDataError):
        stream_from_reference(j, **CPU).decompress(bad[cut:])
    with pytest.raises(jst.InvalidDataError):
        j.decompress(bad[cut:])


@pytest.mark.parametrize("cut", [0, 1, 40000, 65536, 100000])
def test_stream_compressor_hand_over(cut):
    data = _mixed(140_000, 6)
    j = jstream.StreamCompressor(engine="oracle")
    head = j.write(data[:cut])
    c = stream_from_reference(j)
    assert isinstance(c, S.StreamCompressor) and c._engine == "oracle"
    assert bytes(c._buf) == bytes(j._buf) and c._header_written == j._header_written
    framed = head + c.write(data[cut:]) + c.flush()
    assert framed == head + j.write(data[cut:]) + j.flush()
    assert framed == st.stream_compress(data, engine="oracle")
    assert st.stream_decompress(framed, **CPU) == data


def test_hand_over_rejects_other_objects():
    with pytest.raises(TypeError):
        stream_from_reference(object())


# --- verdict parity on the framing mutation set ------------------------------------


def _base_streams() -> list[bytes]:
    """The chunk mixes of ``tests/test_stream_mutation_parity.py`` from
    numpy seeds: two compressed chunks, a stored chunk, many flush-made
    tiny chunks, skippable/padding/repeated-identifier chunks, the empty
    stream."""
    rng = np.random.default_rng(501)
    streams = [st.stream_compress(html_like(70_000, 8).tobytes(), engine="oracle"),
               st.stream_compress(rng.integers(0, 256, 3000, np.uint8).tobytes(),
                                  engine="oracle")]
    c = S.StreamCompressor(engine="oracle")
    out = bytearray()
    for _ in range(12):
        out += c.write(rng.integers(0, 256, int(rng.integers(1, 60)), np.uint8).tobytes())
        out += c.flush()
    streams.append(bytes(out))
    base = st.stream_compress(b"interleaved " * 400, engine="oracle")
    hdr, body = base[:10], base[10:]
    streams.append(hdr + bytes([0x90, 5, 0, 0]) + b"skip!" + body
                   + bytes([0xFE, 3, 0, 0]) + b"\x00\x00\x00" + STREAM_HEADER + body)
    streams.append(STREAM_HEADER)
    return streams


def _verdict(fn, err) -> tuple[bool, bytes]:
    try:
        return True, fn()
    except err:
        return False, b""


def _split_feed(mb: bytes, rng) -> bytes:
    d = S.StreamDecompressor(**CPU)
    cuts = sorted(int(rng.integers(0, len(mb) + 1)) for _ in range(int(rng.integers(1, 4))))
    out, prev = bytearray(), 0
    for c in cuts + [len(mb)]:
        out += d.decompress(mb[prev:c])
        prev = c
    d.finish()
    return bytes(out)


@pytest.mark.parametrize("part", range(4))
def test_framing_mutation_verdicts_match_reference(part):
    """Every fourth mutant, starting at ``part``: the port's device engine
    (one-shot and split feeds), its oracle and native engines against the
    reference's one-shot verdict and bytes."""
    mutants = _mutants(_base_streams(), n_random=24)[part::4]
    assert len(mutants) >= 100
    rng = np.random.default_rng(503 + part)
    accepted = 0
    for i, mb in enumerate(mutants):
        want = _verdict(lambda: jst.stream_decompress(mb, engine="oracle"), jst.SnappyError)
        accepted += want[0]
        got = {
            "device": _verdict(lambda: st.stream_decompress(mb, **CPU), st.SnappyError),
            "split": _verdict(lambda: _split_feed(mb, rng), st.SnappyError),
            "oracle": _verdict(lambda: st.stream_decompress(mb, engine="oracle"), st.SnappyError),
        }
        if native.available():
            got["native"] = _verdict(lambda: st.stream_decompress(mb, engine="native"),
                                     st.SnappyError)
        for engine, verdict in got.items():
            assert verdict == want, (part, i, engine)
    assert accepted >= 5
