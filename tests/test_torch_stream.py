"""Parity of the port's framing-format runtime
(``snappier_tpu_torch/runtime/stream.py``) and its new native bindings
with the JAX package's.

The port runs with ``device="cpu"`` (each kernel's plain version). Off a
TPU the JAX stream layer builds a scan codec, so the byte-equality tests
pin it to the scalar kernels (the ones the port ports) by patching
``snappier_tpu.runtime.stream._CODEC`` and clearing the cache of
``_decode_crc_pack_fn``; the JAX package itself is untouched. Inputs come
from numpy seeds (``tests/torch_cases.py``). Tolerance is zero: bytes,
lengths, CRC bits and error classes.
"""

from __future__ import annotations

import asyncio
import io
import pathlib
import re

import numpy as np
import pytest
import torch

import snappier_tpu as jst
import snappier_tpu.runtime.stream as jstream
import snappier_tpu_torch as st
import snappier_tpu_torch.runtime.stream as S
from snappier_tpu.models.codec import SnappyCodec as JaxCodec
from snappier_tpu.runtime import native as jnative
from snappier_tpu_torch.constants import BLOCK_SIZE, STREAM_HEADER
from snappier_tpu_torch.format import framing, oracle
from snappier_tpu_torch.format.crc32c import crc32c, mask_crc
from snappier_tpu_torch.format.varint import write_varint
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.runtime import native
from snappier_tpu_torch.utils import profiling
from snappier_tpu_torch.utils.pool import StagingPool
from tests.torch_cases import html_like, stream_inputs

CPU = {"device": "cpu"}
INPUTS = stream_inputs()


@pytest.fixture
def jax_scalar(monkeypatch):
    """The JAX stream layer's device engine on its scalar kernels,
    restored (and its cache cleared again) afterwards."""
    jstream._decode_crc_pack_fn.cache_clear()
    monkeypatch.setattr(jstream, "_CODEC", JaxCodec(with_crc=True, kernel="scalar"))
    yield
    monkeypatch.undo()
    jstream._decode_crc_pack_fn.cache_clear()


def _chunk_types(framed: bytes) -> list[int]:
    return [t for t, _, _ in framing.iter_chunks(framed)][1:]


def _literal_per_byte_payload(plain: bytes) -> bytes:
    """A legal block of 2 bytes per input byte (every byte its own literal):
    too large for a device slot when ``plain`` is a full chunk."""
    body = bytearray(write_varint(len(plain)))
    for b in plain:
        body += bytes([0, b])
    return bytes(body)


def _data_chunk(ctype: int, plain: bytes, body: bytes) -> bytes:
    payload = mask_crc(crc32c(plain)).to_bytes(4, "little") + body
    return framing.write_chunk_header(ctype, len(payload)) + payload


# --- one-shot paths ---------------------------------------------------------


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_stream_bytes_match_pinned_jax(jax_scalar, name):
    data = INPUTS[name]
    _build.reset_launches()
    framed = st.stream_compress(data, **CPU)
    ref = jst.stream_compress(data, engine="tpu")
    assert framed == ref
    assert st.stream_decompress(ref, **CPU) == data  # each decodes the other's
    assert jst.stream_decompress(framed, engine="tpu") == data
    assert framing.frame_decompress(framed) == data
    assert sum(_build.LAUNCHES.values()) == 0  # CPU: the plain versions only


def test_fallback_rule_at_the_boundary():
    assert _chunk_types(st.stream_compress(INPUTS["size_equal"], **CPU)) == [0x01]
    assert _chunk_types(st.stream_compress(INPUTS["one_less"], **CPU)) == [0x00]
    framed = st.stream_compress(INPUTS["three_chunks"], **CPU)
    assert _chunk_types(framed) == [0x01, 0x00, 0x00]  # the random 64 KiB chunk is stored
    assert len(framed) > 10 + 8 + BLOCK_SIZE


@pytest.mark.parametrize("engine", ["native", "oracle"])
def test_host_engines_match_jax(engine):
    if engine == "native" and not native.available():
        pytest.skip("native runtime unavailable")
    for name in ("empty", "short_text", "short_random", "three_chunks"):
        data = INPUTS[name]
        framed = st.stream_compress(data, engine=engine)
        assert framed == jst.stream_compress(data, engine=engine)
        assert st.stream_decompress(framed, engine=engine) == data
        # A host engine's stream need not equal the device stream; it
        # must decode to the same bytes there.
        assert st.stream_decompress(framed, **CPU) == data
        assert st.stream_decompress(st.stream_compress(data, **CPU), engine=engine) == data


def test_native_bindings_match_jax():
    if not (native.available() and jnative.available()):
        pytest.skip("native runtime unavailable")
    data = INPUTS["three_chunks"]
    assert native.crc32c(data) == jnative.crc32c(data) == crc32c(data)
    assert native.crc32c(data[100:], native.crc32c(data[:100])) == crc32c(data)
    for threads in (0, 1, 2):
        framed = native.stream_compress(data, threads=threads)
        assert framed == jnative.stream_compress(data, threads=threads)
        assert native.stream_decompress(framed, threads=threads) == data
    block = native.compress(data)
    assert native.get_uncompressed_length(block) == jnative.get_uncompressed_length(block)
    assert native.get_uncompressed_length(block) == len(data)
    bad = bytearray(framed)
    bad[-1] ^= 0xFF
    for mod, err in ((native, st.InvalidDataError), (jnative, jst.InvalidDataError)):
        for threads in (0, 1):
            with pytest.raises(err, match="corrupt framed stream"):
                mod.stream_decompress(bytes(bad), threads=threads)
        with pytest.raises(err, match="malformed framed stream"):
            mod.stream_decompress(framed[:-3])
        with pytest.raises(err, match="bad length preamble"):
            mod.get_uncompressed_length(b"\xff\xff\xff\xff\xff\xff")


def test_native_bindings_declare_every_symbol():
    """An undeclared size_t argument is passed as a 32-bit int."""
    if not native.available():
        pytest.skip("native runtime unavailable")
    lib = native.load()
    for name in ("stpu_crc32c", "stpu_stream_compress", "stpu_stream_compress_mt",
                 "stpu_stream_decompress", "stpu_stream_decompress_mt",
                 "stpu_stream_max_compressed_length", "stpu_stream_uncompressed_length"):
        fn = getattr(lib, name)
        assert fn.argtypes is not None and fn.restype is not None, name
        assert name in native._SIGNATURES


# --- incremental classes and file adapters ------------------------------------


def test_flush_made_tiny_chunks_match_jax(jax_scalar):
    """A flush after every tiny write makes a chunk each; the decoder
    resumes at every byte boundary (SnappyStreamTests.cs:145-192)."""
    rng = np.random.default_rng(301)
    comp, jcomp = S.StreamCompressor(**CPU), jstream.StreamCompressor(engine="tpu")
    framed, jframed, plain = bytearray(), bytearray(), bytearray()
    for k in range(24):
        piece = (rng.integers(0, 256, int(rng.integers(1, 100)), dtype=np.uint8).tobytes()
                 if k % 3 else html_like(int(rng.integers(20, 400)), k).tobytes())
        plain += piece
        framed += comp.write(piece) + comp.flush()
        jframed += jcomp.write(piece) + jcomp.flush()
    assert framed == jframed
    assert len(_chunk_types(bytes(framed))) == 24
    d = S.StreamDecompressor(**CPU)
    out = bytearray()
    for i in range(len(framed)):
        out += d.decompress(framed[i : i + 1])
    d.finish()
    assert out == plain
    assert comp.flush() == b""  # nothing pending, header already written


@pytest.mark.parametrize("transfer", [1, 7, 8192])
def test_reader_at_every_transfer_size(transfer):
    data = INPUTS["three_chunks"][60000:75000] + INPUTS["short_random"]
    sink = io.BytesIO()
    with st.SnappyWriter(sink, leave_open=True, **CPU) as w:
        assert w.writable() and not w.readable()
        for i in range(0, len(data), 4000):
            assert w.write(data[i : i + 4000]) == len(data[i : i + 4000])
        w.flush()
    framed = sink.getvalue()
    assert jst.stream_decompress(framed, engine="oracle") == data
    with st.SnappyReader(io.BytesIO(framed), transfer_size=transfer, **CPU) as r:
        assert r.readable() and not r.writable()
        assert r.read() == data
    with st.SnappyStream(io.BytesIO(framed), "rb", transfer_size=transfer, **CPU) as r:
        out = bytearray()
        while piece := r.read(777):
            out += piece
        assert out == data
    with pytest.raises(st.InvalidOperationError):
        r.read()
    with pytest.raises(st.InvalidOperationError):
        w.write(b"x")
    with pytest.raises(ValueError):
        st.SnappyStream(io.BytesIO(), "a+")


def test_writer_over_jax_reader_and_back(jax_scalar):
    data = INPUTS["three_chunks"]
    sink, jsink = io.BytesIO(), io.BytesIO()
    with st.SnappyStream(sink, "wb", leave_open=True, **CPU) as w, \
            jstream.SnappyWriter(jsink, leave_open=True, engine="tpu") as jw:
        for i in range(0, len(data), 50000):
            w.write(data[i : i + 50000])
            jw.write(data[i : i + 50000])
    assert sink.getvalue() == jsink.getvalue()
    assert jstream.SnappyReader(io.BytesIO(sink.getvalue()), engine="oracle").read() == data
    jsink.seek(0)
    with st.SnappyReader(jsink, **CPU) as r:
        assert r.readall() == data
    assert jsink.closed  # leave_open=False closes the inner stream


def test_async_twins_round_trip_and_serialize():
    pieces = [bytes([i]) * (997 * (i % 7 + 1)) for i in range(24)]

    async def run():
        sink = io.BytesIO()
        async with st.AsyncSnappyWriter(sink, leave_open=True, **CPU) as w:
            await asyncio.gather(*(w.write(p) for p in pieces[:12]))
            await asyncio.gather(w.flush(), *(w.write(p) for p in pieces[12:]))
        framed = sink.getvalue()
        async with st.AsyncSnappyReader(io.BytesIO(framed), **CPU) as r:
            outs = await asyncio.gather(*(r.read(4096) for _ in range(10)))
            rest = await r.read()
        return framed, b"".join(outs) + rest

    framed, got = asyncio.run(run())
    assert got == b"".join(pieces)
    assert jst.stream_decompress(framed, engine="oracle") == got


# --- format semantics -----------------------------------------------------------


def test_oversize_payload_routes_to_the_host(monkeypatch):
    """A legal chunk whose compressed payload exceeds the device slot
    decodes through the host block decoder; its neighbours stay on the
    device path."""
    plain = INPUTS["three_chunks"][:BLOCK_SIZE]
    body = _literal_per_byte_payload(plain)
    assert len(body) > S.CHUNK_COMP_CAP - 8
    tail = st.stream_compress(b"tail-chunk " * 30, **CPU)[len(STREAM_HEADER):]
    framed = STREAM_HEADER + _data_chunk(0x00, plain, body) + tail
    seen = []
    real = S._decode_crc_pack
    monkeypatch.setattr(S, "_decode_crc_pack",
                        lambda comp, lens: seen.append(tuple(comp.shape)) or real(comp, lens))
    assert st.stream_decompress(framed, **CPU) == plain + b"tail-chunk " * 30
    assert seen == [(1, 32)]  # only the tail chunk, in a slot of its own width
    assert jst.stream_decompress(framed, engine="tpu") == plain + b"tail-chunk " * 30


def test_uncompressed_cap_is_checked_before_any_device_work(monkeypatch):
    monkeypatch.setattr(S, "_decode_crc_pack", lambda *a: pytest.fail("device work ran"))
    good = oracle.compress(np.frombuffer(b"abc" * 40, np.uint8))
    too_long = write_varint(BLOCK_SIZE + 1) + b"\x00a"
    for engine in ("cuda", "oracle"):
        with pytest.raises(st.InvalidDataError, match="64 KiB uncompressed cap"):
            S._decompress_chunks_batched([good, too_long], engine=engine, **CPU)
    raw = STREAM_HEADER + _data_chunk(0x01, bytes(BLOCK_SIZE + 1), bytes(BLOCK_SIZE + 1))
    with pytest.raises(st.InvalidDataError, match="64 KiB uncompressed cap"):
        st.stream_decompress(raw, **CPU)


def test_skippable_chunks_are_skipped_like_jax():
    data = b"skippable chunk test " * 400
    framed = st.stream_compress(data, **CPU)
    extra = (framing.write_chunk_header(0x85, 3) + b"xyz"
             + framing.write_chunk_header(0xFE, 5) + bytes(5))
    ok = framed[:10] + extra + framed[10:] + STREAM_HEADER + framed[10:]
    assert st.stream_decompress(ok, **CPU) == data + data
    assert jst.stream_decompress(ok, engine="oracle") == data + data
    if native.available():
        assert st.stream_decompress(ok, engine="native") == data + data


def _faulty_streams() -> dict[str, bytes]:
    data = html_like(3000, 4).tobytes()
    framed = st.stream_compress(data, **CPU)
    rnd = INPUTS["short_random"]
    raw_chunk = st.stream_compress(rnd, **CPU)[10:]
    flip = lambda s, i: s[:i] + bytes([s[i] ^ 0xFF]) + s[i + 1 :]  # noqa: E731
    bad_block = _data_chunk(0x00, b"abcde", bytes([100, 4 << 2]) + b"abcde")
    return {
        "crc_byte": flip(framed, 14),
        "payload_byte": flip(framed, len(framed) - 1),
        "truncated_tail": framed[:-3],
        "headerless": framed[10:],
        "bad_identifier_length": bytes([0xFF, 5, 0, 0]) + b"sNaPp" + framed[10:],
        "bad_identifier_payload": framed[:4] + b"sNaPpX" + framed[10:],
        "unskippable_type": framed[:10] + bytes([0x40, 1, 0, 0, 0]) + framed[10:],
        "chunk_shorter_than_crc": framed[:10] + bytes([0x00, 2, 0, 0, 1, 2]),
        "raw_chunk_shorter_than_crc": framed[:10] + bytes([0x01, 3, 0, 0, 1, 2, 3]),
        # Several faults in one feed: the first failure in the reference's
        # order is the verdict. A stored chunk's CRC is checked while the
        # feed is parsed, a decode error is raised before any CRC of a
        # decoded chunk is compared.
        "raw_crc_after_bad_block": framed[:10] + bad_block + flip(raw_chunk, 5),
        "bad_block_after_crc_mismatch": flip(framed, 14) + bad_block,
        "two_bad_blocks": framed[:10] + _data_chunk(0x00, b"ab", bytes([10, 3 << 2]) + b"ab")
        + bad_block,
    }


FAULTY = _faulty_streams()
DECODE_FAULTS = {"bad_block_after_crc_mismatch", "two_bad_blocks"}


@pytest.mark.parametrize("name", sorted(FAULTY))
def test_faulty_streams_raise_the_reference_verdict(name):
    with pytest.raises(jst.InvalidDataError) as r:
        jst.stream_decompress(FAULTY[name], engine="oracle")
    with pytest.raises(st.InvalidDataError) as p:
        st.stream_decompress(FAULTY[name], **CPU)
    if name not in DECODE_FAULTS:  # the oracle engine words decode errors its own way
        assert str(p.value) == str(r.value)
    with pytest.raises(st.InvalidDataError) as o:
        st.stream_decompress(FAULTY[name], engine="oracle")
    assert str(o.value) == str(r.value)
    if native.available():
        with pytest.raises(st.InvalidDataError):
            st.stream_decompress(FAULTY[name], engine="native")


def test_first_failure_in_the_reference_order_is_the_verdict():
    """A stored chunk's CRC is checked at parse time, before any device
    batch of the feed; a decode error of any chunk is raised before the CRC
    of a decoded chunk is compared."""
    with pytest.raises(st.InvalidDataError, match="chunk CRC32C mismatch"):
        st.stream_decompress(FAULTY["raw_crc_after_bad_block"], **CPU)
    for name in sorted(DECODE_FAULTS):
        with pytest.raises(st.InvalidDataError, match="does not match length preamble"):
            st.stream_decompress(FAULTY[name], **CPU)


# --- the device batch paths -------------------------------------------------------


class CountingPool(StagingPool):
    outstanding = 0

    def rent(self, *a, **kw):
        self.outstanding += 1
        return super().rent(*a, **kw)

    def giveback(self, buf):
        self.outstanding -= 1
        super().giveback(buf)


def test_pool_balanced_after_a_mid_pipeline_decode_error(monkeypatch):
    """A decode error in sub-batch 0 must not strand the staging buffers
    of the sub-batches queued behind it."""
    monkeypatch.setattr(S, "_SUB_BATCH", 2)
    monkeypatch.setattr(S, "_PIPELINE_DEPTH", 2)
    pool = CountingPool()
    monkeypatch.setattr(S, "staging_pool", pool)
    good = oracle.compress(np.frombuffer(b"hello snappy pool" * 3, np.uint8))
    bad = bytes([100]) + bytes([4 << 2]) + b"abcde"  # claims 100 bytes, holds 5
    with pytest.raises(st.InvalidDataError):
        S._decompress_chunks_batched([good, bad] + [good] * 12, **CPU)
    assert pool.outstanding == 0
    bodies, crcs = S._decompress_chunks_batched([good] * 5, **CPU)
    assert bodies == [b"hello snappy pool" * 3] * 5
    assert crcs == [crc32c(b"hello snappy pool" * 3)] * 5
    S._compress_chunks_batched([b"the pool must balance " * 40] * 9, **CPU)
    assert pool.outstanding == 0


def test_pool_balanced_when_a_submit_raises(monkeypatch):
    monkeypatch.setattr(S, "_SUB_BATCH", 2)
    pool = CountingPool()
    monkeypatch.setattr(S, "staging_pool", pool)
    calls = []

    def failing(self, frags, lengths):
        calls.append(len(lengths))
        if len(calls) == 3:
            raise RuntimeError("planted")
        return real(self, frags, lengths)

    real = S.SnappyCodec.frame_batch_packed
    monkeypatch.setattr(S.SnappyCodec, "frame_batch_packed", failing)
    with pytest.raises(RuntimeError, match="planted"):
        S._compress_chunks_batched([b"abc" * 100] * 8, **CPU)
    assert pool.outstanding == 0 and calls == [2, 2, 2]


def test_multi_sub_batch_run_gives_the_same_bytes(monkeypatch):
    """Small sub-batches put the submit-ahead window, the ragged last
    sub-batch and the compaction to work; bytes and verdicts do not depend
    on how a batch is cut."""
    rng = np.random.default_rng(17)
    data = (html_like(150_000, 6).tobytes()
            + rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes() + b"x" * 80_000)
    whole = st.stream_compress(data, **CPU)  # 6 chunks in one batch
    monkeypatch.setattr(S, "_SUB_BATCH", 2)
    monkeypatch.setattr(S, "_PIPELINE_DEPTH", 1)
    order = []
    real = S._pipeline
    monkeypatch.setattr(S, "_pipeline", lambda submit, fetch, n, release=None: real(
        lambda s: order.append(("submit", s)) or submit(s),
        lambda *w: order.append(("fetch", w[-3] // 2)) or fetch(*w), n, release))
    assert st.stream_compress(data, **CPU) == whole
    assert order == [("submit", 0), ("submit", 1), ("fetch", 0), ("submit", 2), ("fetch", 1),
                     ("fetch", 2)]
    assert st.stream_decompress(whole, **CPU) == data
    assert st.stream_decompress(whole, engine="oracle") == data


def test_poisoned_pool_tail_never_reaches_the_output(monkeypatch):
    """Pooled rows are not clean and their tails are not zeroed: no byte
    past a chunk's length may show in the stream, for a compressed chunk or
    a stored one."""
    chunks = [INPUTS["short_text"], INPUTS["short_random"], INPUTS["size_equal"]]
    clean = S._compress_chunks_batched(chunks, **CPU)
    pool = StagingPool()
    for _ in range(3):
        pool.giveback(torch.full((1 << 18,), 0xAB, dtype=torch.uint8))
    monkeypatch.setattr(S, "staging_pool", pool)
    assert S._compress_chunks_batched(chunks, **CPU) == clean
    assert [c[0] for c in clean] == [0x00, 0x01, 0x01]
    assert [len(c) for c in clean[1:]] == [8 + 300, 8 + 38]


def test_decode_crc_pack_matches_jax(jax_scalar):
    """The decode-side function (decode, CRC32C of the decoded rows,
    word-packing) against the JAX graph with the CRC kernel in interpret
    mode, a corrupt row included."""
    plains = [INPUTS["full_chunk"], INPUTS["short_text"], INPUTS["short_random"], b"a"]
    blocks = [oracle.compress(np.frombuffer(p, np.uint8)) for p in plains]
    blocks.append(bytes([100]) + bytes([4 << 2]) + b"abcde")
    width = -(-max(len(b) for b in blocks) // 1024) * 1024  # the JAX kernel's tiling
    comp = np.random.default_rng(3).integers(0, 256, (len(blocks), width), dtype=np.uint8)
    lens = np.array([len(b) for b in blocks], np.int32)
    for i, b in enumerate(blocks):
        comp[i, : len(b)] = np.frombuffer(b, np.uint8)
    got = [x.numpy() for x in S._decode_crc_pack(torch.from_numpy(comp), torch.from_numpy(lens))]
    ref = [np.asarray(x) for x in jstream._decode_crc_pack_fn(BLOCK_SIZE, True)(comp, lens)]
    packed, out_lens, errs, crcs = got
    assert packed.dtype == np.int32 and packed.shape == ref[0].shape == (5, BLOCK_SIZE // 4)
    assert (out_lens == ref[1]).all() and (errs == ref[2]).all()
    assert out_lens.tolist() == [len(p) for p in plains] + [0] and errs[-1] != 0
    for i, p in enumerate(plains):
        assert packed[i].view(np.uint8)[: len(p)].tobytes() == p
        assert (ref[0][i].view(np.uint8)[: len(p)] == packed[i].view(np.uint8)[: len(p)]).all()
        assert int(crcs[i].view(np.uint32)) == crc32c(p) == int(ref[3][i].view(np.uint32))


def test_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    framed = st.stream_compress(b"abc" * 50, engine="oracle")
    for call in (lambda: st.stream_compress(b"abc"),
                 lambda: st.stream_decompress(framed),
                 lambda: st.SnappyWriter(io.BytesIO()).flush() or st.SnappyWriter(
                     io.BytesIO()).write(bytes(BLOCK_SIZE)),
                 lambda: st.SnappyReader(io.BytesIO(framed)).read(),
                 lambda: asyncio.run(st.AsyncSnappyReader(io.BytesIO(framed)).read())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert st.stream_decompress(framed, engine="oracle") == b"abc" * 50
    with pytest.raises(ValueError):
        st.stream_compress(b"x", engine="tpu")  # the port's device engine is "cuda"


def test_stream_calls_are_timed_under_the_reference_names(monkeypatch):
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.metrics_reset()
    st.stream_decompress(st.stream_compress(b"abc" * 100, engine="oracle"), engine="oracle")
    snap = profiling.metrics_snapshot()
    profiling.metrics_reset()
    assert snap["stream.compress"]["calls"] == 1 and snap["stream.compress"]["bytes"] == 300
    assert snap["stream.decompress"]["calls"] == 1


def test_public_surface_matches_the_reference():
    for name in ("stream_compress", "stream_decompress", "SnappyStream", "SnappyReader",
                 "SnappyWriter", "AsyncSnappyReader", "AsyncSnappyWriter"):
        assert hasattr(st, name) and hasattr(jst, name), name


def test_port_sources_name_neither_jax_nor_the_reference_package():
    root = pathlib.Path(st.__file__).resolve().parent
    files = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|snappier_tpu)(?:[\s.]|$)", re.M)
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f
