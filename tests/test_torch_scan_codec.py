"""The scan engine through the port's entry points, against the JAX package
on the CPU: ``SnappyCodec(kernel="scan")`` method by method,
``compress_fragments(kernel="scan")``, and the facade and the stream layers
under ``SNAPPIER_KERNEL=scan`` (off a TPU the JAX package picks its scan
engine by itself, so its facade and streams need no pinning here).

The port runs with ``device="cpu"``; the scan engine is tensor code and
runs the same there. Every comparison is exact. The port reads its engine
choice once per process (``default_kernel`` is cached), so the tests that
set the environment variable clear that cache before and after.
"""

from __future__ import annotations

import io
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snappier_tpu as jst
import snappier_tpu.runtime.block as jblock
import snappier_tpu_torch as st
from snappier_tpu.models.codec import SnappyCodec as JaxCodec
from snappier_tpu_torch import SnappyCodec
from snappier_tpu_torch.convert import codec_from_reference
from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.models import codec as codec_mod
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.ops.decode import (
    ERR_BAD_OFFSET,
    ERR_BAD_PREAMBLE,
    ERR_LENGTH_MISMATCH,
    ERR_TRUNCATED_TAG,
)
from snappier_tpu_torch.runtime import block
from tests.torch_cases import (
    block_stream,
    corrupt_streams,
    encode_rows,
    html_like,
    pack_streams,
    stream_inputs,
)

CPU = {"device": "cpu"}
F = 1024


@pytest.fixture
def scan_env(monkeypatch):
    """``SNAPPIER_KERNEL=scan`` for the port, whose cached choice is read
    anew inside the test and forgotten after it."""
    codec_mod.default_kernel.cache_clear()
    monkeypatch.setenv("SNAPPIER_KERNEL", "scan")
    yield
    monkeypatch.undo()
    codec_mod.default_kernel.cache_clear()


@pytest.fixture(scope="module")
def rows():
    frags, lens = encode_rows(F)
    frags = np.where(np.arange(F)[None, :] < lens[:, None], frags, 0).astype(np.int32)
    return frags, lens


@pytest.fixture(scope="module")
def codecs():
    return SnappyCodec(fragment_size=F, kernel="scan", **CPU), JaxCodec(fragment_size=F,
                                                                         kernel="scan")


def _same(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
        assert (g.numpy() == w).all()


@pytest.mark.parametrize("method", ["compress_batch", "compress_batch_packed", "frame_batch",
                                    "frame_batch_packed", "roundtrip_step"])
def test_scan_codec_method_matches_jax(codecs, rows, method):
    port, ref = codecs
    frags, lens = rows
    _build.reset_launches()
    _same(getattr(port, method)(frags, lens),
          getattr(ref, method)(jnp.asarray(frags), jnp.asarray(lens)))
    assert not _build.LAUNCHES


def test_scan_codec_without_crc_matches_jax(rows):
    frags, lens = rows
    port = SnappyCodec(fragment_size=F, kernel="scan", with_crc=False, **CPU)
    ref = JaxCodec(fragment_size=F, kernel="scan", with_crc=False)
    got = port.compress_batch(frags, lens)
    _same(got, ref.compress_batch(jnp.asarray(frags), jnp.asarray(lens)))
    assert not got[2].any()


@pytest.mark.parametrize("packed", [False, True])
def test_scan_codec_decompress_matches_jax(codecs, rows, packed):
    """Valid and corrupt blocks: rows, claimed lengths and the separate
    error bits, as bytes per int32 and word-packed."""
    port, ref = codecs
    frags, lens = rows
    bodies, body_lens, _ = port.compress_batch(frags, lens)
    streams = corrupt_streams() + [block_stream(n, bodies[i, : body_lens[i]].numpy())
                                   for i, n in enumerate(lens)]
    comp, clens = pack_streams(streams, 4096, garbage_seed=None)
    got = port.decompress_batch(comp, clens, packed=packed)
    _same(got, ref.decompress_batch(jnp.asarray(comp), jnp.asarray(clens), packed=packed))
    _same(port.decompress_batch_fn(F, packed)(comp, clens), got)
    errs = got[2].tolist()
    n_bad = len(corrupt_streams())
    assert not any(errs[n_bad:])
    for bit in (ERR_TRUNCATED_TAG, ERR_BAD_OFFSET, ERR_LENGTH_MISMATCH, ERR_BAD_PREAMBLE):
        assert bit in errs[:n_bad]  # each failure by its own bit, not a combined word
    with pytest.raises(ValueError):
        port.decompress_batch(comp, clens, out_cap=1022, packed=True)


def test_compress_fragments_scan_matches_jax(rows):
    frags, lens = rows
    rb, rl = (np.asarray(x) for x in jblock.compress_fragments(frags, lens, kernel="scan"))
    gb, gl = block.compress_fragments(frags, lens, kernel="scan", **CPU)
    assert gb.dtype == torch.uint8 and gb.shape == rb.shape
    assert (gl.numpy() == rl).all() and (gb.numpy() == rb).all()


def test_cross_engine_round_trips(rows):
    """scan <-> scalar (plain versions) <-> oracle: every engine decodes
    what every other encodes, and the scan bodies are no larger than the
    greedy encoder's."""
    frags, lens = rows
    scan = SnappyCodec(fragment_size=F, kernel="scan", **CPU)
    scalar = SnappyCodec(fragment_size=F, kernel="scalar", **CPU)
    want = [frags[i, :n].astype(np.uint8).tobytes() for i, n in enumerate(lens)]
    encoded = {}
    for name, codec in (("scan", scan), ("scalar", scalar)):
        bodies, body_lens, crcs = codec.compress_batch(frags, lens)
        encoded[name] = [block_stream(n, bodies[i, : body_lens[i]].numpy())
                         for i, n in enumerate(lens)]
        encoded[name + "_crcs"] = crcs
    encoded["oracle"] = [oracle.compress(np.frombuffer(w, np.uint8)) for w in want]
    assert (encoded["scan_crcs"] == encoded["scalar_crcs"]).all()
    assert sum(map(len, encoded["scan"])) <= sum(map(len, encoded["scalar"]))
    for src in ("scan", "scalar", "oracle"):
        comp, clens = pack_streams(encoded[src], 4096, garbage_seed=None)
        for codec in (scan, scalar):
            outs, out_lens, errs = codec.decompress_batch(comp, clens)
            assert not errs.any() and (out_lens.numpy() == lens).all()
            for i, n in enumerate(lens):
                assert outs[i, :n].to(torch.uint8).numpy().tobytes() == want[i], (src, i)
        for i, s in enumerate(encoded[src]):
            assert oracle.decompress(s) == want[i]


def _facade_inputs():
    rng = np.random.default_rng(41)
    return [b"", b"a", html_like(9000, 3).tobytes(), bytes(range(1, 8)) * 700,
            html_like(70000, 4).tobytes() + rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()]


def test_facade_under_scan_matches_jax(scan_env):
    """``compress`` / ``decompress`` (one block and the multi-block decode)
    and the ``*_into`` forms with the scan engine on both sides."""
    assert block._device_kernel() == "scan"
    _build.reset_launches()
    for data in _facade_inputs():
        comp = st.compress(data, **CPU)
        assert comp == jst.compress(data, engine="tpu")
        assert st.decompress(comp, **CPU) == data == jst.decompress(comp, engine="tpu")
        assert st.decompress(oracle.compress(np.frombuffer(data, np.uint8)), **CPU) == data
        out = bytearray(st.get_max_compressed_length(len(data)))
        assert bytes(out[: st.compress_into(data, out, **CPU)]) == comp
    assert st.compress(_facade_inputs()[2], level="best", **CPU) == jst.compress(
        _facade_inputs()[2], level="best")  # level="best" is the scalar walk on either engine
    for bad in corrupt_streams()[1:7]:
        with pytest.raises(st.InvalidDataError):
            st.decompress(bad, **CPU)
    assert set(_build.LAUNCHES) == set()


def test_facade_scan_error_names_each_failure(scan_env):
    lit = bytes([8, (4 - 1) << 2]) + b"abcd"
    with pytest.raises(st.InvalidDataError, match="copy offset out of range"):
        st.decompress(lit + bytes([1, 5]), **CPU)
    with pytest.raises(st.InvalidDataError, match="tag overruns compressed input"):
        st.decompress(bytes([10, 3 << 2]) + b"ab", **CPU)


@pytest.mark.parametrize("name", sorted(stream_inputs()))
def test_stream_under_scan_matches_jax(scan_env, name):
    data = stream_inputs()[name]
    framed = st.stream_compress(data, **CPU)
    assert framed == jst.stream_compress(data, engine="tpu")
    assert st.stream_decompress(framed, **CPU) == data == jst.stream_decompress(framed,
                                                                                engine="tpu")
    assert st.stream_decompress(jst.stream_compress(data, engine="oracle"), **CPU) == data


def test_stream_adapters_under_scan(scan_env):
    data = stream_inputs()["three_chunks"]
    sink = io.BytesIO()
    with st.SnappyWriter(sink, leave_open=True, **CPU) as w:
        w.write(data)
    assert sink.getvalue() == jst.stream_compress(data, engine="tpu")
    with st.SnappyReader(io.BytesIO(sink.getvalue()), **CPU) as r:
        assert r.read() == data
    flipped = bytearray(sink.getvalue())
    flipped[14] ^= 0xFF  # a CRC byte of the first data chunk
    with pytest.raises(st.InvalidDataError):
        st.stream_decompress(bytes(flipped), **CPU)


def test_default_kernel_override(monkeypatch, caplog):
    codec_mod.default_kernel.cache_clear()
    try:
        monkeypatch.delenv("SNAPPIER_KERNEL", raising=False)
        assert codec_mod.default_kernel() == "scalar"
        assert SnappyCodec(**CPU).kernel == "scalar"
        for value in ("scan", "scalar"):
            codec_mod.default_kernel.cache_clear()
            monkeypatch.setenv("SNAPPIER_KERNEL", value)
            assert codec_mod.default_kernel() == value
            assert codec_mod.default_kernel(sharded=True) == value
            assert SnappyCodec(**CPU).kernel == value
            assert SnappyCodec(kernel="scalar", **CPU).kernel == "scalar"
        codec_mod.default_kernel.cache_clear()
        monkeypatch.setenv("SNAPPIER_KERNEL", "vector")
        with caplog.at_level(logging.WARNING, logger="snappier_tpu_torch"):
            assert codec_mod.default_kernel() == "scalar"
        assert "SNAPPIER_KERNEL='vector'" in caplog.text
    finally:
        monkeypatch.undo()
        codec_mod.default_kernel.cache_clear()


def test_default_device_still_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SnappyCodec(kernel="scan")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        block.compress_fragments(np.zeros((1, 64), np.uint8), np.array([64]), kernel="scan")


def test_codec_from_reference_carries_kernel():
    ref = JaxCodec(fragment_size=2048, with_crc=False, kernel="scan")
    cfg = {k: getattr(ref, k) for k in ("fragment_size", "with_crc", "hash_bits", "skip_base",
                                        "kernel")}
    port = codec_from_reference(cfg, **CPU)
    assert (port.kernel, port.fragment_size, port.with_crc) == ("scan", 2048, False)
    del cfg["kernel"]
    assert codec_from_reference(cfg, **CPU).kernel == codec_mod.default_kernel()
    with pytest.raises(KeyError):
        codec_from_reference({"fragment_size": 1024}, **CPU)
