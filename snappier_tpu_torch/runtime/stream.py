"""Framing-format runtime: batched device codec for framed streams plus
incremental, resumable stream classes (port of
``snappier_tpu/runtime/stream.py``).

Parity targets:

* ``SnappyStream`` (SnappyStream.cs): a ``System.IO.Stream`` adapter with
  sync+async read/write, pooled 8 KiB transfer buffer, Flush sealing a
  chunk, Dispose flushing. Here: :class:`SnappyWriter` /
  :class:`SnappyReader` file-object wrappers and their async twins.
* ``SnappyStreamCompressor`` (SnappyStreamCompressor.cs): 64 KiB
  buffering, header emission, CRC + uncompressed fallback:
  :class:`StreamCompressor`.
* ``SnappyStreamDecompressor`` (SnappyStreamDecompressor.cs): chunk state
  machine resumable at *any byte boundary*: :class:`StreamDecompressor`
  keeps the pending tail of the last incomplete chunk, which subsumes the
  reference's scratch-resume bookkeeping.

Device shape: chunk payloads are independent given their boundaries, so
the hot paths batch chunks into sub-batches of ``_SUB_BATCH`` that are
pipelined a few ahead of the ordered fetches (:func:`_pipeline`). A
sub-batch is staged in one page-locked host buffer and crosses with one
asynchronous copy; the write side runs the whole data-chunk pipeline on
the card (``SnappyCodec.frame_batch_packed``: the encode kernel, the
CRC32C kernel, framing bytes), the read side decodes, checksums the
*decoded* rows with the CRC32C kernel and word-packs them
(:func:`_decode_crc_pack`). The kernel launchers return without waiting,
so the card works on earlier sub-batches while the host stages later
ones. Each sub-batch records an event when its work is queued; its fetch
runs on a side stream that waits for that event alone, so the ordered
fetch is the only blocking point and waits for no later sub-batch.

Engines and devices are those of :mod:`snappier_tpu_torch.runtime.block`:
``engine="auto"`` means ``"cuda"``, ``device=None`` is the card and raises
without one, ``device="cpu"`` runs each kernel's plain version. With the
device engine the CRC32C of every compressed chunk is computed by the
kernel, on both sides; the host CRC serves the host engines, uncompressed
chunks and payloads too large for a device slot.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import functools

import numpy as np
import torch

from snappier_tpu_torch.constants import (
    BLOCK_SIZE,
    CHUNK_COMPRESSED_DATA,
    CHUNK_PADDING,
    CHUNK_STREAM_IDENTIFIER,
    CHUNK_UNCOMPRESSED_DATA,
    MAX_CHUNK_UNCOMPRESSED,
    STREAM_HEADER,
)
from snappier_tpu_torch.errors import InvalidDataError, InvalidOperationError
from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.format.crc32c import crc32c, mask_crc, unmask_crc
from snappier_tpu_torch.format.framing import frame_data_chunk
from snappier_tpu_torch.format.varint import read_varint
from snappier_tpu_torch.models.codec import (
    SnappyCodec,
    compact_words,
    crc_rows,
    decode_rows,
    pack_rows,
    resolve_device,
)
from snappier_tpu_torch.runtime import block as block_rt
from snappier_tpu_torch.runtime import native
from snappier_tpu_torch.utils.pool import staging_pool
from snappier_tpu_torch.utils.profiling import span

#: Compressed capacity of the *device batch slot* for one framed chunk's
#: block payload (varint + greedy body <= 3 + 66552). The framing format
#: itself allows compressed payloads up to 16 MiB - 1 (3-byte chunk
#: length) as long as the uncompressed size is <= 64 KiB; payloads too
#: large for the device slot are routed through the host block decoder
#: instead of being rejected (SnappyStreamDecompressor.cs imposes no
#: compressed-size cap).
CHUNK_COMP_CAP = BLOCK_SIZE + 2048

#: Reference's default transfer buffer (SnappyStream.cs:16).
DEFAULT_TRANSFER_SIZE = 8192

#: Chunks per device sub-batch of the one-shot stream paths: 16 MiB of
#: input, enough rows to fill the card, small enough that several
#: sub-batches pipeline.
_SUB_BATCH = 256

#: Sub-batches allowed in flight before the oldest is fetched.
_PIPELINE_DEPTH = 3


def _pipeline(submit, fetch, n: int, release=None) -> None:
    """Run ``submit(s)`` for s in range(n), calling ``fetch(*work)`` on
    each result in order while keeping up to ``_PIPELINE_DEPTH``
    sub-batches in flight. ``submit`` only queues device work, so the
    device works on earlier batches while the host stages later ones;
    the ordered fetches are the only blocking points.

    ``release(*work)`` is applied to every still-queued sub-batch when
    a submit or fetch raises, so pooled staging buffers held by pending
    work are returned instead of abandoned."""
    pending: collections.deque = collections.deque()
    try:
        for s in range(n):
            pending.append(submit(s))
            if len(pending) > _PIPELINE_DEPTH:
                fetch(*pending.popleft())
        while pending:
            fetch(*pending.popleft())
    finally:
        if release is not None:
            while pending:
                release(*pending.popleft())


def _host_crc_fn():
    """Fastest available host-side CRC32C (chunk verification)."""
    return native.crc32c if native.available() else crc32c


def _host_crc_of_decoded(body: bytes) -> int:
    """Host CRC32C of a chunk body that a host decoder produced (the host
    engines, and payloads too large for a device slot)."""
    return _host_crc_fn()(body)


# ---------------------------------------------------------------------------
# Staging, events and the fetch stream
# ---------------------------------------------------------------------------


class _Stage:
    """``n`` byte rows of ``width`` (a multiple of 4) and an int32 length
    per row in one pooled host buffer, page-locked when it feeds a CUDA
    device, so that one asynchronous copy carries a sub-batch across.
    ``rows`` and ``lens`` are numpy views to fill."""

    def __init__(self, n: int, width: int, dev: torch.device) -> None:
        self._split = n * width
        self._nbytes = self._split + 4 * n
        self._shape = (n, width)
        self.buf = staging_pool.rent(self._nbytes, pinned=dev.type == "cuda")
        self.rows = self.buf[: self._split].view(n, width).numpy()
        self.lens = self.buf[self._split : self._nbytes].view(torch.int32).numpy()

    def to(self, dev: torch.device):
        """Queue the copy to ``dev``; returns (rows uint8 [n, width],
        lengths int32 [n]) there. On the CPU these are views of the
        buffer itself."""
        d = self.buf[: self._nbytes].to(dev, non_blocking=True)
        return d[: self._split].view(self._shape), d[self._split :].view(torch.int32)

    def release(self) -> None:
        """Hand the buffer back. Only after the copy that reads it has
        finished."""
        staging_pool.giveback(self.buf)


def _on(dev: torch.device):
    """Make ``dev`` the thread's CUDA device for a device path (a worker
    thread of the async adapters starts on device 0)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _mark(dev: torch.device):
    """An event at this point of ``dev``'s current stream: it completes
    when everything queued so far has (None on the CPU, where nothing is
    queued)."""
    if dev.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return event


def _wait(event) -> None:
    if event is not None:
        event.synchronize()


def _drain(dev: torch.device) -> None:
    """Wait for everything queued on ``dev``'s current stream."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


@functools.cache
def _fetch_stream(dev: torch.device):
    return torch.cuda.Stream(dev)


@contextlib.contextmanager
def _fetching(dev: torch.device, event):
    """Run the body's device work on ``dev``'s fetch stream, after
    ``event`` and independent of what the main stream has queued since;
    when the block ends, that work has finished. The tensors it reads are
    kept alive by the caller until then."""
    if event is None:
        yield
        return
    side = _fetch_stream(dev)
    side.wait_event(event)
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        side.synchronize()


def _start_fetch(t: torch.Tensor, dev: torch.device):
    """Queue a copy of ``t``'s bytes into a pooled host buffer. Returns
    (a flat uint8 numpy view, valid once the enclosing :func:`_fetching`
    block has ended; the buffer to give back)."""
    src = t.contiguous().view(torch.uint8).reshape(-1)
    buf = staging_pool.rent(src.numel(), pinned=dev.type == "cuda")
    dst = buf[: src.numel()]
    dst.copy_(src, non_blocking=True)
    return dst.numpy(), buf


# ---------------------------------------------------------------------------
# Batched one-shot paths
# ---------------------------------------------------------------------------


def _compress_chunks_batched(chunks: list, engine: str = "auto", device=None) -> list[bytes]:
    """Compress a list of <= 64 KiB chunks (batched on the device, or via
    a host engine); returns full framed data-chunk bytes (header + CRC +
    payload)."""
    engine = block_rt._pick_engine(engine)
    if engine in ("native", "oracle"):
        eng, crc_fn = (native, native.crc32c) if engine == "native" else (oracle, crc32c)
        out = []
        for c in chunks:
            c = bytes(c)
            checksum = mask_crc(crc_fn(c)).to_bytes(4, "little")
            out.append(frame_data_chunk(c, eng.compress(c), checksum))
        return out
    dev = resolve_device(device)
    with _on(dev):
        return _compress_chunks_device(chunks, dev)


def _compress_chunks_device(chunks: list, dev: torch.device) -> list[bytes]:
    """The device path of :func:`_compress_chunks_batched`: per sub-batch,
    the whole data-chunk pipeline (encode, CRC32C and masking, varint,
    chunk header, uncompressed fallback) on the device, then the ragged
    framed rows compacted end to end and fetched at their true size."""
    codec = SnappyCodec(with_crc=True, kernel=block_rt._device_kernel(), device=dev)
    results: list[bytes] = [b""] * len(chunks)
    nsub = -(-len(chunks) // _SUB_BATCH)
    sub = _SUB_BATCH if nsub > 1 else len(chunks)

    def submit(s: int):
        lo = s * sub
        hi = min(len(chunks), lo + sub)
        stage = _Stage(hi - lo, BLOCK_SIZE, dev)
        try:
            for j, c in enumerate(chunks[lo:hi]):
                a = np.frombuffer(c, np.uint8)
                # Pooled rows are not clean, and the tail past a chunk stays
                # as it is: the encoders and the CRC stage or read a row only
                # up to its length, and a framed row is fetched only up to
                # its framed length, so no byte of the tail can reach the
                # stream.
                stage.rows[j, : len(a)] = a
                stage.lens[j] = len(a)
            frags, lengths = stage.to(dev)
            packed, flens = codec.frame_batch_packed(frags, lengths)
            done = _mark(dev)
        except BaseException:
            _drain(dev)
            stage.release()
            raise
        return packed, flens, done, lo, hi, stage

    def fetch(packed, flens, done, lo, hi, stage):
        buf = None
        try:
            with _fetching(dev, done):
                flens_h = flens.cpu().numpy()
                if (flens_h > packed.shape[1] * 4).any():
                    raise RuntimeError(
                        "framed chunk exceeds its slot: emission bound violated (kernel bug)"
                    )
                wlens_h = (flens_h.astype(np.int64) + 3) >> 2
                flat = compact_words(packed, (flens + 3) >> 2, int(wlens_h.sum()))
                host, buf = _start_fetch(flat, dev)
            offs = np.concatenate([[0], np.cumsum(wlens_h)]) * 4
            for j in range(hi - lo):
                o = int(offs[j])
                results[lo + j] = host[o : o + int(flens_h[j])].tobytes()
        finally:
            release(packed, flens, done, lo, hi, stage)
            if buf is not None:
                staging_pool.giveback(buf)

    def release(packed, flens, done, lo, hi, stage):
        _wait(done)  # the copy that reads the stage has finished by then
        stage.release()

    _pipeline(submit, fetch, nsub, release=release)
    return results


def _decode_crc_pack(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int = BLOCK_SIZE):
    """Batched block decode, per-row CRC32C of the decoded bytes
    (SnappyStreamDecompressor.cs:117-131 parity) and word-packing of the
    outputs, on the tensors' device: the decode kernel, then the CRC32C
    kernel over the decoded rows and their lengths (their plain versions
    for CPU tensors), or the scan engine's decoder and CRC when that is the
    process's engine. Returns (packed int32 [B, out_cap // 4], out_lens,
    errs, crcs)."""
    kernel = block_rt._device_kernel()
    outs, out_lens, errs = decode_rows(comp, comp_lens, out_cap, kernel)
    crcs = crc_rows(outs, out_lens, kernel)
    return pack_rows(outs), out_lens, errs, crcs


def _decompress_chunks_batched(payloads: list[bytes], engine: str = "auto",
                               device=None) -> tuple[list[bytes], list[int]]:
    """Decode a list of compressed data-chunk payloads (block-format
    buffers, each <= 64 KiB uncompressed) in device sub-batches, or via
    the host engines.

    Returns ``(bodies, crcs)``: the decoded bytes and the (unmasked)
    CRC32C of each body. On the device engine the CRCs come from the
    CRC32C kernel over the decode outputs; host-engine and oversize paths
    use the host CRC."""
    if not payloads:
        return [], []
    engine = block_rt._pick_engine(engine)
    if engine in ("native", "oracle"):
        eng = native if engine == "native" else oracle
        out = []
        for p in payloads:
            expected, _ = read_varint(p)
            if expected > MAX_CHUNK_UNCOMPRESSED:
                raise InvalidDataError("chunk exceeds 64 KiB uncompressed cap")
            out.append(eng.decompress(p))
        return out, [_host_crc_of_decoded(b) for b in out]
    dev = resolve_device(device)
    # Spec-legal payloads can be up to 16 MiB compressed as long as the
    # uncompressed size fits the 64 KiB chunk cap; anything too big for
    # the device slot decodes through the host block engine.
    oversize: dict[int, bytes] = {}
    for i, p in enumerate(payloads):
        expected, _ = read_varint(p)
        if expected > MAX_CHUNK_UNCOMPRESSED:
            raise InvalidDataError("chunk exceeds 64 KiB uncompressed cap")
        if len(p) > CHUNK_COMP_CAP - 8:
            oversize[i] = block_rt.decompress(
                p, engine="native" if native.available() else "oracle"
            )
    result: list[bytes] = [b""] * len(payloads)
    crcs: list[int] = [0] * len(payloads)
    for i, body in oversize.items():
        result[i] = body
        crcs[i] = _host_crc_of_decoded(body)
    device_idx = [i for i in range(len(payloads)) if i not in oversize]
    if device_idx:
        with _on(dev):
            _decompress_chunks_device(payloads, device_idx, result, crcs, dev)
    return result, crcs


def _decompress_chunks_device(payloads, device_idx, result, crcs, dev: torch.device) -> None:
    """The device path of :func:`_decompress_chunks_batched`: fills
    ``result`` and ``crcs`` at ``device_idx``. Compressed slots are as wide
    as the sub-batch's longest payload, and error words raise in chunk
    order."""
    nsub = -(-len(device_idx) // _SUB_BATCH)
    sub = _SUB_BATCH if nsub > 1 else len(device_idx)

    def submit(s: int):
        lo = s * sub
        hi = min(len(device_idx), lo + sub)
        group = device_idx[lo:hi]
        width = -(-max(len(payloads[i]) for i in group) // 16) * 16
        stage = _Stage(len(group), width, dev)
        try:
            for j, i in enumerate(group):
                a = np.frombuffer(payloads[i], np.uint8)
                stage.rows[j, : len(a)] = a
                stage.lens[j] = len(a)
            out = _decode_crc_pack(*stage.to(dev))
            done = _mark(dev)
        except BaseException:
            _drain(dev)
            stage.release()
            raise
        return (*out, done, lo, hi, stage)

    def fetch(packed, out_lens, errs, dev_crcs, done, lo, hi, stage):
        buf = None
        try:
            with _fetching(dev, done):
                rows, buf = _start_fetch(packed, dev)
                out_lens_h, errs_h, crcs_h = torch.stack([out_lens, errs, dev_crcs]).cpu().numpy()
            rows = rows.reshape(hi - lo, -1)
            crcs_h = crcs_h.view(np.uint32)
            for j in range(hi - lo):
                i = device_idx[lo + j]
                block_rt._raise_for_err(int(errs_h[j]))
                result[i] = rows[j, : int(out_lens_h[j])].tobytes()
                crcs[i] = int(crcs_h[j])
        finally:
            release(packed, out_lens, errs, dev_crcs, done, lo, hi, stage)
            if buf is not None:
                staging_pool.giveback(buf)

    def release(packed, out_lens, errs, dev_crcs, done, lo, hi, stage):
        _wait(done)  # the copy that reads the stage has finished by then
        stage.release()

    _pipeline(submit, fetch, nsub, release=release)


def stream_compress(data, engine: str = "auto", threads: int = 0, device=None) -> bytes:
    """One-shot framing-format compress (batched on the device, or
    entirely inside the C++ runtime for the native engine: chunking, CRC
    and headers included). ``threads`` applies to the native engine's
    chunk-parallel pipeline (0 = hardware concurrency, 1 = serial; output
    bytes identical at every count)."""
    data = bytes(data)
    with span("stream.compress", len(data)):
        if block_rt._pick_engine(engine) == "native":
            return native.stream_compress(data, threads=threads)
        view = memoryview(data)
        chunks = [
            view[i : i + MAX_CHUNK_UNCOMPRESSED]
            for i in range(0, len(data), MAX_CHUNK_UNCOMPRESSED)
        ]
        return b"".join([STREAM_HEADER] + _compress_chunks_batched(chunks, engine, device))


def stream_decompress(data, engine: str = "auto", threads: int = 0, device=None) -> bytes:
    """One-shot framing-format decompress with full CRC verification.
    ``threads`` as in :func:`stream_compress` (identical verdicts at
    every count)."""
    data = bytes(data)
    with span("stream.decompress", len(data)):
        if block_rt._pick_engine(engine) == "native":
            return native.stream_decompress(data, threads=threads)
        d = StreamDecompressor(engine=engine, device=device)
        out = d.decompress(data)
        d.finish()
        return out


# ---------------------------------------------------------------------------
# Incremental state machines
# ---------------------------------------------------------------------------


class StreamCompressor:
    """Incremental framing compressor: buffers input to 64 KiB chunk
    boundaries; ``flush`` seals a partial chunk (each flush creates a
    chunk, matching SnappyStreamCompressor.Flush :82; tests exploit this
    to create many tiny chunks, SnappyStreamTests.cs:158-192)."""

    def __init__(self, engine: str = "auto", device=None) -> None:
        self._buf = bytearray()
        self._header_written = False
        self._engine = engine
        self._device = device

    def _header(self) -> bytes:
        if self._header_written:
            return b""
        self._header_written = True
        return STREAM_HEADER

    def write(self, data: bytes) -> bytes:
        """Feed input; returns any framed bytes produced."""
        self._buf += data
        if len(self._buf) < MAX_CHUNK_UNCOMPRESSED:
            return self._header()
        chunks = []
        while len(self._buf) >= MAX_CHUNK_UNCOMPRESSED:
            chunks.append(bytes(self._buf[:MAX_CHUNK_UNCOMPRESSED]))
            del self._buf[:MAX_CHUNK_UNCOMPRESSED]
        return self._header() + b"".join(
            _compress_chunks_batched(chunks, self._engine, self._device)
        )

    def flush(self) -> bytes:
        """Seal the current partial chunk, if any."""
        out = self._header()
        if self._buf:
            chunk = bytes(self._buf)
            self._buf.clear()
            out += _compress_chunks_batched([chunk], self._engine, self._device)[0]
        return out


class StreamDecompressor:
    """Incremental framing decompressor, resumable at any byte boundary:
    incomplete chunk bytes stay pending until the next feed (subsumes
    SnappyStreamDecompressor's scratch machinery,
    SnappyStreamDecompressor.cs:11-36, 215-289)."""

    def __init__(self, engine: str = "auto", device=None) -> None:
        self._pending = bytearray()
        self._seen_header = False
        self._engine = engine
        self._device = device

    def decompress(self, data: bytes) -> bytes:
        """Feed framed bytes; returns decoded bytes available so far."""
        self._pending += data
        payloads: list[bytes] = []  # compressed payloads for batch decode
        order: list[bytes | int] = []  # assembly plan: a stored body, or a payload's index
        crcs: list[int] = []
        with memoryview(self._pending) as buf:  # slices copy once, into the payloads
            pos = self._parse(buf, payloads, order, crcs)
        del self._pending[:pos]
        decoded, body_crcs = _decompress_chunks_batched(payloads, self._engine, self._device)
        parts = []
        for v in order:
            if isinstance(v, int):
                if body_crcs[v] != crcs[v]:
                    raise InvalidDataError("chunk CRC32C mismatch")
                v = decoded[v]
            parts.append(v)
        return b"".join(parts)

    def _parse(self, buf: memoryview, payloads: list, order: list, crcs: list) -> int:
        """Walk the complete chunks of ``buf``: compressed payloads and
        their expected CRCs are collected for the batch decode, stored
        chunks are verified here. Returns the bytes consumed."""
        pos = 0
        while True:
            if pos + 4 > len(buf):
                break
            ctype = buf[pos]
            plen = int.from_bytes(buf[pos + 1 : pos + 4], "little")
            if ctype == CHUNK_STREAM_IDENTIFIER and plen != 6:
                raise InvalidDataError("bad stream identifier length")
            # No compressed-size cap here: the 3-byte chunk length field
            # bounds plen at 16 MiB - 1 and the format only caps the
            # *uncompressed* size (checked after the varint preamble is
            # read), as SnappyStreamDecompressor accepts any spec-legal
            # payload size.
            if pos + 4 + plen > len(buf):
                break
            payload = buf[pos + 4 : pos + 4 + plen]
            pos += 4 + plen
            if ctype == CHUNK_STREAM_IDENTIFIER:
                if payload != STREAM_HEADER[4:]:
                    raise InvalidDataError("bad stream identifier payload")
                self._seen_header = True
                continue
            if not self._seen_header:
                raise InvalidDataError("data before stream identifier")
            if ctype == CHUNK_COMPRESSED_DATA:
                if len(payload) < 4:
                    raise InvalidDataError("data chunk shorter than its CRC")
                crcs.append(unmask_crc(int.from_bytes(payload[:4], "little")))
                order.append(len(payloads))
                payloads.append(bytes(payload[4:]))
            elif ctype == CHUNK_UNCOMPRESSED_DATA:
                if len(payload) < 4:
                    raise InvalidDataError("data chunk shorter than its CRC")
                if len(payload) - 4 > MAX_CHUNK_UNCOMPRESSED:
                    raise InvalidDataError("chunk exceeds 64 KiB uncompressed cap")
                body = bytes(payload[4:])
                expected = unmask_crc(int.from_bytes(payload[:4], "little"))
                if _host_crc_fn()(body) != expected:
                    raise InvalidDataError("chunk CRC32C mismatch")
                order.append(body)
            elif ctype == CHUNK_PADDING or ctype >= 0x80:
                continue
            else:
                raise InvalidDataError(f"unknown unskippable chunk type 0x{ctype:02x}")
        return pos

    def finish(self) -> None:
        """Assert end of stream (no dangling partial chunk)."""
        if self._pending:
            raise InvalidDataError(f"{len(self._pending)} trailing bytes of incomplete chunk")


# ---------------------------------------------------------------------------
# File-object adapters (SnappyStream parity)
# ---------------------------------------------------------------------------


class SnappyWriter:
    """Write-mode SnappyStream: wraps a binary file object, writes the
    framing format. Parity: SnappyStream.cs compression mode
    (ctor :55, WriteCore :381, Flush :135, Dispose :486)."""

    def __init__(self, inner, leave_open: bool = False, engine: str = "auto",
                 device=None) -> None:
        self._inner = inner
        self._leave_open = leave_open
        self._comp: StreamCompressor | None = StreamCompressor(engine=engine, device=device)

    def _check_open(self) -> StreamCompressor:
        if self._comp is None:
            raise InvalidOperationError("stream is closed")
        return self._comp

    def write(self, data: bytes) -> int:
        out = self._check_open().write(bytes(data))
        if out:
            self._inner.write(out)
        return len(data)

    def flush(self) -> None:
        out = self._check_open().flush()
        if out:
            self._inner.write(out)
        if hasattr(self._inner, "flush"):
            self._inner.flush()

    def close(self) -> None:
        if self._comp is None:
            return
        out = self._comp.flush()
        self._comp = None
        if out:
            self._inner.write(out)
        if not self._leave_open:
            self._inner.close()

    def writable(self) -> bool:
        return True

    def readable(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SnappyReader:
    """Read-mode SnappyStream: wraps a binary file object containing a
    framed stream. Parity: SnappyStream.cs decompression mode
    (ReadCore :194, pooled 8 KiB transfer buffer :16)."""

    def __init__(self, inner, leave_open: bool = False,
                 transfer_size: int = DEFAULT_TRANSFER_SIZE, engine: str = "auto",
                 device=None) -> None:
        self._inner = inner
        self._leave_open = leave_open
        self._transfer = transfer_size
        self._decomp: StreamDecompressor | None = StreamDecompressor(engine=engine,
                                                                     device=device)
        self._ready = bytearray()
        self._eof = False

    def _check_open(self) -> StreamDecompressor:
        if self._decomp is None:
            raise InvalidOperationError("stream is closed")
        return self._decomp

    def read(self, size: int = -1) -> bytes:
        d = self._check_open()
        while not self._eof and (size < 0 or len(self._ready) < size):
            raw = self._inner.read(self._transfer)
            if not raw:
                self._eof = True
                d.finish()
                break
            self._ready += d.decompress(raw)
        if size < 0:
            out = bytes(self._ready)
            self._ready.clear()
        else:
            out = bytes(self._ready[:size])
            del self._ready[:size]
        return out

    def readall(self) -> bytes:
        return self.read(-1)

    def close(self) -> None:
        if self._decomp is None:
            return
        self._decomp = None
        if not self._leave_open:
            self._inner.close()

    def readable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def SnappyStream(inner, mode: str = "rb", **kw):
    """Convenience factory mirroring the reference's single
    ``SnappyStream`` class (SnappyStream.cs:55 ctor with
    CompressionMode): ``mode='rb'`` returns a :class:`SnappyReader`,
    ``mode='wb'`` a :class:`SnappyWriter`."""
    if mode in ("rb", "r", "read", "decompress"):
        return SnappyReader(inner, **kw)
    if mode in ("wb", "w", "write", "compress"):
        return SnappyWriter(inner, **kw)
    raise ValueError(f"unsupported mode {mode!r}")


# ---------------------------------------------------------------------------
# Async adapters (SnappyStream's async surface)
# ---------------------------------------------------------------------------


class AsyncSnappyWriter:
    """Async twin of :class:`SnappyWriter` (parity: SnappyStream's
    WriteAsync/FlushAsync/DisposeAsync surface, SnappyStream.cs:393,
    :99, :533). Codec work runs in a worker thread via
    ``asyncio.to_thread``; like the reference's single-async-operation
    guard (SnappyStream.cs:611-637), concurrent operations on one
    stream are serialized with an internal lock."""

    def __init__(self, inner, leave_open: bool = False, engine: str = "auto", device=None):
        self._w = SnappyWriter(inner, leave_open=leave_open, engine=engine, device=device)
        self._lock = asyncio.Lock()

    async def write(self, data: bytes) -> int:
        async with self._lock:
            return await asyncio.to_thread(self._w.write, data)

    async def flush(self) -> None:
        async with self._lock:
            await asyncio.to_thread(self._w.flush)

    async def close(self) -> None:
        async with self._lock:
            await asyncio.to_thread(self._w.close)

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()


class AsyncSnappyReader:
    """Async twin of :class:`SnappyReader` (ReadAsync surface,
    SnappyStream.cs:235-346)."""

    def __init__(self, inner, **kw):
        self._r = SnappyReader(inner, **kw)
        self._lock = asyncio.Lock()

    async def read(self, size: int = -1) -> bytes:
        async with self._lock:
            return await asyncio.to_thread(self._r.read, size)

    async def close(self) -> None:
        async with self._lock:
            await asyncio.to_thread(self._r.close)

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()
