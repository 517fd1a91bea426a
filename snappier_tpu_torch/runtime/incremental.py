"""Incremental block-format decompressor, resumable at any byte
boundary (port of ``snappier_tpu/runtime/incremental.py``).

Parity target: the reference's ``SnappyDecompressor`` streaming
contract (SnappyDecompressor.cs): repeated ``Decompress(chunk)`` calls
with arbitrary input splits, a 5-byte scratch for tags/varints split
across feeds (:11-31, :428-495), ``_remainingLiteral`` for literal
payloads spanning feeds (:29, 290-297), ``ExpectedLength`` /
``AllDataDecompressed`` / ``ExtractData`` lifecycle (:497-673). Used by
the framing layer and the ``decompress_iter`` API
(``Snappy.Decompress(ReadOnlySequence)`` analog, Snappy.cs:194-212).

This is a host path by design (SURVEY.md §5.4): byte-granular resume
semantics are kept host-side; device work stays block-granular.
"""

from __future__ import annotations

import numpy as np

from snappier_tpu_torch.constants import (
    BLOCK_SIZE,
    MAX_SHORT_LITERAL,
    TAG_COPY1,
    TAG_COPY2,
    TAG_LITERAL,
)
from snappier_tpu_torch.errors import InvalidDataError, InvalidOperationError
from snappier_tpu_torch.format.varint import read_varint, write_varint
from snappier_tpu_torch.runtime import block as block_rt

_MAX_PLAUSIBLE = 1 << 32


class BlockDecompressor:
    """Feed compressed block-format bytes in arbitrary pieces; decoded
    output accumulates and can be drained with :meth:`read` or taken
    whole with :meth:`extract_data`."""

    def __init__(self) -> None:
        self._pre = bytearray()  # varint preamble scratch
        self._expected: int | None = None
        self._out = bytearray()
        self._base = 0  # bytes drained off the front of _out (writer mode)
        self._tail = b""  # incomplete tag bytes (<= 5, or tag+partial lit)
        self._remaining_literal = 0
        self._read_pos = 0
        self._extracted = False

    # -- properties mirroring SnappyDecompressor ------------------------

    @property
    def expected_length(self) -> int | None:
        """Uncompressed length from the preamble, once available
        (SnappyDecompressor.cs ExpectedLength)."""
        return self._expected

    @property
    def all_data_decompressed(self) -> bool:
        """True once the full promised output has been produced."""
        return (
            self._expected is not None
            and self._base + len(self._out) == self._expected
        )

    # -- feeding ---------------------------------------------------------

    def _feed_preamble(self, data: bytes, pos: int) -> int:
        while self._expected is None and pos < len(data):
            b = data[pos]
            pos += 1
            self._pre.append(b)
            if not (b & 0x80):
                value = 0
                for i, pb in enumerate(self._pre):
                    value |= (pb & 0x7F) << (7 * i)
                if value >= _MAX_PLAUSIBLE:
                    raise InvalidDataError("varint32 overflow")
                self._expected = value
                return pos
            if len(self._pre) >= 5:
                raise InvalidDataError("varint32 longer than 5 bytes")
        return pos

    def decompress(self, chunk) -> int:
        """Consume ``chunk``; returns the count of newly produced
        output bytes. Raises on malformed data."""
        if self._extracted:
            raise InvalidOperationError("decompressor already drained")
        data = bytes(chunk)
        produced0 = len(self._out)
        pos = 0
        if self._expected is None:
            pos = self._feed_preamble(data, pos)
            if self._expected is None:
                return 0
        if self._tail:
            data = self._tail + data[pos:]
            self._tail = b""
            pos = 0

        out = self._out
        expected = self._expected
        n = len(data)
        # Pending literal payload from the previous feed.
        if self._remaining_literal:
            take = min(self._remaining_literal, n - pos)
            out += data[pos : pos + take]
            self._remaining_literal -= take
            pos += take

        while pos < n:
            tag = data[pos]
            tag_type = tag & 3
            if tag_type == TAG_LITERAL:
                len6 = tag >> 2
                if len6 < MAX_SHORT_LITERAL:
                    length = len6 + 1
                    hdr = 1
                else:
                    extra = len6 - 59
                    if pos + 1 + extra > n:
                        break  # split descriptor -> scratch
                    length = (
                        int.from_bytes(data[pos + 1 : pos + 1 + extra], "little")
                        + 1
                    )
                    hdr = 1 + extra
                if self._base + len(out) + length > expected:
                    raise InvalidDataError("literal overruns output")
                avail = min(length, n - pos - hdr)
                out += data[pos + hdr : pos + hdr + avail]
                if avail < length:
                    # Literal spans feeds (_remainingLiteral semantics).
                    self._remaining_literal = length - avail
                    pos = n
                    break
                pos += hdr + length
                continue
            if tag_type == TAG_COPY1:
                need = 2
            elif tag_type == TAG_COPY2:
                need = 3
            else:
                need = 5
            if pos + need > n:
                break  # split tag -> scratch
            if tag_type == TAG_COPY1:
                length = ((tag >> 2) & 0x7) + 4
                offset = ((tag >> 5) << 8) | data[pos + 1]
            elif tag_type == TAG_COPY2:
                length = (tag >> 2) + 1
                offset = int.from_bytes(data[pos + 1 : pos + 3], "little")
            else:
                length = (tag >> 2) + 1
                offset = int.from_bytes(data[pos + 1 : pos + 5], "little")
            opos = self._base + len(out)
            if offset == 0 or offset > opos:
                raise InvalidDataError("copy offset out of range")
            if opos + length > expected:
                raise InvalidDataError("copy overruns output")
            src = len(out) - offset
            if src < 0:
                # Legal per the wire format but the prefix was already
                # drained to the writer: a copy reaching farther back
                # than the retained window (every known encoder stays
                # within 64 KiB — fragment independence,
                # SnappyCompressor.cs:40-44).
                raise InvalidOperationError(
                    f"copy offset {offset} reaches beyond the retained "
                    "lookback window; decode without writer= or raise "
                    "lookback="
                )
            if offset >= length:
                out += out[src : src + length]
            else:
                for i in range(length):
                    out.append(out[src + i])
            pos += need

        if pos < n:
            self._tail = bytes(data[pos:])
            if len(self._tail) > 8 and self._remaining_literal == 0:
                # A complete tag always fits in 5 bytes + its literal
                # payload, which we consume eagerly; a long stuck tail
                # means corruption.
                raise InvalidDataError("unparseable tag sequence")
        if (
            self.all_data_decompressed
            and (self._tail or self._remaining_literal)
        ):
            raise InvalidDataError("trailing data after promised output")
        return len(self._out) - produced0

    # -- draining --------------------------------------------------------

    def read(self, size: int = -1) -> bytes:
        """Drain up to ``size`` decoded bytes (SnappyDecompressor.Read)."""
        if size < 0:
            size = len(self._out) - self._read_pos
        out = bytes(self._out[self._read_pos : self._read_pos + size])
        self._read_pos += len(out)
        return out

    def drain_to(self, emit, keep: int) -> int:
        """Writer-mode drain: hand decoded bytes older than the
        trailing ``keep``-byte lookback window to ``emit`` (a callable
        taking bytes) and discard them, bounding memory at
        O(window + chunk). Copies may still reference the retained
        window; one reaching past it raises (see the copy handler).
        Returns the byte count emitted. Not combinable with
        :meth:`read`/:meth:`extract_data` (the streamed prefix is
        gone)."""
        if self._read_pos:
            raise InvalidOperationError("cannot drain after partial reads")
        cut = len(self._out) - keep
        if self.all_data_decompressed:
            cut = len(self._out)  # flush everything at end of stream
        if cut <= 0:
            return 0
        emit(bytes(memoryview(self._out)[:cut]))
        del self._out[:cut]
        self._base += cut
        return cut

    def extract_data(self) -> bytes:
        """Take the complete decoded buffer; only valid once all data
        has been decompressed and nothing was drained via :meth:`read`
        (SnappyDecompressor.ExtractData lifecycle, :640-673)."""
        if not self.all_data_decompressed:
            raise InvalidOperationError("stream not fully decompressed yet")
        if self._read_pos or self._base:
            raise InvalidOperationError("cannot extract after partial reads")
        if self._extracted:
            raise InvalidOperationError("already extracted")
        self._extracted = True
        return bytes(self._out)

    # -- test hooks --------------------------------------------------------
    # The reference exposes the same three state-injection hooks to its
    # test assembly (SnappyDecompressor.cs:686-718 via InternalsVisibleTo)
    # for the scratch-poisoning regression (SnappyDecompressorTests.cs
    # :42-58). Not part of the public API.

    def set_expected_length_for_test(self, n: int) -> None:
        self._expected = n
        self._pre = bytearray(b"\0")  # preamble consumed

    def write_to_buffer_for_test(self, data: bytes) -> None:
        self._out += bytes(data)

    def load_scratch_for_test(self, scratch: bytes, length: int) -> None:
        """Load tag-scratch state. Mirroring the reference hook's
        shape: ``scratch`` may carry poison bytes past ``length`` —
        only the first ``length`` bytes are live state (our scratch is
        an exact-length tail, so the poison is dropped here by
        construction; the ported regression asserts decode behaves as
        if it were)."""
        if length > 8:
            raise ValueError("scratch length exceeds limit")
        self._tail = bytes(scratch[:length])

    def finish(self) -> None:
        """Assert completion (no dangling tag bytes, full output)."""
        if self._tail or self._remaining_literal:
            raise InvalidDataError("truncated compressed stream")
        if self._expected is None:
            raise InvalidDataError("truncated varint length preamble")
        if not self.all_data_decompressed:
            raise InvalidDataError(
                f"decoded {self._base + len(self._out)} of "
                f"{self._expected} promised bytes"
            )


def decompress_iter(chunks, writer=None, lookback: int = BLOCK_SIZE):
    """Decompress a block-format stream supplied as an iterable of
    byte chunks (``Snappy.Decompress(ReadOnlySequence)`` analog,
    Snappy.cs:194-212).

    With ``writer`` (a callable taking bytes, or any object with a
    ``write`` method — the ``IBufferWriter`` analog,
    SnappyDecompressor.cs:524-527), decoded output streams to the
    writer as it is produced and the return value is the total byte
    count written. Peak memory is O(lookback + chunk) with NO
    full-output intermediate: only the trailing
    ``lookback`` bytes are retained for copy references. The default
    window (64 KiB, the format's LZ window — Constants.cs:25-27) covers
    every known encoder, which never emits a farther offset (fragment
    independence, SnappyCompressor.cs:40-44); a spec-legal-but-unseen
    farther copy4 raises ``InvalidOperationError`` — raise ``lookback``
    or use buffered mode for such streams.

    Without ``writer``, returns the full decoded bytes (O(output) is
    then inherent)."""
    d = BlockDecompressor()
    if writer is None:
        for c in chunks:
            d.decompress(c)
        d.finish()
        return d.extract_data()
    emit = writer.write if hasattr(writer, "write") else writer
    total = 0
    for c in chunks:
        d.decompress(c)
        total += d.drain_to(emit, lookback)
    d.finish()
    total += d.drain_to(emit, 0)
    return total


def compress_iter(chunks, engine: str = "auto", batch_blocks: int = 64,
                  writer=None, total_length: int | None = None, device=None):
    """Compress the logical concatenation of an iterable of byte chunks
    (``Snappy.Compress(ReadOnlySequence, IBufferWriter)`` analog,
    Snappy.cs:82-97).

    Truly incremental like the reference's per-segment loop: input is
    staged at most ``batch_blocks`` x 64 KiB at a time (fragments are
    independent, SURVEY.md §1, so bodies from separate batches
    concatenate into one valid stream), and the result is byte-identical
    to the one-shot ``compress`` of the concatenation.

    With ``writer`` (a callable taking bytes, or any object with a
    ``write`` method — the ``IBufferWriter`` analog), output streams to
    the writer batch by batch and the return value is the total byte
    count written; peak memory is O(batch), with NO full-output
    intermediate. The Snappy block format's
    length preamble comes first, so the total input length must be
    known up front, exactly as the reference's ``ReadOnlySequence``
    carries a ``Length``: pass a sized sequence of chunks (list/tuple
    of buffers) or an explicit ``total_length``. A ``total_length``
    that disagrees with the chunks raises ``InvalidOperationError``.
    ``engine`` and ``device`` are those of
    :func:`snappier_tpu_torch.runtime.block.compress`, called once per
    batch.

    Without ``writer``, returns the compressed stream as bytes
    (O(output) is then inherent)."""
    span = BLOCK_SIZE * batch_blocks

    def bodies_of(data: bytes) -> bytes:
        comp = block_rt.compress(data, engine=engine, device=device)
        _, off = read_varint(np.frombuffer(comp, np.uint8))
        return comp[off:]

    if writer is not None:
        emit = writer.write if hasattr(writer, "write") else writer
        if total_length is None:
            # Only a SIZED container may be pre-summed — sum() over a
            # generator would consume it before the compression loop.
            if not hasattr(chunks, "__len__"):
                raise InvalidOperationError(
                    "writer mode needs the total input length up front "
                    "(the block format's preamble comes first): pass a "
                    "sized sequence of chunks or total_length="
                )
            total_length = sum(len(c) for c in chunks)
        written = 0

        def sink(b: bytes) -> None:
            nonlocal written
            emit(b)
            written += len(b)

        sink(write_varint(total_length))
    else:
        out = bytearray()
        sink = out.__iadd__

    buf = bytearray()
    total = 0
    for c in chunks:
        c = bytes(c)
        buf += c
        total += len(c)
        while len(buf) >= span:
            sink(bodies_of(bytes(buf[:span])))
            del buf[:span]
    if buf or total == 0:
        sink(bodies_of(bytes(buf)))

    if writer is not None:
        if total != total_length:
            raise InvalidOperationError(
                f"chunks totalled {total} bytes but the preamble "
                f"promised {total_length}"
            )
        return written
    return write_varint(total) + bytes(out)
