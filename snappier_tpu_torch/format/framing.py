"""Snappy framing format: scalar host-side reference implementation
(port of ``snappier_tpu/format/framing.py``).

Wire law (parity: ``Snappier/Internal/SnappyStreamCompressor.cs`` /
``SnappyStreamDecompressor.cs``):

* Stream starts with the 10-byte stream-identifier chunk
  (``STREAM_HEADER``, SnappyStreamCompressor.cs:18-21).
* Every chunk: 1 type byte + 3-byte LE payload length. Data chunks'
  payload is a 4-byte LE *masked CRC32C of the uncompressed data*
  followed by the (compressed or raw) bytes
  (SnappyStreamCompressor.cs:199,232-261).
* Uncompressed payload per data chunk is capped at 64 KiB
  (SnappyStreamCompressor.cs:170-189).
* If compression does not shrink a block, an UncompressedData chunk is
  emitted instead (SnappyStreamCompressor.cs:213-229).
* Decoder: skippable chunk types (>= 0x80) and padding are skipped;
  unknown unskippable types (0x02..0x7f) are an error; CRC mismatches
  are an error (SnappyStreamDecompressor.cs:127-199).

This module is the behavioural oracle; the production path batches chunk
payloads onto the card (``snappier_tpu_torch.runtime.stream``) and
computes CRCs with the CRC32C kernel.
"""

from __future__ import annotations

from typing import Callable

from snappier_tpu_torch.constants import (
    CHUNK_COMPRESSED_DATA,
    CHUNK_PADDING,
    CHUNK_STREAM_IDENTIFIER,
    CHUNK_UNCOMPRESSED_DATA,
    MAX_CHUNK_UNCOMPRESSED,
    STREAM_HEADER,
)
from snappier_tpu_torch.errors import InvalidDataError
from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.format.crc32c import crc32c, mask_crc, unmask_crc


def write_chunk_header(chunk_type: int, payload_len: int) -> bytes:
    if payload_len >= 1 << 24:
        raise ValueError("framing chunk payload exceeds 24-bit length")
    return bytes([chunk_type]) + payload_len.to_bytes(3, "little")


def frame_data_chunk(chunk: bytes, comp: bytes, checksum: bytes) -> bytes:
    """One data chunk from a block, its compressed form and its masked
    CRC32C bytes: compressed when that is smaller, else the uncompressed
    fallback (SnappyStreamCompressor.cs:213-229)."""
    if len(comp) < len(chunk):
        return write_chunk_header(CHUNK_COMPRESSED_DATA, 4 + len(comp)) + checksum + comp
    return write_chunk_header(CHUNK_UNCOMPRESSED_DATA, 4 + len(chunk)) + checksum + chunk


def compress_chunk(block: bytes, compress_fn: Callable[[bytes], bytes]) -> bytes:
    """One data chunk for <= 64 KiB of input, with the uncompressed
    fallback when compression does not shrink the payload."""
    if len(block) > MAX_CHUNK_UNCOMPRESSED:
        raise ValueError("a data chunk holds at most 64 KiB")
    checksum = mask_crc(crc32c(block)).to_bytes(4, "little")
    return frame_data_chunk(block, compress_fn(block), checksum)


def frame_compress(data: bytes, compress_fn: Callable[[bytes], bytes] | None = None) -> bytes:
    """Whole-buffer framing-format compress (header + data chunks)."""
    compress_fn = compress_fn or oracle.compress
    out = bytearray(STREAM_HEADER)
    for start in range(0, len(data), MAX_CHUNK_UNCOMPRESSED):
        out += compress_chunk(data[start : start + MAX_CHUNK_UNCOMPRESSED], compress_fn)
    return bytes(out)


def iter_chunks(data: bytes):
    """Yield ``(chunk_type, payload_bytes, position)`` over a framed
    stream, validating structure (not CRCs)."""
    pos = 0
    n = len(data)
    while pos < n:
        if pos + 4 > n:
            raise InvalidDataError("truncated chunk header")
        chunk_type = data[pos]
        payload_len = int.from_bytes(data[pos + 1 : pos + 4], "little")
        pos += 4
        if pos + payload_len > n:
            raise InvalidDataError("truncated chunk payload")
        yield chunk_type, data[pos : pos + payload_len], pos
        pos += payload_len


def frame_decompress(data: bytes, decompress_fn: Callable[[bytes], bytes] | None = None) -> bytes:
    """Whole-buffer framing-format decompress with CRC verification."""
    decompress_fn = decompress_fn or oracle.decompress
    out = bytearray()
    seen_header = False
    for chunk_type, payload, _pos in iter_chunks(data):
        if chunk_type == CHUNK_STREAM_IDENTIFIER:
            if payload != STREAM_HEADER[4:]:
                raise InvalidDataError("bad stream identifier payload")
            seen_header = True
            continue
        if not seen_header:
            raise InvalidDataError("data before stream identifier")
        if chunk_type in (CHUNK_COMPRESSED_DATA, CHUNK_UNCOMPRESSED_DATA):
            if len(payload) < 4:
                raise InvalidDataError("data chunk shorter than its CRC")
            expected_crc = unmask_crc(int.from_bytes(payload[:4], "little"))
            body = payload[4:]
            block = decompress_fn(body) if chunk_type == CHUNK_COMPRESSED_DATA else body
            if len(block) > MAX_CHUNK_UNCOMPRESSED:
                raise InvalidDataError("chunk exceeds 64 KiB uncompressed cap")
            if crc32c(block) != expected_crc:
                raise InvalidDataError("chunk CRC32C mismatch")
            out += block
            continue
        if chunk_type == CHUNK_PADDING or chunk_type >= 0x80:
            continue  # skippable
        raise InvalidDataError(f"unknown unskippable chunk type 0x{chunk_type:02x}")
    return bytes(out)
