"""Scalar oracle codec: a straightforward, obviously-correct Snappy
block encoder/decoder in Python + NumPy.

Role in the framework: **test oracle only**. The production paths are
the CUDA kernels in :mod:`snappier_tpu_torch.ops.cuda`; this module exists
so those kernels have a slow, readable ground truth that is itself
validated against the golden ``.snappy`` corpus files shipped with the
reference (``Snappier.Tests/TestData/alice29.snappy``,
``html_x_4.snappy``).

Encoder parity notes (``Snappier/Internal/SnappyCompressor.cs``):
the reference's greedy match finder uses a lossy 14-bit hash table
(``HashTable.cs:91-126``) and a skip heuristic
(``SnappyCompressor.cs:315-341``). Compressed *bytes* are therefore an
encoder choice, not format law — the contract is only that output
decodes to the input and that our size is <= the reference's. This
oracle uses an exact last-occurrence map (a superset of any lossy hash
table), so its ratio is >= the reference's by construction. Fragmenting
at 64 KiB, the 64-byte copy cap, the 64<len<68 split rule, and the
copy1/copy2 selection rules match the reference exactly
(``SnappyCompressor.cs:466-543``).
"""

from __future__ import annotations

import numpy as np

from snappier_tpu_torch.constants import (
    BLOCK_SIZE,
    MAX_COPY1_LENGTH,
    MAX_COPY1_OFFSET,
    MAX_COPY_LENGTH,
    MAX_SHORT_LITERAL,
    MIN_MATCH_LENGTH,
    TAG_COPY1,
    TAG_COPY2,
    TAG_COPY4,
    TAG_LITERAL,
    max_compressed_length,
    plausible_uncompressed_bound,
)
from snappier_tpu_torch.errors import InvalidDataError
from snappier_tpu_torch.format.varint import read_varint, write_varint

# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _emit_literal(out: bytearray, data: memoryview) -> None:
    """Append a literal tag + payload. Parity: SnappyCompressor.cs:417-464."""
    n = len(data)
    if n == 0:
        return
    if n <= MAX_SHORT_LITERAL:
        out.append(((n - 1) << 2) | TAG_LITERAL)
    else:
        rem = n - 1
        length_bytes = bytearray()
        while rem > 0 or not length_bytes:
            length_bytes.append(rem & 0xFF)
            rem >>= 8
        out.append(((59 + len(length_bytes)) << 2) | TAG_LITERAL)
        out.extend(length_bytes)
    out.extend(data)


def _emit_copy_at_most_64(out: bytearray, offset: int, length: int) -> None:
    """One copy tag, length 4..64. Parity: SnappyCompressor.cs:466-505."""
    assert 4 <= length <= MAX_COPY_LENGTH and 0 < offset < (1 << 16)
    if length <= MAX_COPY1_LENGTH and offset < MAX_COPY1_OFFSET:
        out.append(TAG_COPY1 | ((length - 4) << 2) | ((offset >> 8) << 5))
        out.append(offset & 0xFF)
    else:
        out.append(TAG_COPY2 | ((length - 1) << 2))
        out.append(offset & 0xFF)
        out.append((offset >> 8) & 0xFF)


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    """A match of arbitrary length as one or more copy tags.
    Parity: SnappyCompressor.cs:507-543 — repeated 64s, with the
    64 < len < 68 tail split as 60 + remainder so the final piece is >= 4."""
    while length >= 68:
        _emit_copy_at_most_64(out, offset, 64)
        length -= 64
    if length > 64:
        _emit_copy_at_most_64(out, offset, 60)
        length -= 60
    _emit_copy_at_most_64(out, offset, length)


def _match_length(data: np.ndarray, a: int, b: int, limit: int) -> int:
    """Length of the common prefix of data[a:] and data[b:], capped so
    b+len <= limit. Vectorized equivalent of FindMatchLength
    (SnappyCompressor.cs:562-688)."""
    max_len = limit - b
    if max_len <= 0:
        return 0
    # Compare in growing windows to avoid scanning far past the match end.
    n = 0
    window = 32
    while n < max_len:
        w = min(window, max_len - n)
        neq = data[a + n : a + n + w] != data[b + n : b + n + w]
        hit = np.argmax(neq) if neq.any() else w
        n += int(hit)
        if hit < w:
            return n
        window *= 4
    return max_len


def _compress_fragment(data: np.ndarray, out: bytearray) -> None:
    """Greedy LZ77 over one fragment (<= 64 KiB) with an exact
    last-occurrence match table. Mirrors the shape of
    SnappyCompressor.CompressFragment (SnappyCompressor.cs:174-415)
    without its lossy hash table or skip heuristic."""
    n = len(data)
    if n < MIN_MATCH_LENGTH + 1:
        _emit_literal(out, memoryview(data.tobytes()))
        return

    view = data.tobytes()
    # 4-byte little-endian key at every position.
    u32 = np.zeros(n, dtype=np.uint32)
    keys_n = n - 3
    k = data[:keys_n].astype(np.uint32)
    k |= data[1 : keys_n + 1].astype(np.uint32) << np.uint32(8)
    k |= data[2 : keys_n + 2].astype(np.uint32) << np.uint32(16)
    k |= data[3 : keys_n + 3].astype(np.uint32) << np.uint32(24)
    u32[:keys_n] = k

    last: dict[int, int] = {}
    lit_start = 0
    pos = 0
    misses = 0
    while pos + MIN_MATCH_LENGTH <= n:
        key = int(u32[pos])
        cand = last.get(key)
        last[key] = pos
        if cand is None:
            # Skip heuristic in the spirit of SnappyCompressor.cs:315-341:
            # accelerate through incompressible regions.
            misses += 1
            pos += 1 + (misses >> 6)
            continue
        misses = 0
        length = MIN_MATCH_LENGTH + _match_length(
            data, cand + MIN_MATCH_LENGTH, pos + MIN_MATCH_LENGTH, n
        )
        _emit_literal(out, memoryview(view[lit_start:pos]))
        _emit_copy(out, pos - cand, length)
        # Seed the table across the covered span (bounded work per match).
        end = pos + length
        for p in range(pos + 1, min(end, n - MIN_MATCH_LENGTH + 1)):
            last[int(u32[p])] = p
        pos = end
        lit_start = end
    _emit_literal(out, memoryview(view[lit_start:]))


def compress(data) -> bytes:
    """Snappy block-format compress. Layout parity:
    SnappyCompressor.cs:34-80 — varint(uncompressed length) followed by
    independently compressed 64 KiB fragments."""
    arr = (
        data.astype(np.uint8, copy=False)
        if isinstance(data, np.ndarray)
        else np.frombuffer(bytes(data), dtype=np.uint8)
    )
    out = bytearray(write_varint(len(arr)))
    for start in range(0, len(arr), BLOCK_SIZE):
        _compress_fragment(arr[start : start + BLOCK_SIZE], out)
    if len(arr) == 0:
        pass  # preamble alone is the canonical empty encoding
    return bytes(out)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def get_uncompressed_length(data) -> int:
    """Read the varint preamble. Parity: Snappy.cs:142-151."""
    value, _ = read_varint(bytes(data))
    return value


def decompress(data) -> bytes:
    """Snappy block-format decompress with full validation; raises
    :class:`InvalidDataError` on any malformed input. Parity:
    SnappyDecompressor.DecompressAllTags (SnappyDecompressor.cs:184-347)
    and its bounds checks (:570-606)."""
    buf = bytes(data)
    expected, pos = read_varint(buf)
    n = len(buf)
    # Reject oversized length claims before allocating
    # (SnappyTests.cs:244-331); bound shared with runtime/block.py.
    if expected > plausible_uncompressed_bound(n):
        raise InvalidDataError("length preamble exceeds possible expansion")
    out = bytearray(expected)
    opos = 0
    while pos < n:
        tag = buf[pos]
        tag_type = tag & 3
        if tag_type == TAG_LITERAL:
            len6 = tag >> 2
            if len6 < MAX_SHORT_LITERAL:
                length = len6 + 1
                pos += 1
            else:
                extra = len6 - 59
                if pos + 1 + extra > n:
                    raise InvalidDataError("truncated literal length")
                length = (
                    int.from_bytes(buf[pos + 1 : pos + 1 + extra], "little") + 1
                )
                pos += 1 + extra
            if pos + length > n:
                raise InvalidDataError("literal overruns input")
            if opos + length > expected:
                raise InvalidDataError("literal overruns output")
            out[opos : opos + length] = buf[pos : pos + length]
            pos += length
            opos += length
            continue
        if tag_type == TAG_COPY1:
            if pos + 2 > n:
                raise InvalidDataError("truncated copy-1 tag")
            length = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | buf[pos + 1]
            pos += 2
        elif tag_type == TAG_COPY2:
            if pos + 3 > n:
                raise InvalidDataError("truncated copy-2 tag")
            length = (tag >> 2) + 1
            offset = int.from_bytes(buf[pos + 1 : pos + 3], "little")
            pos += 3
        else:  # TAG_COPY4 — never emitted by encoders, must decode.
            if pos + 5 > n:
                raise InvalidDataError("truncated copy-4 tag")
            length = (tag >> 2) + 1
            offset = int.from_bytes(buf[pos + 1 : pos + 5], "little")
            pos += 5
        if offset == 0 or offset > opos:
            raise InvalidDataError("copy offset out of range")
        if opos + length > expected:
            raise InvalidDataError("copy overruns output")
        # Overlapping copies replicate the pattern byte-by-byte
        # (IncrementalCopy semantics, CopyHelpers.cs:64-219).
        src = opos - offset
        if offset >= length:
            out[opos : opos + length] = out[src : src + length]
        else:
            for i in range(length):
                out[opos + i] = out[src + i]
        opos += length
    if opos != expected:
        raise InvalidDataError(
            f"decoded {opos} bytes, preamble promised {expected}"
        )
    return bytes(out)


def compress_bound(n: int) -> int:
    """Public MaxCompressedLength. Parity: Snappy.cs:20-24."""
    return max_compressed_length(n)
