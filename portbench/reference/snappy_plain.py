"""A plain Snappy block codec in Python, written from the format's
description and independent of the program under test.

* :func:`compress` is the greedy encoder of google/snappy's
  ``CompressFragment``: a hash table of 4-byte keys (at most 2**14 entries,
  sized to the fragment), the skip heuristic that probes every
  ``skip >> 5`` bytes after a run of misses, matches extended byte by byte,
  and the input cut into independent 64 KiB fragments.
* :func:`decompress` walks the tags one at a time and rejects every
  malformed stream.

Both are slow (a Python loop per tag or probe): they serve the traffic's
calibration and the tests of the tensor reference
(:mod:`portbench.reference.snappy_torch`), not the checks of a run.
"""

from __future__ import annotations

BLOCK_SIZE = 1 << 16
INPUT_MARGIN = 15
HASH_MUL = 0x1E35A7BD
MAX_TABLE_BITS = 14


class CorruptStream(ValueError):
    """The stream is not a valid Snappy block."""


def varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def read_varint(data: bytes) -> tuple[int, int]:
    """(value, bytes read) of the length preamble; at most 5 bytes, 32 bits."""
    value = 0
    for i in range(min(5, len(data))):
        b = data[i]
        value |= (b & 0x7F) << (7 * i)
        if b < 0x80:
            if value >= 1 << 32:
                break
            return value, i + 1
    raise CorruptStream("bad length preamble")


def max_compressed_length(n: int) -> int:
    """google/snappy's ``MaxCompressedLength``: the most a valid encoder
    may emit for ``n`` bytes, preamble included."""
    return 32 + n + n // 6


def _literal(out: bytearray, data: bytes) -> None:
    n = len(data) - 1
    if n < 60:
        out.append(n << 2)
    else:
        extra = (n.bit_length() + 7) // 8
        out.append((59 + extra) << 2)
        out += n.to_bytes(extra, "little")
    out += data


def _copy(out: bytearray, offset: int, length: int) -> None:
    while length >= 68:
        out += bytes([(63 << 2) | 2, offset & 0xFF, offset >> 8])
        length -= 64
    if length > 64:
        out += bytes([(59 << 2) | 2, offset & 0xFF, offset >> 8])
        length -= 60
    if length < 12 and offset < 2048:
        out += bytes([((offset >> 8) << 5) | ((length - 4) << 2) | 1, offset & 0xFF])
    else:
        out += bytes([((length - 1) << 2) | 2, offset & 0xFF, offset >> 8])


def _fragment(src: bytes, out: bytearray) -> None:
    n = len(src)
    if n < INPUT_MARGIN:
        if n:
            _literal(out, src)
        return
    bits = 8
    while (1 << bits) < n and bits < MAX_TABLE_BITS:
        bits += 1
    shift = 32 - bits
    table = [0] * (1 << bits)

    def load(i: int) -> int:
        return int.from_bytes(src[i : i + 4], "little")

    def hsh(i: int) -> int:
        return ((load(i) * HASH_MUL) & 0xFFFFFFFF) >> shift

    ip_limit = n - INPUT_MARGIN
    next_emit = 0
    ip = 1
    next_hash = hsh(ip)
    while True:
        skip = 32
        next_ip = ip
        while True:  # look for a 4-byte match
            ip = next_ip
            h = next_hash
            next_ip = ip + (skip >> 5)
            skip += 1
            if next_ip > ip_limit:
                if next_emit < n:
                    _literal(out, src[next_emit:])
                return
            next_hash = hsh(next_ip)
            cand = table[h]
            table[h] = ip
            if src[ip : ip + 4] == src[cand : cand + 4]:
                break
        _literal(out, src[next_emit:ip])
        while True:  # emit copies while the next position matches at once
            base = ip
            m = 4
            while ip + m < n and src[cand + m] == src[ip + m]:
                m += 1
            ip += m
            _copy(out, base - cand, m)
            next_emit = ip
            if ip >= ip_limit:
                if next_emit < n:
                    _literal(out, src[next_emit:])
                return
            table[hsh(ip - 1)] = ip - 1
            h = hsh(ip)
            cand = table[h]
            table[h] = ip
            if src[ip : ip + 4] != src[cand : cand + 4]:
                break
        ip += 1
        next_hash = hsh(ip)


def compress_body(data: bytes) -> bytes:
    """The tag stream (no preamble) of ``data``, fragment by fragment."""
    out = bytearray()
    for i in range(0, len(data), BLOCK_SIZE):
        _fragment(bytes(data[i : i + BLOCK_SIZE]), out)
    return bytes(out)


def compress(data: bytes) -> bytes:
    """A whole Snappy block: the varint length, then the tag stream."""
    return varint(len(data)) + compress_body(data)


def decompress_body(body: bytes, expected: int) -> bytes:
    """Decode a tag stream that must give exactly ``expected`` bytes."""
    out = bytearray()
    ip, n = 0, len(body)
    while ip < n:
        tag = body[ip]
        kind = tag & 3
        if kind == 0:
            length = (tag >> 2) + 1
            ip += 1
            if length > 60:
                extra = length - 60
                if ip + extra > n:
                    raise CorruptStream("literal length runs past the stream")
                length = int.from_bytes(body[ip : ip + extra], "little") + 1
                ip += extra
            if ip + length > n:
                raise CorruptStream("literal runs past the stream")
            out += body[ip : ip + length]
            ip += length
        else:
            width = (0, 2, 3, 5)[kind]
            if ip + width > n:
                raise CorruptStream("copy tag runs past the stream")
            if kind == 1:
                length = ((tag >> 2) & 7) + 4
                offset = ((tag >> 5) << 8) | body[ip + 1]
            else:
                length = (tag >> 2) + 1
                offset = int.from_bytes(body[ip + 1 : ip + width], "little")
            ip += width
            if offset == 0 or offset > len(out):
                raise CorruptStream("copy offset out of range")
            for _ in range(length):  # byte by byte: the source may overlap
                out.append(out[-offset])
        if len(out) > expected:
            raise CorruptStream("output longer than the preamble says")
    if len(out) != expected:
        raise CorruptStream("output shorter than the preamble says")
    return bytes(out)


def decompress(block: bytes) -> bytes:
    expected, used = read_varint(block)
    return decompress_body(block[used:], expected)
