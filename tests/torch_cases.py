"""Inputs shared by the port's parity tests (``tests/test_torch_*.py``).

All are made with numpy from fixed seeds, so the JAX reference and the
port see the same bytes. This module imports nothing of JAX (it uses the
port's own oracle, which ``tests/test_torch_codec.py`` holds equal to the
reference's), so the CUDA tests can use it on a machine without JAX.
"""

from __future__ import annotations

import numpy as np

from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.format.varint import write_varint


def html_like(n: int, seed: int = 0) -> np.ndarray:
    """Markup-like text of n bytes (a word mix in the spirit of the html
    fallback corpus)."""
    rng = np.random.default_rng(seed)
    words = [b"<html>", b"<body>", b"<div class=", b"the", b"snappy", b"corpus",
             b"fallback", b"</div>", b"href=\"/a/b\"", b"\n"]
    s = b" ".join(words[i] for i in rng.integers(0, len(words), n // 2 + 8))
    return np.frombuffer(s[:n], np.uint8)


def encode_rows(F: int, seed: int = 1):
    """Fragments of width F for the encoder: markup, random, all-zero,
    period-1..7 patterns, and short rows, each with random garbage past
    its length. Returns (frags int32[B, F], lengths int32[B])."""
    rng = np.random.default_rng(seed)
    lens = [F, F - 5, F, F] + [F - 3 * p for p in range(1, 8)] + [1, 15, 16, 17, 40]
    frags = rng.integers(0, 256, (len(lens), F)).astype(np.int32)
    frags[0] = html_like(F, seed)
    frags[1, : F - 5] = html_like(F - 5, seed + 1)
    # frags[2] stays random (incompressible)
    frags[3] = 0
    for p in range(1, 8):
        row = 4 + p - 1
        frags[row, : lens[row]] = np.tile(rng.integers(0, 256, p), F)[: lens[row]]
    for row in range(11, len(lens)):
        frags[row, : lens[row]] = html_like(lens[row], seed + row)
    return frags, np.array(lens, np.int32)


def best_rows(F: int = 4096, seed: int = 3, lens=(4096, 3000, 17, 1, 0)):
    """Rows for the candidate search and the best-mode walk: markup,
    period-1..7 patterns, random bytes and zeros, each at every length in
    ``lens``, with random garbage past each length. Returns
    (frags int32[B, F], lengths int32[B])."""
    rng = np.random.default_rng(seed)
    kinds = [html_like(F, seed)] + [np.tile(rng.integers(0, 256, p), F)[:F] for p in range(1, 8)]
    kinds += [rng.integers(0, 256, F), np.zeros(F, np.int64)]
    rows, lengths = [], []
    for kind in kinds:
        for n in lens:
            row = rng.integers(0, 256, F)
            row[:n] = kind[:n]
            rows.append(row)
            lengths.append(n)
    return np.stack(rows).astype(np.int32), np.array(lengths, np.int32)


def planted_matches(B: int, cc: int, seed: int = 11):
    """Probe rows of random bytes, each with a match planted: the bytes at
    ``cand`` are copied to ``at`` for a random length, then one differing
    byte. Returns (bufs uint8[B, cc], ats, cands, ns int32[B], lengths of
    the planted matches)."""
    rng = np.random.default_rng(seed)
    bufs = rng.integers(0, 256, (B, cc), dtype=np.uint8)
    ats, cands, ns, planted = (np.zeros(B, np.int32) for _ in range(4))
    for b in range(B):
        m = int(rng.integers(4, min(4096, cc // 4)))
        cand = int(rng.integers(0, cc // 4))
        at = int(rng.integers(cand + 1, cc - m))
        for i in range(m):  # byte by byte: the source may overlap the copy
            bufs[b, at + i] = bufs[b, cand + i]
        if at + m < cc:
            bufs[b, at + m] = bufs[b, cand + m] ^ 0x5A
        n = int(rng.integers(at + 4, cc + 1))
        ats[b], cands[b], ns[b], planted[b] = at, cand, n, min(m, n - at)
    return bufs, ats, cands, ns, planted


def corrupt_streams() -> list[bytes]:
    """Malformed and edge-case blocks (tests/test_scalar_kernels.py:89-105
    and :187-276, plus one of each walk failure)."""
    wraps = [
        bytes([0xFE, 0xFF, 0xFF, 0x7F]),
        bytes([0xFF, 0xFF, 0xFF, 0x7F]),
        bytes([0xFF, 0xFF, 0xFF, 0xFF]),
        bytes([0x00, 0x00, 0x00, 0x80]),
        bytes([0x00, 0x00, 0x80, 0x00]),
    ]
    return [
        b"",  # empty row: the preamble reads past n
        b"\xff\xff\xff\xff\xff",  # 5-byte varint, 5th byte >= 8
        b"\x80\x80\x80\x80\x80\x01",  # 6-byte varint
        bytes([10, 3 << 2]) + b"ab",  # literal overruns the input
        bytes([4, 1, 1]),  # truncated copy-1 tag
        bytes([1]),  # claims 1 byte, no tags
        bytes([3, (4 - 1) << 2]) + b"abcd",  # 4 bytes for a claim of 3
        bytes([8, (4 - 1) << 2]) + b"abcd" + bytes([3 | (3 << 2), 4, 0, 0, 0]),  # copy-4
        bytes([8, (4 - 1) << 2]) + b"abcd" + bytes([1 | (0 << 2), 0]),  # offset 0
        bytes([8, (4 - 1) << 2]) + b"abcd" + bytes([1 | (0 << 2), 5]),  # offset > op
        bytes([9, (4 - 1) << 2]) + b"abcd" + bytes([1 | (0 << 2), 4]),  # length mismatch
        bytes([8, (4 - 1) << 2]) + b"abcd" + bytes([2 | (3 << 2), 4]),  # truncated copy-2
        bytes([5, 0xFC, 4, 0, 0, 0]) + b"abcde",  # 4-byte literal length, legal
        bytes([5, 0xFC, 4, 0, 0, 1]) + b"abcde",  # its 4th byte set
        bytes([64, 0xFC, 63, 0, 0, 0]) + b"y" * 64,
        oracle.compress(np.frombuffer(b"x" * 2000, np.uint8)),  # claim > out_cap 1024
        bytes([0xF0, 0x07]) + b"",  # claim 1008, empty body
    ] + [bytes([64, 0xFC]) + w + b"x" * 64 for w in wraps]


def walk_streams(big: int = 0) -> list[bytes]:
    """Valid blocks for the decode walks: empty and tiny inputs, copies with
    every offset below 8 and lengths on both sides of 14 and 16, offsets of
    8 to 17 that overlap their own output, literals of 1, 2 and 3 length
    bytes, a 4-byte-offset copy, markup and, with ``big``, one markup and
    one pattern block of that many bytes."""
    rng = np.random.default_rng(17)
    plains = [b"", b"a", b"ab" * 50, b"a" * 300, b"the quick brown snappy " * 20, bytes(500),
              html_like(1000, 3).tobytes(), rng.integers(0, 256, 700, dtype=np.uint8).tobytes()]
    plains += [bytes(range(1, 1 + p)) * (n // p + 1) for p in range(1, 18) for n in (13, 40, 200)]
    if big:
        plains += [html_like(big, 5).tobytes(), (bytes(range(7)) * big)[:big],
                   rng.integers(0, 256, big, dtype=np.uint8).tobytes()]
    streams = [oracle.compress(np.frombuffer(d, np.uint8)) for d in plains]
    lit4 = bytes([(4 - 1) << 2]) + b"abcd"
    streams.append(bytes([8]) + lit4 + bytes([3 | (3 << 2), 4, 0, 0, 0]))  # copy-4
    streams.append(bytes([5, 0xFC, 4, 0, 0, 0]) + b"abcde")  # 4-byte literal length
    for off in range(1, 12):  # hand-made overlapping copies of 64 bytes
        pat = bytes(range(65, 65 + off))
        streams.append(write_varint(off + 64) + bytes([(off - 1) << 2]) + pat
                       + bytes([2 | (63 << 2), off, 0]))
    return streams


def tag_sweep_sample(step: int = 23) -> list[bytes]:
    """Every ``step``-th stream of the exhaustive tag-byte sweep
    (tests/test_tag_sweep.py): all tag classes, extra-field patterns and
    length claims, OUT_CAP 2048."""
    from tests.test_tag_sweep import _streams

    return _streams()[::step]


def pack_streams(streams, cc: int, garbage_seed: int | None = 5):
    """Streams as rows of width cc; bytes past each length are random
    garbage unless ``garbage_seed`` is None (zeros)."""
    B = len(streams)
    if garbage_seed is None:
        comp = np.zeros((B, cc), np.int32)
    else:
        comp = np.random.default_rng(garbage_seed).integers(0, 256, (B, cc)).astype(np.int32)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(streams):
        comp[i, : len(s)] = np.frombuffer(bytes(s), np.uint8)
        lens[i] = len(s)
    return comp, lens


def block_stream(n: int, body: np.ndarray) -> bytes:
    """A whole block: varint(n) + body."""
    return write_varint(int(n)) + np.asarray(body, np.uint8).tobytes()


def stream_inputs() -> dict[str, bytes]:
    """Buffers for the framing and stream tests: empty, tiny, text, random,
    exactly one chunk, and three chunks of which the first is a full
    incompressible one. ``size_equal`` compresses (greedy device encoder)
    to exactly its own 38 bytes, so it must take the uncompressed
    fallback; ``one_less`` to one byte less than its 41, so it must not."""
    rng = np.random.default_rng(31)
    base = bytes(range(1, 40))
    return {
        "empty": b"",
        "one_byte": b"a",
        "size_equal": base[:16] + base[:6] + bytes(range(100, 116)),
        "one_less": base[:16] + base[:7] + bytes(range(100, 118)),
        "short_text": html_like(1000, 2).tobytes(),
        "short_random": rng.integers(0, 256, 300, dtype=np.uint8).tobytes(),
        "full_chunk": html_like(65536, 3).tobytes(),
        "three_chunks": (rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()
                         + html_like(70000, 4).tobytes()),
    }
