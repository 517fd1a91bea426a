"""Inputs shared by the port's parity tests (``tests/test_torch_*.py``).

All are made with numpy from fixed seeds, so the JAX reference and the
port see the same bytes. This module imports nothing of JAX (it uses the
port's own oracle, which ``tests/test_torch_codec.py`` holds equal to the
reference's), so the CUDA tests can use it on a machine without JAX.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import importlib.util
import pathlib
import subprocess
import sys
import types

import numpy as np

from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.format.varint import write_varint

WORKER = pathlib.Path(__file__).resolve().parents[1] / "tools" / "torch_dist_worker.py"
REHEARSAL = WORKER.with_name("torch_rehearsal_multihost.py")

# The forms of the pipelined decode walks: name -> decode_pipe2's arguments
# ("pipe" is decode_pipe, which takes none).
PIPE_CASES = [
    ("pipe", {}),
    ("pipe2u1", dict(unroll=1)),
    ("pipe2u2", dict(unroll=2)),
    ("pipe2u3", dict(unroll=3)),
    ("pipe2u4", dict(unroll=4)),
    ("pipe2unc", dict(unroll=2, unc=1)),
    ("pipe2unc2", dict(unroll=2, unc=2)),
    ("pipe2u3unc", dict(unroll=3, unc=1)),
    ("pipe2dma", dict(unroll=2, unc=1, dma_pipe=True)),
    ("pipe2u1dma", dict(unroll=1, dma_pipe=True)),
    ("denoemit", dict(unroll=2, emit=False)),
]


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


# Row lengths at the CRC32C kernel's edges (csrc/crc32c.cuh): around a
# 16-byte chunk, a 512-byte line of 32 chunks and a 4,096-byte batch of 8
# lines, and near a 64 KiB row's end.
CRC_LENGTHS = (0, 1, 15, 16, 17, 30, 31, 511, 512, 513, 4095, 4096, 4097, 57344, 65533, 65535,
               65536)


def crc_rows(F: int, lengths=CRC_LENGTHS, seed: int = 13):
    """Rows of width F with the given lengths (clamped to F): random bytes,
    a markup row and an all-zero row, with random garbage past each
    length. Returns (rows uint8[B, F], lengths int32[B])."""
    rng = np.random.default_rng(seed)
    lens = np.array([min(n, F) for n in lengths] + [F, F], np.int32)
    rows = rng.integers(0, 256, (len(lens), F), dtype=np.uint8)
    rows[-2] = html_like(F, seed)
    rows[-1] = 0
    return rows, lens


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


def _literal(data: bytes, nlen: int = 0) -> bytes:
    """A literal tag with ``nlen`` (0-4) length bytes, then its payload."""
    if nlen == 0:
        return bytes([(len(data) - 1) << 2]) + data
    return bytes([(59 + nlen) << 2]) + (len(data) - 1).to_bytes(nlen, "little") + data


def _copy(off: int, n: int, kind: int) -> bytes:
    """A copy tag of ``kind`` 1 (n 4-11, off < 2048), 2 or 4 (n 1-64)."""
    if kind == 1:
        return bytes([1 | (n - 4) << 2 | (off >> 8) << 5, off & 0xFF])
    return bytes([(2 if kind == 2 else 3) | (n - 1) << 2]) + off.to_bytes(kind, "little")


def batch_streams(programs: int = 24, seed: int = 31) -> list[bytes]:
    """Valid blocks for the batched decode walk, whose warp step resolves
    the tags that start in a window of 32 compressed bytes and writes their
    output 32 bytes a round: for each offset 1-40, an overlapping copy of 64
    bytes and one of 37 behind a literal of 1-7 bytes (so they straddle a
    round at every phase); copies whose source is the output of an earlier
    copy of the same batch; literals with 1-4 length bytes; and ``programs``
    random tag programs of 300 tags (literals of 1-70 bytes with 0-4 length
    bytes, copy-1, copy-2 and copy-4 tags of 1-64 bytes at offsets of 1-40
    or anywhere behind)."""
    rng = np.random.default_rng(seed)
    streams = []
    for off in range(1, 41):
        head = rng.integers(0, 256, off % 7 + 1 + off, dtype=np.uint8).tobytes()
        body = _literal(head) + _copy(off, 64, 2) + _copy(off, 37, 4) + _literal(b"xyz")
        streams.append(write_varint(len(head) + 104) + body)
    own = _literal(b"abcd") + _copy(4, 4, 1) + _copy(8, 8, 1) + _copy(3, 64, 2) + _copy(1, 11, 1)
    streams.append(write_varint(4 + 4 + 8 + 64 + 11) + own)
    for nlen in (1, 2, 3, 4):
        for n in (1, 33, 61, 256) + ((300,) if nlen > 1 else ()):
            streams.append(write_varint(n + 2) + _literal(bytes(range(65, 67)))
                           + _literal(rng.integers(0, 256, n, dtype=np.uint8).tobytes(), nlen))
    for _ in range(programs):
        out = bytearray(rng.integers(0, 256, 3, dtype=np.uint8).tobytes())
        body = bytearray(_literal(bytes(out)))
        for _ in range(300):
            if rng.random() < 0.3:
                n = int(rng.integers(1, 71)) if rng.random() < 0.3 else int(rng.integers(1, 9))
                data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                nlen = int(rng.integers(0, 5)) if n <= 60 else int(rng.integers(1, 5))
                body += _literal(data, nlen)
                out += data
                continue
            off = int(rng.integers(1, min(len(out), 40) + 1)) if rng.random() < 0.7 else int(
                rng.integers(1, len(out) + 1))
            kind = int(rng.choice([1, 2, 4])) if off < 2048 else int(rng.choice([2, 4]))
            n = int(rng.integers(4, 12)) if kind == 1 else int(rng.integers(1, 65))
            body += _copy(off, n, kind)
            for _ in range(n):  # byte by byte: the source may overlap the copy
                out.append(out[-off])
        streams.append(write_varint(len(out)) + bytes(body))
    return streams


#: A literal whose 4-byte length field is 0xFFFFFFFF: its length wraps to 0.
#: decode_pipe2 takes it as a literal of no bytes; K1 and decode_pipe refuse
#: it (error 7).
EMPTY_LITERAL = bytes([0xFC, 0xFF, 0xFF, 0xFF, 0xFF])


def empty_literal_streams(programs: int = 4, tags: int = 200, seed: int = 37) -> list[bytes]:
    """Blocks that hold :data:`EMPTY_LITERAL`, valid for decode_pipe2 (each
    claims the output of its other tags): first in a batch (the block's first
    tag; after a literal longer than the batched walk's 32-byte window),
    mid-batch, last in a block, a block of nothing else, whole batches of
    them (7 and 20 in a row), just before a long literal, and ``programs``
    random tag programs of ``tags`` tags, one in eight an empty literal
    (about 11 compressed and 11 output bytes a tag)."""
    E = EMPTY_LITERAL
    lit4, lit40 = _literal(b"abcd"), _literal(bytes(range(65, 105)))
    long = _literal(bytes(range(100, 200)), 1)
    cases = [
        (E + lit4, 4),
        (lit40 + E + lit4 + _copy(4, 8, 1), 52),
        (lit4 + _copy(4, 4, 1) + E + lit4 + _copy(4, 8, 1), 20),
        (lit4 + _copy(4, 8, 1) + E, 12),
        (E * 3, 0),
        (lit40 + E * 7 + lit4, 44),
        (lit4 + E * 20 + _copy(4, 9, 1) + E * 20, 13),
        (lit4 + E + long + _copy(100, 30, 2), 134),
    ]
    streams = [write_varint(n) + body for body, n in cases]
    rng = np.random.default_rng(seed)
    for _ in range(programs):
        out = bytearray(rng.integers(0, 256, 3, dtype=np.uint8).tobytes())
        body = bytearray(_literal(bytes(out)))
        for _ in range(tags):
            r = rng.random()
            if r < 0.125:
                body += E
            elif r < 0.4:
                data = rng.integers(0, 256, int(rng.integers(1, 50)), dtype=np.uint8).tobytes()
                body += _literal(data, int(rng.integers(0, 5)))
                out += data
            else:
                off = int(rng.integers(1, min(len(out), 40) + 1))
                n = int(rng.integers(4, 12))
                body += _copy(off, n, 1)
                for _ in range(n):
                    out.append(out[-off])
        streams.append(write_varint(len(out)) + bytes(body))
    return streams


def probe_blocks() -> dict[str, bytes]:
    """Compressed blocks for the hybrid micro-probes: 12,000 bytes of markup
    and the first 65,536 bytes of bench.py's word mix (``chip_smoke.py``'s
    main path), each through the port's oracle."""
    import chip_smoke

    mix = np.frombuffer(chip_smoke.word_mix()[:65536], np.uint8)
    return {"markup": oracle.compress(html_like(12000, 4)), "word_mix": oracle.compress(mix)}


def vcopy_edges(mode: str) -> np.ndarray:
    """A record array for ``vcopy`` at every case of the two bodies: source
    rows that end a 3d tile (srow 7; in 3d the image's last row, whose next
    tile the 3d body clamps to 15), destinations at row 7 of a tile that
    spill into the next row, more than 128 words (``nw`` above 128 wraps the
    copy), every byte phase, a negative length, destinations at lane 127
    (one word in row dr, the rest in dr + 1; with ``nw`` above 128 too),
    sources that overlap their destination from either side, a source
    window that crosses rows at srow 7 into a destination at drow 7, lane
    127; every row inside the image for the mode."""
    rng = np.random.default_rng(12)
    last = 15 if mode == "3d" else 14
    srcs = [7 * 512 + 4 * 100 + 1, last * 4096 + 7 * 512 + 13, 3 * 512 + 2, 64000, 0,
            4 * (20 * 128 + 50) + 3, 4 * (60 * 128 + 3) + 1, 4 * (40 * 128 + 100) + 2,
            4 * (70 * 128 + 93) + 3, 4 * (15 * 128 + 100) + 3]
    dsts = [7 * 512 + 4 * 120 + 3, 31 * 512 + 4 * 127, 5, 63000, 2 * 4096 + 7 * 512 + 4 * 64,
            4 * (10 * 128 + 127) + 1, 4 * (50 * 128 + 127), 4 * (40 * 128 + 102) + 2,
            4 * (70 * 128 + 90), 4 * (23 * 128 + 127) + 2]
    lens = [64, 40, 1000, -7, 64, 300, 1000, 200, 64, 90]
    n, half = 200, 8192
    rec = np.zeros(4 * half, np.int32)
    rec[:n] = np.concatenate([dsts, rng.integers(0, 63 * 1024, n - len(dsts))])
    rec[half : half + n] = np.concatenate([srcs, rng.integers(0, 63 * 1024, n - len(srcs))])
    rec[2 * half : 2 * half + n] = np.concatenate([lens, rng.integers(1, 600, n - len(lens))])
    rec[3 * half] = n
    return rec


#: Loop counts of a record array at the edges of the record loops' batches
#: of 32: none, one record (iso's odd passes then have none), a batch less
#: one, a batch, a batch and one, two batches less one.
BATCH_EDGE_COUNTS = (0, 1, 2, 31, 32, 33, 63)


def count_records(rec: np.ndarray, count: int) -> np.ndarray:
    """``rec`` with the loop count set to ``count``."""
    rec = rec.copy()
    rec[3 * 8192] = count
    return rec


#: ``ArrayWarp<N>``: the host twin of ``sc::CudaWarp`` (csrc/scalar_codec.cuh)
#: that the g++ builds of tests/test_torch_kernel_host*.py run the warp walks
#: on.
ARRAY_WARP = r"""
// A warp for the batched decode walk whose N lanes are arrays, run in lock
// step: each() runs a lane body on every lane (highest lane first, so a
// body that read another lane's result of the same step would differ from
// the card), gather/read/ballot/or_all are __shfl_sync, __ballot_sync and
// __reduce_or_sync over the arrays, sync() has nothing to order, and
// batch() counts the walk's batches and their tags.
template <int N>
struct ArrayWarp {
  static constexpr int kLanes = N;
  template <class T>
  struct Lanes {
    T v[N];
    T& operator[](int l) { return v[l]; }
    const T& operator[](int l) const { return v[l]; }
  };
  template <class F>
  void each(F f) const {
    for (int l = N - 1; l >= 0; l--) f(l);
  }
  template <class T>
  Lanes<T> gather(const Lanes<T>& x, const Lanes<int32_t>& src) const {
    Lanes<T> r;
    for (int l = 0; l < N; l++) r.v[l] = x.v[((src.v[l] % N) + N) % N];
    return r;
  }
  Lanes<bool> gather_bool(const Lanes<bool>& x, const Lanes<int32_t>& src) const {
    return gather(x, src);
  }
  template <class T>
  T read(const Lanes<T>& x, int lane) const { return x.v[lane]; }
  uint32_t ballot(const Lanes<bool>& p) const {
    uint32_t m = 0;
    for (int l = 0; l < N; l++) m |= p.v[l] ? 1u << l : 0u;
    return m;
  }
  uint32_t or_all(const Lanes<uint32_t>& x) const {
    uint32_t m = 0;
    for (int l = 0; l < N; l++) m |= x.v[l];
    return m;
  }
  void sync() const {}
  void batch(int tags) const {
    batches++;
    tags_seen += tags;
  }
  mutable int64_t batches = 0, tags_seen = 0;
};
"""


def gxx_library(shim: str, directory: pathlib.Path):
    """``shim`` built by g++ over ``snappier_tpu_torch/csrc`` into a shared
    library in ``directory``, loaded by ctypes."""
    import ctypes
    import shutil

    csrc = pathlib.Path(__file__).resolve().parents[1] / "snappier_tpu_torch" / "csrc"
    (directory / "shim.cpp").write_text(shim)
    lib = directory / "libwalk.so"
    subprocess.run(
        [shutil.which("g++"), "-std=c++17", "-O2", "-shared", "-fPIC", "-pthread", "-I",
         str(csrc), "-o", str(lib), str(directory / "shim.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    return ctypes.CDLL(str(lib))


def step_back_streams() -> list[bytes]:
    """Blocks with a 4-byte literal length of 0xFFFFFFFE: a literal of -1
    bytes that advances 4, whose next tag is a copy-4 tag at its top length
    byte (64 bytes at the offset in the 4 bytes after it). ``decode_v5``
    steps its output back by one byte there; ``v6`` and ``v7`` take the
    literal as empty (and so overrun the claim). In the first two the step
    comes after four tags of the same 32-byte window, so a batch of the
    batched walk holds them all (the second steps back twice); in the third
    a literal of 40 bytes ends the batch before it, so the step is a batch
    of its own."""

    def back(off: int) -> bytes:
        return bytes([0xFC, 0xFE, 0xFF, 0xFF, 0xFF]) + off.to_bytes(4, "little")

    head = _literal(b"ab") + _copy(2, 4, 1) + _literal(b"cde") + _copy(3, 5, 1)  # 14 bytes
    long = bytes(range(40, 80))
    return [write_varint(14 - 1 + 64 + 3) + head + back(8) + _literal(b"xyz"),
            write_varint(2 * (14 - 1 + 64)) + head + back(8) + head + back(5),
            write_varint(40 - 1 + 64) + _literal(long) + back(8)]


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


@functools.cache
def rehearsal_tool():
    """``tools/torch_rehearsal_multihost.py`` as a module: the worker
    fan-out, the reading of the workers' files and their union."""
    spec = importlib.util.spec_from_file_location("torch_rehearsal_multihost", REHEARSAL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker_module():
    """``tools/torch_dist_worker.py`` as a module (for its ``corpus`` and
    ``stream_case``)."""
    return rehearsal_tool().worker_module()


def run_workers(outdir, nprocs: int, shards: int, n_blocks: int, device: str = "cpu",
                backend: str = "gloo", timeout: float = 240):
    """Start ``nprocs`` processes of ``tools/torch_dist_worker.py`` joined over
    loopback (the rehearsal tool's fan-out: a timeout each, the rest killed
    when one fails, its log on stderr) and fail on a timeout or a non-zero
    exit. Returns (metas, payloads, plains)."""
    tool = rehearsal_tool()
    assert tool.run_workers(n_blocks, nprocs, shards, device, outdir, timeout, backend), (
        "a worker failed or did not finish in time (its log is on stderr)")
    return tool.read_outputs(outdir, nprocs)


def check_union(metas, parts, keys) -> np.ndarray:
    """Identical maps, local sets that partition the batch, and the union of
    the partial buffers (the rehearsal tool's ``join_parts``). ``keys`` names
    the lengths, offsets and local set."""
    return rehearsal_tool().join_parts(metas, parts, keys)


@contextlib.contextmanager
def interpreted_tool(name: str):
    """``tools/<name>.py`` (a TPU probe) with its kernels in Pallas interpret
    mode, for the span of the context.

    The probes pass ``interpret=False`` literally, so the module's ``pl`` is
    swapped for a copy whose ``pallas_call`` forces ``interpret=True``;
    nothing under ``tools/`` changes. Importing a probe points JAX's
    compilation cache at a directory of its own; that setting is put back.
    JAX is imported here, not with this module."""
    import jax

    tools = str(pathlib.Path(__file__).resolve().parents[1] / "tools")
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    sys.path.insert(0, tools)
    try:
        mod = importlib.import_module(name)
    finally:
        sys.path.remove(tools)
        for k, v in saved.items():
            jax.config.update(k, v)
    real_pl = mod.pl

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return real_pl.pallas_call(*args, **kwargs)

    fake = types.SimpleNamespace(**{k: getattr(real_pl, k) for k in dir(real_pl)
                                    if not k.startswith("__")})
    fake.pallas_call = interpreted
    mod.pl = fake
    try:
        yield mod
    finally:
        mod.pl = real_pl
