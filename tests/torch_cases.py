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
