"""CRC32C (Castagnoli) — scalar reference, GF(2) linearization tables,
and a data-parallel formulation shared with the CUDA kernel.

Parity: ``Snappier/Internal/Crc32CAlgorithm.cs`` (table CRC :22-36,
``Append`` :46-154, ``ApplyMask`` :157). The reference accelerates the
*sequential* byte loop with SSE4.2/ARM CRC instructions; a sequential
loop is the wrong shape for a wide device, so this module instead exposes the
CRC as what it mathematically is — an affine map over GF(2) message
bits:

    crc(M) = crc(0^n)  XOR  XOR_i C(b_i, n-1-i)

where ``C(b, k)`` is the (linear) contribution of byte value ``b``
placed ``k`` bytes from the end of the message. ``C(b, k)`` decomposes
over the bits of ``b`` into the 8 columns ``LBIT[k, j] = C(1<<j, k)``.
With those columns precomputed for every distance ``k < 65536``, the
CRC of a 64 KiB chunk is an elementwise AND/XOR over a ``(n, 8)``
table followed by an XOR reduction — embarrassingly parallel, VPU
shaped. Longer messages combine chunk CRCs with
:func:`crc32c_combine` (a 32x32 GF(2) matrix apply).

All tables here are plain NumPy; :mod:`snappier_tpu_torch.ops.cuda.crc32c`
ships the byte table and the zero-shift matrices to the device.
"""

from __future__ import annotations

import functools

import numpy as np

from snappier_tpu_torch.constants import BLOCK_SIZE, CRC_MASK_DELTA

#: Reflected Castagnoli polynomial (same bit order the reference's
#: table algorithm uses, Crc32CAlgorithm.cs:24).
POLY = 0x82F63B78
_INIT = 0xFFFFFFFF
_U32 = 0xFFFFFFFF


@functools.cache
def byte_table() -> np.ndarray:
    """The classic 256-entry byte-step table ``T`` with
    ``step(state, b) = (state >> 8) ^ T[(state ^ b) & 0xff]``."""
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ POLY if (c & 1) else c >> 1
        t[i] = c
    return t


def crc32c_bytewise(data, crc: int = 0) -> int:
    """Sequential table-driven CRC32C. Slow; used only as the
    ground-truth oracle for the parallel formulations and for tiny
    inputs. ``crc`` allows incremental appends (pass the previous
    return value)."""
    t = byte_table()
    state = (crc ^ _INIT) & _U32
    for b in bytes(data):
        state = (state >> 8) ^ int(t[(state ^ b) & 0xFF])
    return (state ^ _INIT) & _U32


# --- GF(2) linearization ----------------------------------------------------


@functools.cache
def lbit_table(max_distance: int = BLOCK_SIZE) -> np.ndarray:
    """``LBIT[k, j]`` = linear CRC contribution of byte ``1 << j``
    placed ``k`` bytes from the end of the message. Shape
    ``(max_distance, 8)`` uint32.

    Built by the raw (zero-init) recurrence: ``C(v, 0) = T[v]`` and
    ``C(v, k+1) = (C(v,k) >> 8) ^ T[C(v,k) & 0xff]``.
    """
    t = byte_table()
    out = np.empty((max_distance, 8), dtype=np.uint32)
    cur = t[np.left_shift(1, np.arange(8))].astype(np.uint32)
    for k in range(max_distance):
        out[k] = cur
        cur = (cur >> np.uint32(8)) ^ t[cur & np.uint32(0xFF)]
    return out


@functools.cache
def zero_crc_table(max_len: int = BLOCK_SIZE) -> np.ndarray:
    """``Z[n]`` = crc32c of ``n`` zero bytes, for ``n`` in
    ``0..max_len`` inclusive. Shape ``(max_len + 1,)`` uint32. This is
    the affine constant of the linearized CRC."""
    t = byte_table()
    out = np.empty(max_len + 1, dtype=np.uint32)
    state = _INIT
    for n in range(max_len + 1):
        out[n] = state ^ _INIT
        state = (state >> 8) ^ int(t[state & 0xFF])
    return out


def _parallel_chunk_crc(chunk: np.ndarray) -> int:
    """CRC32C of one chunk (``len <= BLOCK_SIZE``) via the linearized
    form (one matrix-free XOR contraction per chunk)."""
    n = len(chunk)
    if n == 0:
        return 0
    lb = lbit_table()[n - 1 :: -1]  # distance n-1-i for byte i
    bits = (chunk[:, None].astype(np.uint32) >> np.arange(8, dtype=np.uint32)) & 1
    contrib = np.bitwise_xor.reduce(lb * bits, axis=(0, 1))
    return int(contrib ^ zero_crc_table()[n])


# --- GF(2) matrix machinery for chunk combination ---------------------------


def _gf2_matrix_apply(mat: np.ndarray, vec: int) -> int:
    """Apply a 32x32 GF(2) matrix (``mat[i]`` = column for bit ``i``)
    to a 32-bit vector."""
    sel = (np.uint32(vec) >> np.arange(32, dtype=np.uint32)) & 1
    return int(np.bitwise_xor.reduce(mat * sel))


def _gf2_matrix_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Column-wise compose: result column i = a applied to b's column i."""
    out = np.empty(32, dtype=np.uint32)
    for i in range(32):
        out[i] = _gf2_matrix_apply(a, int(b[i]))
    return out


@functools.cache
def _zero_byte_matrix() -> np.ndarray:
    """Matrix of one raw zero-byte step ``s -> (s >> 8) ^ T[s & 0xff]``."""
    t = byte_table()
    cols = np.empty(32, dtype=np.uint32)
    for i in range(32):
        e = 1 << i
        cols[i] = (e >> 8) ^ int(t[e & 0xFF])
    return cols


@functools.cache
def _shift_matrix_pow2(log2_nbytes: int) -> np.ndarray:
    """Matrix advancing the raw CRC state by ``2**log2_nbytes`` zero
    bytes (by repeated squaring)."""
    if log2_nbytes == 0:
        return _zero_byte_matrix()
    m = _shift_matrix_pow2(log2_nbytes - 1)
    return _gf2_matrix_compose(m, m)


@functools.cache
def shift_matrices(count: int = 32) -> np.ndarray:
    """``(count, 32)`` uint32: row ``k`` is the matrix (column ``i`` for
    state bit ``i``) advancing a raw CRC state by ``2**k`` zero bytes.
    A shift by any ``nbytes < 2**count`` applies the rows of its set
    bits, as :func:`crc32c_shift` does; the CUDA kernel takes them as
    its combine table."""
    return np.stack([_shift_matrix_pow2(k) for k in range(count)])


def crc32c_shift(crc: int, nbytes: int) -> int:
    """Advance ``crc`` as if ``nbytes`` additional zero bytes followed —
    the raw linear shift used by :func:`crc32c_combine`."""
    bit = 0
    while nbytes:
        if nbytes & 1:
            crc = _gf2_matrix_apply(_shift_matrix_pow2(bit), crc)
        nbytes >>= 1
        bit += 1
    return crc


def crc32c_combine(crc_a: int, crc_b: int, len_b: int) -> int:
    """CRC of a concatenation: ``crc(A || B)`` given ``crc(A)``,
    ``crc(B)`` and ``len(B)``. Follows from linearity:
    ``crc(A||B) = shift(crc(A), len_b) ^ crc(B)``."""
    return crc32c_shift(crc_a, len_b) ^ crc_b


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of ``data`` (bytes-like or uint8 ndarray), chunked through
    the parallel formulation. ``crc`` continues a previous computation."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray
    ) else data.astype(np.uint8, copy=False)
    out = crc
    for start in range(0, len(arr), BLOCK_SIZE):
        chunk = arr[start : start + BLOCK_SIZE]
        out = crc32c_combine(out, _parallel_chunk_crc(chunk), len(chunk))
    return out


# --- Framing-format masking -------------------------------------------------


def mask_crc(crc: int) -> int:
    """Masked CRC stored in framing chunks. Parity: Crc32CAlgorithm.cs:157."""
    crc &= _U32
    return (((crc >> 15) | (crc << 17)) + CRC_MASK_DELTA) & _U32


def unmask_crc(masked: int) -> int:
    """Inverse of :func:`mask_crc`."""
    x = (masked - CRC_MASK_DELTA) & _U32
    return ((x >> 17) | (x << 15)) & _U32
