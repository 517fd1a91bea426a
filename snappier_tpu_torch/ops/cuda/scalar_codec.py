"""Snappy block decode and greedy encode, one CUDA block per Snappy block.

Port of ``snappier_tpu/ops/pallas/scalar_codec.py``: the wrappers keep the
JAX functions' arguments, shapes and dtypes (byte rows as int32 or uint8,
int32 lengths, int32 results), so the two compare like with like. Inside,
the kernels read and write uint8 rows; the TPU's key images and
word-packed images existed because its scalar memory is word-addressed and
have no counterpart here.

Each wrapper launches its CUDA kernel (``csrc/decode.cu``,
``csrc/encode.cu``) for tensors on a CUDA device and runs the plain
Python version beside it (:func:`decode_blocks_plain`,
:func:`encode_blocks_plain`) for tensors on the CPU. Both follow the walks
in ``csrc/scalar_codec.cuh`` step for step.
"""

from __future__ import annotations

import numpy as np
import torch

from snappier_tpu_torch.constants import BLOCK_SIZE, INPUT_MARGIN_BYTES
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.ops.cuda._tensors import byte_rows, lengths_vector, on_cuda
from snappier_tpu_torch.ops.decode import (
    ERR_BAD_PREAMBLE,
    ERR_LENGTH_MISMATCH,
    ERR_MALFORMED,
)

#: Largest out_cap the decode kernel stages in one block's shared memory
#: (Hopper allows 227 KB of dynamic shared memory per block).
MAX_OUT_CAP = 232448
HASH_BITS = 15
HASH_MUL = 0x1E35A7BD
_EMPTY = 0xFFFF
_U32 = 0xFFFFFFFF


def body_width(frag_w: int) -> int:
    """Byte width of an encoded row: the JAX kernel's word-packed image
    width (``F + 2048`` bytes rounded up to 1024 words), which bounds
    greedy emission (``constants.greedy_emit_bound``) with room to spare."""
    return -(-(frag_w + 2048) // 4096) * 4096


def _as_int32(v: int) -> int:
    v &= _U32
    return v - (1 << 32) if v >= 1 << 31 else v


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _decode_row(comp: bytes, n: int, out_cap: int, out: bytearray):
    """One block's walk; mirrors ``sc::decode_block``. Returns
    ``(out_len, err)`` and writes the output into ``out``."""
    cc = len(comp)

    def rd(i):
        return comp[i] if 0 <= i < cc else 0

    pre_len, val, done, err = 0, 0, False, 0
    while not done and pre_len < 5 and err == 0:
        byte = rd(pre_len)
        val |= (byte & 0x7F) << min(7 * pre_len, 28)
        done = byte < 0x80
        if pre_len == 4 and byte >= 8:
            err = ERR_BAD_PREAMBLE
        pre_len += 1
    expected = _as_int32(val)
    if not done or pre_len > n or expected > out_cap or expected < 0:
        err = ERR_BAD_PREAMBLE
    if err:
        return 0, err

    ip, op, bad = pre_len, 0, False
    while ip < n:
        tag = rd(ip)
        rest = rd(ip + 1) | rd(ip + 2) << 8 | rd(ip + 3) << 16 | rd(ip + 4) << 24
        tt = tag & 3
        off = 0
        if tt == 0:
            l6 = tag >> 2
            if l6 < 60:
                hdr, length = 1, l6 + 1
            else:
                extra = l6 - 59
                hdr = 1 + extra
                lm = (1 << (8 * extra)) - 1 if extra < 4 else _U32
                length = _as_int32((rest & lm) + 1)
        elif tt == 1:
            hdr, length = 2, ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | (rest & 0xFF)
        elif tt == 2:
            hdr, length = 3, (tag >> 2) + 1
            off = rest & 0xFFFF
        else:
            hdr, length = 5, (tag >> 2) + 1
            off = _as_int32(rest)
        ip2 = ip + hdr + (length if tt == 0 else 0)
        if (
            ip2 > n
            or ((length - 1) & _U32) >= ((expected - op) & _U32)
            or (tt != 0 and (off <= 0 or off > op))
        ):
            bad = True
            break
        if tt == 0:
            seg = comp[ip + hdr : ip + hdr + length]
            out[op : op + length] = seg + bytes(length - len(seg))
        elif off >= length:
            out[op : op + length] = out[op - off : op - off + length]
        else:
            pat = out[op - off : op]
            out[op : op + length] = (pat * (length // off + 1))[:length]
        op += length
        ip = ip2
    if bad or ip != n:
        return 0, ERR_MALFORMED
    if op != expected:
        return 0, ERR_LENGTH_MISMATCH
    return expected, 0


def decode_blocks_plain(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int):
    """Plain version of the decode kernel on CPU uint8 rows: returns
    ``(out uint8[B, out_cap], out_lens int32[B], errs int32[B])``."""
    B = comp.shape[0]
    rows = comp.numpy()
    lens = comp_lens.tolist()
    out = np.zeros((B, out_cap), np.uint8)
    out_lens = np.zeros(B, np.int32)
    errs = np.zeros(B, np.int32)
    for b in range(B):
        buf = bytearray(out_cap)
        out_lens[b], errs[b] = _decode_row(rows[b].tobytes(), lens[b], out_cap, buf)
        out[b] = np.frombuffer(buf, np.uint8)
    return torch.from_numpy(out), torch.from_numpy(out_lens), torch.from_numpy(errs)


def decode_blocks_bytes(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int):
    """Decode a batch of Snappy blocks into uint8 rows.

    Args:
      comp: [B, CC] int32 or uint8 compressed blocks (varint + tags);
        bytes past each length may hold anything.
      comp_lens: [B] compressed lengths.
      out_cap: output capacity per block; a preamble claiming more is
        ``ERR_BAD_PREAMBLE``.

    Returns ``(out uint8[B, out_cap], out_lens int32[B], errs int32[B])``;
    bytes of a row past its out_len are unspecified.
    """
    comp = byte_rows(comp, "comp")
    B, cc = comp.shape
    comp_lens = lengths_vector(comp_lens, B, "comp_lens")
    out_cap = int(out_cap)
    if not 0 < out_cap <= MAX_OUT_CAP:
        raise ValueError(f"out_cap must be in (0, {MAX_OUT_CAP}], got {out_cap}")
    if not on_cuda(comp, comp_lens):
        return decode_blocks_plain(comp, comp_lens, out_cap)
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=comp.device)
    out_lens = torch.empty(B, dtype=torch.int32, device=comp.device)
    errs = torch.empty(B, dtype=torch.int32, device=comp.device)
    _build.launch(
        "decode", comp.device, comp.data_ptr(), cc, comp_lens.data_ptr(), B,
        out_cap, out.data_ptr(), out_lens.data_ptr(), errs.data_ptr(),
    )
    return out, out_lens, errs


def decode_blocks_scalar(comp, comp_lens, out_cap: int = BLOCK_SIZE, packed: bool = False):
    """Decode a batch of Snappy blocks (``decode_blocks_scalar`` contract).

    Returns ``(out int32[B, out_cap], out_lens int32[B], errs int32[B])``,
    or with ``packed`` ``out`` as int32[B, out_cap // 4] holding 4
    little-endian bytes per word.
    """
    if packed and out_cap % 4:
        raise ValueError("packed output needs out_cap % 4 == 0")
    out, out_lens, errs = decode_blocks_bytes(comp, comp_lens, out_cap)
    return (out.view(torch.int32) if packed else out.to(torch.int32)), out_lens, errs


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _encode_row(row: np.ndarray, n: int, hash_bits: int, skip_base: int) -> bytes:
    """One fragment's greedy walk; mirrors ``sc::encode_fragment``."""
    s = np.zeros(n + 8, np.uint64)
    s[:n] = row[:n]
    keys_np = s[0 : n + 4] | s[1 : n + 5] << 8 | s[2 : n + 6] << 16 | s[3 : n + 7] << 24
    hashes = (((keys_np * HASH_MUL) & _U32) >> (32 - hash_bits)).tolist()
    keys = keys_np.tolist()
    table = [_EMPTY] * (1 << hash_bits)
    out = bytearray()

    def literal(start, end):
        ln = end - start
        if ln <= 0:
            return
        lm1 = ln - 1
        extra = 2 if ln > 256 else (1 if ln > 60 else 0)
        out.append(lm1 << 2 if extra == 0 else (59 + extra) << 2)
        if extra >= 1:
            out.append(lm1 & 0xFF)
        if extra == 2:
            out.append((lm1 >> 8) & 0xFF)
        out.extend(s[start:end].astype(np.uint8).tobytes())

    def copy_upto64(off, ln):
        if ln <= 11 and off < 2048:
            out.extend((1 | (ln - 4) << 2 | (off >> 8) << 5, off & 0xFF))
        else:
            out.extend((2 | (ln - 1) << 2, off & 0xFF, (off >> 8) & 0xFF))

    def copy(off, ln):
        while ln >= 68:
            copy_upto64(off, 64)
            ln -= 64
        if ln > 64:
            copy_upto64(off, 60)
            ln -= 60
        copy_upto64(off, ln)

    def seed(pos):
        p = min(pos - 3, n - 5)
        table[hashes[p]] = p

    def extend(at, cand):
        m, go, eq0l = 4, True, True
        if at + 12 <= n:
            seed(at + 4)
            eq0w = keys[at + 4] == keys[cand + 4]
            m, go, eq0l = 12, eq0w and keys[at + 8] == keys[cand + 8], eq0w
        while go and at + m + 8 <= n:
            seed(at + m)
            eq0 = keys[at + m] == keys[cand + m]
            go = eq0 and keys[at + m + 4] == keys[cand + m + 4]
            m += 8
            eq0l = eq0
        if not go:
            m = m - 8 + (4 if eq0l else 0)
        if go and at + m + 4 <= n and keys[at + m] == keys[cand + m]:
            m += 4
        x = keys[at + m] ^ keys[cand + m]
        if x == 0:
            m += 3
        else:
            m += (x & 0xFF == 0) + (x & 0xFFFF == 0) + (x & 0xFFFFFF == 0)
        return min(m, n - at)

    ip, lit_start, skip = min(1, n), 0, skip_base
    while ip + INPUT_MARGIN_BYTES < n:
        cur = keys[ip : ip + 4]
        hs = hashes[ip : ip + 4]
        ent = [table[h] for h in hs]
        for d in range(4):
            table[hs[d]] = ip + d
        hit = None
        for d in range(4):
            e = ent[d]
            ok = e != _EMPTY and e < ip + d and keys[e] == cur[d]
            cand = e if ok else 0
            for i in range(d):
                if cur[i] == cur[d]:
                    cand, ok = ip + i, True
            if ok:
                hit = (ip + d, cand)
                break
        if hit is None:
            ip += 3 + (skip >> 5)
            skip += 1
            continue
        at, cand = hit
        m = extend(at, cand)
        literal(lit_start, at)
        copy(at - cand, m)
        ip = lit_start = at + m
        skip = skip_base
    literal(lit_start, n)
    return bytes(out)


def encode_blocks_plain(frags: torch.Tensor, lengths: torch.Tensor, hash_bits: int,
                        skip_base: int):
    """Plain version of the encode kernel on CPU uint8 rows: returns
    ``(bodies uint8[B, body_width(F)], body_lens int32[B])``."""
    B, F = frags.shape
    rows = frags.numpy()
    lens = lengths.tolist()
    out = np.zeros((B, body_width(F)), np.uint8)
    body_lens = np.zeros(B, np.int32)
    for b in range(B):
        body = _encode_row(rows[b], min(max(lens[b], 0), F), hash_bits, skip_base)
        out[b, : len(body)] = np.frombuffer(body, np.uint8)
        body_lens[b] = len(body)
    return torch.from_numpy(out), torch.from_numpy(body_lens)


def encode_blocks_bytes(frags, lengths, hash_bits: int = HASH_BITS, skip_base: int = 32):
    """Greedy-encode a batch of fragments into uint8 rows.

    Args:
      frags: [B, F] int32 or uint8 byte rows, F <= 65536; bytes past each
        length may hold anything.
      lengths: [B] fragment lengths (clamped to [0, F]).
      hash_bits: match-table size log2, 8..16.
      skip_base: skip-heuristic start constant.

    Returns ``(bodies uint8[B, body_width(F)], body_lens int32[B])``: tag
    streams without the varint preamble; bytes past a row's length are
    unspecified.
    """
    frags = byte_rows(frags, "frags")
    B, F = frags.shape
    lengths = lengths_vector(lengths, B, "lengths")
    if not 0 < F <= BLOCK_SIZE:
        raise ValueError(f"fragment width must be in (0, {BLOCK_SIZE}], got {F}")
    if not 8 <= hash_bits <= 16:
        raise ValueError(f"hash_bits must be in [8, 16], got {hash_bits}")
    if not on_cuda(frags, lengths):
        return encode_blocks_plain(frags, lengths, hash_bits, skip_base)
    W = body_width(F)
    bodies = torch.empty((B, W), dtype=torch.uint8, device=frags.device)
    body_lens = torch.empty(B, dtype=torch.int32, device=frags.device)
    _build.launch(
        "encode", frags.device, frags.data_ptr(), F, lengths.data_ptr(), B,
        hash_bits, skip_base, bodies.data_ptr(), W, body_lens.data_ptr(),
    )
    return bodies, body_lens


def encode_blocks_scalar(frags, lengths, hash_bits: int = HASH_BITS, skip_base: int = 32,
                         packed: bool = False):
    """Compress a batch of fragments (``encode_blocks_scalar`` contract).

    Returns ``(bodies int32[B, F + 2048], body_lens int32[B])``, or with
    ``packed`` the bodies as int32[B, body_width(F) // 4] words of 4
    little-endian bytes (the JAX kernel's packed image shape).
    """
    bodies, body_lens = encode_blocks_bytes(frags, lengths, hash_bits, skip_base)
    if packed:
        return bodies.view(torch.int32), body_lens
    F = frags.shape[1]
    return bodies[:, : F + 2048].to(torch.int32), body_lens
