"""Snappy block decode, greedy and best-mode encode, one CUDA block per
Snappy block, and the match-extension probe.

Port of ``snappier_tpu/ops/pallas/scalar_codec.py``: the wrappers keep the
JAX functions' arguments, shapes and dtypes (byte rows as int32 or uint8,
int32 lengths, int32 results), so the two compare like with like. Inside,
the kernels read and write uint8 rows; the TPU's key images and
word-packed images existed because its scalar memory is word-addressed and
have no counterpart here.

Each wrapper launches its CUDA kernel (``csrc/decode.cu``,
``csrc/encode.cu``, ``csrc/encode_best.cu``, ``csrc/probe.cu``) for
tensors on a CUDA device and runs the plain Python version beside it
(:func:`decode_blocks_plain`, :func:`encode_blocks_plain`,
:func:`encode_best_plain`, :func:`match_extension_probe_plain`) for tensors
on the CPU. The encoders' and the probe's plain versions follow the walks
in ``csrc/scalar_codec.cuh`` step for step; the decoder's takes one tag at
a time where the kernel's walk resolves a batch of tags per warp step, and
computes the same triple.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from snappier_tpu_torch.constants import BLOCK_SIZE, INPUT_MARGIN_BYTES
from snappier_tpu_torch.ops.best_match import DEFAULT_WIDTHS, exact_candidates
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
    """One block's walk, a tag at a time; computes what
    ``sc::decode_block_batched`` computes. Returns ``(out_len, err)`` and
    writes the output into ``out``."""
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


def _layout(name: str, rows: torch.Tensor, *args, loaders=("bytes", "words")) -> dict:
    """A kernel's launch layout for ``rows`` on their CUDA device, from its
    layout query ``name``: ``blocks_per_sm`` (the CUDA occupancy
    calculator's count under the attributes the launch sets),
    ``smem_bytes`` of shared memory and ``threads`` per block, and
    ``loader``, named by ``loaders[code]``."""
    if not on_cuda(rows):
        raise ValueError("the layout is the CUDA kernel's: the rows must be on a CUDA device")
    out = (ctypes.c_int32 * 4)()
    with torch.cuda.device(rows.device):
        rc = _build.launcher(name)(rows.data_ptr(), rows.shape[1], *args, out)
    if rc != 0:
        raise RuntimeError(f"{name} query failed with cudaError {rc}")
    return {"blocks_per_sm": out[0], "smem_bytes": out[1], "threads": out[2],
            "loader": loaders[out[3]]}


def decode_layout(comp, out_cap: int = BLOCK_SIZE) -> dict:
    """The decode kernel's launch layout for these rows, as
    :func:`decode_blocks_bytes` launches it (:func:`_layout`; shared bytes
    dynamic and static, the loader ``"ring"`` for a base and width that are
    multiples of 4, else ``"bytes"``)."""
    comp = byte_rows(comp, "comp")
    if not 0 < int(out_cap) <= MAX_OUT_CAP:
        raise ValueError(f"out_cap must be in (0, {MAX_OUT_CAP}], got {out_cap}")
    return _layout("decode_layout", comp, int(out_cap), loaders=("ring", "bytes"))


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


def _extend(key, at: int, cand: int, n: int, seed=None) -> int:
    """Full match length at ``at`` against ``cand``; mirrors
    ``sc::extend_match``, with ``seed(pos)`` where the fast walk seeds its
    table."""
    m, go, eq0l = 4, True, True
    if at + 12 <= n:
        if seed:
            seed(at + 4)
        eq0w = key(at + 4) == key(cand + 4)
        m, go, eq0l = 12, eq0w and key(at + 8) == key(cand + 8), eq0w
    while go and at + m + 8 <= n:
        if seed:
            seed(at + m)
        eq0 = key(at + m) == key(cand + m)
        go = eq0 and key(at + m + 4) == key(cand + m + 4)
        m += 8
        eq0l = eq0
    if not go:
        m = m - 8 + (4 if eq0l else 0)
    if go and at + m + 4 <= n and key(at + m) == key(cand + m):
        m += 4
    x = key(at + m) ^ key(cand + m)
    if x == 0:
        m += 3
    else:
        m += (x & 0xFF == 0) + (x & 0xFFFF == 0) + (x & 0xFFFFFF == 0)
    return min(m, n - at)


class _Emitter:
    """Tag emission into a bytearray; mirrors ``sc::emit_literal`` and
    ``sc::emit_copy``."""

    def __init__(self, s: np.ndarray):
        self.s = s
        self.out = bytearray()

    def literal(self, start: int, end: int) -> None:
        ln = end - start
        if ln <= 0:
            return
        lm1 = ln - 1
        extra = 2 if ln > 256 else (1 if ln > 60 else 0)
        out = self.out
        out.append(lm1 << 2 if extra == 0 else (59 + extra) << 2)
        if extra >= 1:
            out.append(lm1 & 0xFF)
        if extra == 2:
            out.append((lm1 >> 8) & 0xFF)
        out.extend(self.s[start:end].astype(np.uint8).tobytes())

    def _copy_upto64(self, off: int, ln: int) -> None:
        if ln <= 11 and off < 2048:
            self.out.extend((1 | (ln - 4) << 2 | (off >> 8) << 5, off & 0xFF))
        else:
            self.out.extend((2 | (ln - 1) << 2, off & 0xFF, (off >> 8) & 0xFF))

    def copy(self, off: int, ln: int) -> None:
        while ln >= 68:
            self._copy_upto64(off, 64)
            ln -= 64
        if ln > 64:
            self._copy_upto64(off, 60)
            ln -= 60
        self._copy_upto64(off, ln)


def _staged_keys(row: np.ndarray, n: int):
    """The fragment as uint64 with 8 zero bytes past n, and its 4-byte keys
    at positions 0..n+3 (bytes past n read as zero, as in the kernels'
    staging)."""
    s = np.zeros(n + 8, np.uint64)
    s[:n] = row[:n]
    keys = s[0 : n + 4] | s[1 : n + 5] << 8 | s[2 : n + 6] << 16 | s[3 : n + 7] << 24
    return s, keys


def _encode_row(row: np.ndarray, n: int, hash_bits: int, skip_base: int) -> bytes:
    """One fragment's greedy walk; mirrors ``sc::encode_fragment``."""
    s, keys_np = _staged_keys(row, n)
    hashes = (((keys_np * HASH_MUL) & _U32) >> (32 - hash_bits)).tolist()
    keys = keys_np.tolist()
    key = keys.__getitem__
    table = [_EMPTY] * (1 << hash_bits)
    em = _Emitter(s)

    def seed(pos):
        p = min(pos - 3, n - 5)
        table[hashes[p]] = p

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
        m = _extend(key, at, cand, n, seed)
        em.literal(lit_start, at)
        em.copy(at - cand, m)
        ip = lit_start = at + m
        skip = skip_base
    em.literal(lit_start, n)
    return bytes(em.out)


def _encode_best_row(row: np.ndarray, n: int, cands: list, skip_base: int) -> bytes:
    """One fragment's level="best" walk; mirrors ``sc::encode_fragment_best``
    (a candidate outside [0, i) counts as none)."""
    s, keys_np = _staged_keys(row, n)
    keys = keys_np.tolist()
    key = keys.__getitem__
    em = _Emitter(s)
    ip, lit_start, skip = min(1, n), 0, skip_base
    while ip + INPUT_MARGIN_BYTES < n:
        c = cands[ip]
        if not 0 <= c < ip or keys[c] != keys[ip]:
            ip += 1 + (skip >> 7)
            skip += 1
            continue
        m = _extend(key, ip, c, n)
        em.literal(lit_start, ip)
        em.copy(ip - c, m)
        ip = lit_start = ip + m
        skip = skip_base
    em.literal(lit_start, n)
    return bytes(em.out)


def _rows_out(bodies: list, F: int):
    """Bodies (bytes) -> (uint8[B, body_width(F)], int32[B]) tensors."""
    out = np.zeros((len(bodies), body_width(F)), np.uint8)
    body_lens = np.zeros(len(bodies), np.int32)
    for b, body in enumerate(bodies):
        out[b, : len(body)] = np.frombuffer(body, np.uint8)
        body_lens[b] = len(body)
    return torch.from_numpy(out), torch.from_numpy(body_lens)


def encode_blocks_plain(frags: torch.Tensor, lengths: torch.Tensor, hash_bits: int,
                        skip_base: int):
    """Plain version of the encode kernel on CPU uint8 rows: returns
    ``(bodies uint8[B, body_width(F)], body_lens int32[B])``."""
    B, F = frags.shape
    rows = frags.numpy()
    lens = lengths.tolist()
    return _rows_out(
        [_encode_row(rows[b], min(max(lens[b], 0), F), hash_bits, skip_base)
         for b in range(B)], F)


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


def encode_layout(frags, hash_bits: int = HASH_BITS) -> dict:
    """The encode kernel's launch layout for these rows, as
    :func:`encode_blocks_bytes` launches it (:func:`_layout`; dynamic
    shared bytes, the loader ``"words"`` for a base and width that are
    multiples of 16)."""
    frags = byte_rows(frags, "frags")
    if not 8 <= hash_bits <= 16:
        raise ValueError(f"hash_bits must be in [8, 16], got {hash_bits}")
    return _layout("encode_layout", frags, hash_bits)


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


# ---------------------------------------------------------------------------
# level="best" encoder
# ---------------------------------------------------------------------------


def encode_best_plain(frags: torch.Tensor, lengths: torch.Tensor, cands: torch.Tensor,
                      skip_base: int):
    """Plain version of the best-mode encode kernel on CPU uint8 rows and
    int32 candidates: returns ``(bodies uint8[B, body_width(F)],
    body_lens int32[B])``."""
    B, F = frags.shape
    rows = frags.numpy()
    lens = lengths.tolist()
    cand_rows = cands.numpy()
    bodies = []
    for b in range(B):
        n = min(max(lens[b], 0), F)
        bodies.append(_encode_best_row(rows[b], n, cand_rows[b, :n].tolist(), skip_base))
    return _rows_out(bodies, F)


def _encode_best(frags, lengths, cands, skip_base: int = 32):
    """Encode a batch of fragments with one given candidate per position
    (the JAX ``_encode_best_pallas`` step, minus its unpacking).

    Args:
      frags: [B, F] int32 or uint8 byte rows, F <= 65536.
      lengths: [B] fragment lengths (clamped to [0, F]).
      cands: [B, F] integer candidates, -1 for none
        (:func:`snappier_tpu_torch.ops.best_match.exact_candidates`); a
        candidate outside [0, i) counts as none.
      skip_base: skip-heuristic start constant (the miss step is
        ``1 + (skip >> 7)``).

    Returns ``(bodies uint8[B, body_width(F)], body_lens int32[B])``.
    """
    frags = byte_rows(frags, "frags")
    B, F = frags.shape
    lengths = lengths_vector(lengths, B, "lengths")
    if not 0 < F <= BLOCK_SIZE:
        raise ValueError(f"fragment width must be in (0, {BLOCK_SIZE}], got {F}")
    if not isinstance(cands, torch.Tensor) or cands.shape != (B, F):
        raise ValueError(f"cands must be a tensor of shape ({B}, {F})")
    if cands.dtype.is_floating_point or cands.dtype == torch.bool:
        raise ValueError(f"cands must be integers, not {cands.dtype}")
    cands = cands.to(torch.int32).contiguous()
    if not on_cuda(frags, lengths, cands):
        return encode_best_plain(frags, lengths, cands, skip_base)
    W = body_width(F)
    bodies = torch.empty((B, W), dtype=torch.uint8, device=frags.device)
    body_lens = torch.empty(B, dtype=torch.int32, device=frags.device)
    _build.launch(
        "encode_best", frags.device, frags.data_ptr(), F, lengths.data_ptr(), B,
        cands.data_ptr(), skip_base, bodies.data_ptr(), W, body_lens.data_ptr(),
    )
    return bodies, body_lens


def best_layout(frags) -> dict:
    """The best-mode encode kernel's launch layout for these rows, as
    :func:`_encode_best` launches it (:func:`_layout`; dynamic shared bytes,
    the loader ``"words"`` for a base and width that are multiples of 4)."""
    return _layout("best_layout", byte_rows(frags, "frags"))


def encode_blocks_best(frags, lengths, widths: tuple | None = None, skip_base: int = 32):
    """``level="best"`` encode (``encode_blocks_best`` contract): the
    exact-nearest multi-width candidates, then the best-mode walk.

    Returns ``(bodies int32[B, F + 2048], body_lens int32[B])``.
    """
    frags = byte_rows(frags, "frags")
    lengths = lengths_vector(lengths, frags.shape[0], "lengths")
    cands = exact_candidates(frags, lengths, DEFAULT_WIDTHS if widths is None else widths)
    bodies, body_lens = _encode_best(frags, lengths, cands, skip_base)
    return bodies[:, : frags.shape[1] + 2048].to(torch.int32), body_lens


# ---------------------------------------------------------------------------
# Match-extension probe (test hook)
# ---------------------------------------------------------------------------


def match_extension_probe_plain(bufs: torch.Tensor, ats: torch.Tensor, cands: torch.Tensor,
                                ns: torch.Tensor) -> torch.Tensor:
    """Plain version of the probe kernel on CPU uint8 rows and clamped
    int32 arguments."""
    out = np.zeros(bufs.shape[0], np.int32)
    for b, (row, at, cand, n) in enumerate(zip(
            bufs.numpy(), ats.tolist(), cands.tolist(), ns.tolist())):
        buf = row.tobytes()  # a slice past the end is short: zeros above

        def key(i, buf=buf):
            return int.from_bytes(buf[i : i + 4], "little")

        out[b] = _extend(key, at, cand, n)
    return torch.from_numpy(out)


def probe_clamps(cc: int, ats: torch.Tensor, cands: torch.Tensor, ns: torch.Tensor):
    """The probe's arguments as its kernel clamps them (``sc::probe_args``):
    ``ns`` into [0, cc], ``ats`` into [0, n], ``cands`` into [0, cc]."""
    ns = ns.clamp(0, cc)
    return torch.minimum(ats.clamp(min=0), ns), cands.clamp(0, cc), ns


def match_extension_probe(bufs, ats, cands, ns):
    """TEST HOOK: the encoders' extension walk, once per row.

    Args:
      bufs: [B, CC] int32 or uint8 byte rows; bytes outside a row read as
        zero.
      ats, cands, ns: [B] match position, candidate position and buffer
        length per row. Precondition, as in the encoders: the 4 bytes at
        ``ats`` and ``cands`` are equal and ``cands < ats``. ``ns`` is
        clamped to [0, CC], ``ats`` to [0, n] and ``cands`` to [0, CC]
        (:func:`probe_clamps`; on the card inside the kernel, so that a call
        on uint8 rows and int32 arguments is one device operation).

    Returns int32[B] full match lengths (``match_extension_probe``
    contract), which the FindMatchLength golden vectors pin.
    """
    bufs = byte_rows(bufs, "bufs")
    B, cc = bufs.shape
    ats, cands, ns = (lengths_vector(x, B, name)
                      for x, name in ((ats, "ats"), (cands, "cands"), (ns, "ns")))
    if not on_cuda(bufs, ats, cands, ns):
        return match_extension_probe_plain(bufs, *probe_clamps(cc, ats, cands, ns))
    return launch_probe(bufs, ats, cands, ns)


def launch_probe(bufs: torch.Tensor, ats: torch.Tensor, cands: torch.Tensor,
                 ns: torch.Tensor) -> torch.Tensor:
    """:func:`match_extension_probe`'s kernel alone on contiguous CUDA uint8
    rows and int32 arguments as given (the kernel clamps them)."""
    out = torch.empty(bufs.shape[0], dtype=torch.int32, device=bufs.device)
    _build.launch(
        "probe", bufs.device, bufs.data_ptr(), bufs.shape[1], ats.data_ptr(), cands.data_ptr(),
        ns.data_ptr(), bufs.shape[0], out.data_ptr(),
    )
    return out
