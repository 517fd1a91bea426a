"""The encode-walk ablation: the greedy encode walk under flag tuples and in
named restructurings (port of the kernels of ``tools/perf_probe_enc.py`` and
of ``encode_r4`` in ``tools/perf_probe_r4.py``).

``encode_variant(frags, lengths, flags)`` takes a tuple of the flags
``merged``, ``btail``, ``bcopy``, ``noemit``, ``ext8``, ``adv4``, ``probe8``,
``hbN`` (N hash bits, default 14), ``stN`` (N table stores per probe,
default 4) and ``noscan``; :data:`VARIANT_FLAGS` names sixteen tuples.
``encode_r4(frags, lengths, variant)`` takes one of the sixteen names of
:data:`R4_VARIANTS`, all at the production 15 hash bits. Both return
``(bodies uint8 [B, F + 2048], body_lens int32 [B])``: tag streams without
the varint preamble; bytes of a row past its length are unspecified.
Lengths outside ``[0, F]`` are taken as 0 or ``F``.

The two families are one walk whose parts a mask chooses
(``csrc/encode_variants.cuh`` says which). Some parts change the bytes, and
such a variant gives another valid encoding of its input; the others only
reorder the work and give the bytes of the walk they restructure.
:data:`R4_PRODUCTION_BYTES` names the ``encode_r4`` variants whose bytes are
those of the production encoder,
:func:`snappier_tpu_torch.ops.cuda.scalar_codec.encode_blocks_bytes`.
Without emission (``noemit``, ``encnoemit``) only ``body_lens`` means
anything: twice the number of matches for ``noemit``, the true lengths for
``encnoemit``; ``noscan`` gives 0 and ``encdmaonly`` the input lengths.

``encode_stats(frags, lengths)`` (``tools/perf_probe_r4.py::encode_stats``)
runs the walk of :data:`STATS_MASK` at 15 hash bits and returns its budget
per fragment, int32 [B, 4]: miss iterations, hits, extension iterations and
matched bytes.

A CUDA tensor launches the kernel (``csrc/encode_variants.cu``,
``csrc/encode_r4.cu``, ``csrc/encode_stats.cu``) or raises; a CPU tensor
runs the plain Python walk, which computes each variant's function (the
parts that only reorder work have no plain counterpart). Each wrapper counts
its own launches. ``encode_variant``, ``encode_r4`` and ``encode_stats`` run
in the encode kernel's layout (the match table alone in shared memory, the
fragment read through the read-only path, one warp a fragment);
:func:`encode_variant_layout`, :func:`encode_r4_layout` and
:func:`encode_stats_layout` give it for their rows, as
:func:`snappier_tpu_torch.ops.cuda.scalar_codec.encode_layout` does for the
encode kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from snappier_tpu_torch.constants import BLOCK_SIZE, INPUT_MARGIN_BYTES
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.ops.cuda._tensors import byte_rows, lengths_vector, on_cuda
from snappier_tpu_torch.ops.cuda.scalar_codec import (
    _EMPTY,
    _U32,
    HASH_BITS,
    HASH_MUL,
    _Emitter,
    _layout,
    _staged_keys,
)

# The bits of a walk's mask (csrc/encode_variants.cuh, the EV_* constants).
EXT_LOOP4, EXT_4, EXT_8, EXT_8U, EXT_8S2, EXT_16U = range(6)
EXT_MASK = 7
POST_SEED = 1 << 3
XOR_TAIL = 1 << 4
BFREE_COPY = 1 << 5
EMIT_COUNT = 1 << 6
EMIT_HITS = 1 << 7
PROBE8 = 1 << 8
OCT = 1 << 9
ADV4 = 1 << 10
TRIM = 1 << 11
LOOP_PRE = 1 << 12
LOOP_TWO = 1 << 13
NOSCAN = 1 << 14
DMA_ONLY = 1 << 15

VARIANT_HASH_BITS = 14  # the TPU probe's table width

#: The named flag tuples of ``encode_variant``.
VARIANT_FLAGS = {
    "e1": ("merged",),
    "e2": ("merged", "btail"),
    "e3": ("merged", "btail", "bcopy"),
    "e4": ("merged", "btail", "bcopy", "noemit"),
    "eb": ("btail",),
    "ec": ("bcopy",),
    "ebc": ("btail", "bcopy"),
    "e6": ("ext8", "btail", "bcopy"),
    "e6a": ("ext8", "btail", "bcopy", "adv4"),
    "e7": ("ext8", "btail", "bcopy", "adv4", "probe8"),
    "e7n": ("ext8", "btail", "bcopy", "adv4", "probe8", "noemit"),
    "e6n": ("ext8", "btail", "bcopy", "adv4", "noemit"),
    "e9": ("merged", "btail", "bcopy", "st2"),
    "e10": ("merged", "btail", "bcopy", "hb13"),
    "e11": ("merged", "btail", "bcopy", "hb12", "st2"),
    "edma": ("noscan", "noemit"),
}

_R4_BASE = XOR_TAIL | BFREE_COPY
#: The named walks of ``encode_r4``. Names with one mask share a kernel: what
#: tells them apart on the TPU (a ``pl.when`` region against a ``lax.cond``,
#: a gated copy loop) is the same branch on a SIMT core.
R4_VARIANTS = {
    "encpre": _R4_BASE | EXT_4 | LOOP_PRE,
    "encnoemit": _R4_BASE | EXT_4 | EMIT_COUNT,
    "encdmaonly": _R4_BASE | EXT_4 | DMA_ONLY,
    "enccopywhen": _R4_BASE | EXT_4,
    "encr4": _R4_BASE | EXT_8U,
    "encext8": _R4_BASE | EXT_8,
    "encfull": _R4_BASE | EXT_8 | TRIM,
    "encext8u": _R4_BASE | EXT_8U,
    "encext16u": _R4_BASE | EXT_16U,
    "encext8s2": _R4_BASE | EXT_8S2,
    "encwhen": _R4_BASE | EXT_4 | TRIM,
    "encwhen8": _R4_BASE | EXT_8U | TRIM,
    "enctrim": _R4_BASE | EXT_4 | TRIM,
    "enc2loop": _R4_BASE | EXT_4 | LOOP_TWO,
    "encoct": _R4_BASE | EXT_4 | OCT,
    "encoct8": _R4_BASE | EXT_8U | OCT,
}
#: The ``encode_r4`` variants that give the production encoder's bytes: its
#: extension walk is the stride-8 one with the unconditional advance.
R4_PRODUCTION_BYTES = ("encr4", "encext8u", "encwhen8")
#: The ``encode_r4`` variants that store no tags.
R4_NO_BYTES = ("encnoemit", "encdmaonly")
#: ``encode_stats``' walk: K2's probe of 4 positions, all stored, the
#: stride-4 extension that seeds, the tail from one XOR, no emission.
STATS_MASK = EXT_4 | XOR_TAIL | EMIT_HITS


def flags_mask(flags: tuple) -> tuple[int, int, int]:
    """A flag tuple as ``(mask, hash_bits, store_step)``; raises on a flag
    the walk does not know."""
    hb, nstores, mask = VARIANT_HASH_BITS, 4, 0
    known = {"merged", "btail", "bcopy", "noemit", "ext8", "adv4", "probe8", "noscan"}
    for f in flags:
        if f in known:
            continue
        if f[:2] in ("hb", "st") and f[2:].isdigit():
            if f[:2] == "hb":
                hb = int(f[2:])
            else:
                nstores = int(f[2:])
            continue
        raise ValueError(f"unknown flag {f!r}: one of {sorted(known)}, hbN or stN")
    if not 8 <= hb <= VARIANT_HASH_BITS:
        raise ValueError(f"hbN must be in [8, {VARIANT_HASH_BITS}], got {hb}")
    if nstores < 1:
        raise ValueError(f"stN must be at least 1, got {nstores}")
    merged = "merged" in flags
    mask |= EXT_8U if "ext8" in flags else (EXT_4 if merged else EXT_LOOP4)
    mask |= 0 if merged else POST_SEED
    mask |= XOR_TAIL if "btail" in flags else 0
    mask |= BFREE_COPY if "bcopy" in flags else 0
    mask |= EMIT_HITS if "noemit" in flags else 0
    mask |= ADV4 if "adv4" in flags else 0
    mask |= PROBE8 if "probe8" in flags else 0
    mask |= NOSCAN if "noscan" in flags else 0
    width = 8 if "probe8" in flags else 4
    return mask, hb, (width // nstores if nstores < width else 1)


def _extend(mask: int, key, seed, at: int, cand: int, n: int) -> tuple[int, int]:
    """The match length before the tail and the extension walk's loop
    iterations; mirrors ``sc::variant_extend``."""
    ext = mask & EXT_MASK
    m, go, steps = 4, True, 0
    if ext == EXT_LOOP4:
        while at + m + 4 <= n and key(at + m) == key(cand + m):
            m += 4
            steps += 1
    elif ext == EXT_4:
        while go and at + m + 4 <= n:
            seed(at + m - 3)
            go = key(at + m) == key(cand + m)
            m += 4
            steps += 1
        if not go:
            m -= 4
    elif ext == EXT_8:
        while go and at + m + 8 <= n:
            steps += 1
            seed(at + m - 3)
            eq0 = key(at + m) == key(cand + m)
            eq1 = key(at + m + 4) == key(cand + m + 4)
            m += (8 if eq1 else 4) if eq0 else 0
            go = eq0 and eq1
        if go and at + m + 4 <= n and key(at + m) == key(cand + m):
            m += 4
    elif ext in (EXT_8U, EXT_8S2):
        eq0l = True
        while go and at + m + 8 <= n:
            steps += 1
            seed(at + m - 3)
            if ext == EXT_8S2:
                seed(at + m + 1)
            eq0 = key(at + m) == key(cand + m)
            go = eq0 and key(at + m + 4) == key(cand + m + 4)
            m += 8
            eq0l = eq0
        if not go:
            m = m - 8 + (4 if eq0l else 0)
        if go and at + m + 4 <= n and key(at + m) == key(cand + m):
            m += 4
    else:  # EXT_16U
        e0 = e01 = e012 = True
        while go and at + m + 16 <= n:
            steps += 1
            seed(at + m - 3)
            seed(at + m + 5)
            e0 = key(at + m) == key(cand + m)
            e01 = e0 and key(at + m + 4) == key(cand + m + 4)
            e012 = e01 and key(at + m + 8) == key(cand + m + 8)
            go = e012 and key(at + m + 12) == key(cand + m + 12)
            m += 16
        if not go:
            m = m - 16 + 4 * (e0 + e01 + e012)
        else:
            while go and at + m + 4 <= n:
                go = key(at + m) == key(cand + m)
                m += 4
                steps += 1
            if not go:
                m -= 4
    return m, steps


def _walk_row(row: np.ndarray, n: int, mask: int, hash_bits: int, store_step: int,
              stats: list | None = None):
    """One fragment's walk; mirrors ``sc::encode_fragment_variant``. Returns
    ``(body bytes, body_len)``; without emission the bytes are empty. A
    ``stats`` list of four counts gains the walk's miss iterations, hits,
    extension iterations and matched bytes (``sc::WalkStats``)."""
    stats = [0, 0, 0, 0] if stats is None else stats
    if mask & DMA_ONLY:
        return b"", n
    if mask & NOSCAN:
        return b"", 0
    s, keys_np = _staged_keys(row, n)
    hashes = (((keys_np * HASH_MUL) & _U32) >> (32 - hash_bits)).tolist()
    keys = keys_np.tolist()
    key = keys.__getitem__
    table = [_EMPTY] * (1 << hash_bits)
    em = _Emitter(s)
    oct_ = bool(mask & OCT)
    width = 8 if mask & (PROBE8 | OCT) else 4
    stores = range(0, width, 1 if oct_ else store_step)
    margin = INPUT_MARGIN_BYTES + (4 if oct_ else 0)
    miss_adv = width if mask & ADV4 else width - 1
    hits = 0

    def seed(pos):
        p = min(pos, n - 5)
        table[hashes[p]] = p

    ip, lit_start, skip = min(1, n), 0, 32
    while ip + margin < n:
        cur = keys[ip : ip + width]
        hs = hashes[ip : ip + width]
        ent = [table[h] for h in hs]
        for d in stores:
            table[hs[d]] = ip + d
        hit = None
        for d in range(width):
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
            ip += 6 + 2 * (skip >> 5) if oct_ else miss_adv + (skip >> 5)
            skip += 2 if oct_ else 1
            stats[0] += 1
            continue
        at, cand = hit
        m, steps = _extend(mask, key, seed, at, cand, n)
        if mask & XOR_TAIL:
            x = key(at + m) ^ key(cand + m)
            m += 3 if x == 0 else (x & 0xFF == 0) + (x & 0xFFFF == 0) + (x & 0xFFFFFF == 0)
        else:
            t = 0
            while t < 3 and at + m < n and s[at + m] == s[cand + m]:
                m, t = m + 1, t + 1
        m = min(m, n - at)
        end = at + m
        hits += 1
        stats[1:] = [stats[1] + 1, stats[2] + steps, stats[3] + m]
        if not mask & EMIT_HITS:
            em.literal(lit_start, at)
            em.copy(at - cand, m)
        if mask & POST_SEED:
            for p in range(at + 1, min(end, n - 4) - 2, 4):
                seed(p)
        ip = lit_start = end
        skip = 32
    if mask & EMIT_HITS:
        return b"", 2 * hits
    em.literal(lit_start, n)
    if mask & EMIT_COUNT:
        return b"", len(em.out)
    return bytes(em.out), len(em.out)


def encode_walk_plain(frags: torch.Tensor, lengths: torch.Tensor, mask: int, hash_bits: int,
                      store_step: int):
    """Plain version of the ablation kernels on CPU uint8 rows: returns
    ``(bodies uint8[B, F + 2048], body_lens int32[B])``."""
    B, F = frags.shape
    rows = frags.numpy()
    lens = lengths.tolist()
    bodies = np.zeros((B, F + 2048), np.uint8)
    body_lens = np.zeros(B, np.int32)
    for b in range(B):
        body, body_lens[b] = _walk_row(rows[b], min(max(lens[b], 0), F), mask, hash_bits,
                                       store_step)
        bodies[b, : len(body)] = np.frombuffer(body, np.uint8)
    return torch.from_numpy(bodies), torch.from_numpy(body_lens)


def _encode(frags, lengths, source: str, counter: str, mask: int, hash_bits: int,
            store_step: int):
    frags = byte_rows(frags, "frags")
    B, F = frags.shape
    lengths = lengths_vector(lengths, B, "lengths")
    if not 0 < F <= BLOCK_SIZE:
        raise ValueError(f"fragment width must be in (0, {BLOCK_SIZE}], got {F}")
    if not on_cuda(frags, lengths):
        return encode_walk_plain(frags, lengths, mask, hash_bits, store_step)
    W = F + 2048
    bodies = torch.empty((B, W), dtype=torch.uint8, device=frags.device)
    body_lens = torch.empty(B, dtype=torch.int32, device=frags.device)
    _build.launch(
        source, frags.device, mask, hash_bits, store_step, frags.data_ptr(), F,
        lengths.data_ptr(), B, bodies.data_ptr(), W, body_lens.data_ptr(), count_as=counter,
    )
    return bodies, body_lens


def encode_variant(frags, lengths, flags: tuple = ()):
    """The greedy walk under a flag tuple
    (``tools/perf_probe_enc.py::encode_variant``); the empty tuple is the
    walk that the flags vary."""
    mask, hash_bits, store_step = flags_mask(tuple(flags))
    return _encode(frags, lengths, "encode_variants", "encode_variant", mask, hash_bits,
                   store_step)


def encode_variant_layout(frags, flags: tuple = ()) -> dict:
    """The launch layout of :func:`encode_variant` under ``flags`` for these
    rows on their CUDA device: ``blocks_per_sm`` (the CUDA occupancy
    calculator's count under the attributes the launch sets), ``smem_bytes``
    (the match table), ``threads`` and ``loader`` (``"words"`` for a base and
    width that are multiples of 16, else ``"bytes"``)."""
    return _layout("encode_variant_layout", byte_rows(frags, "frags"), *flags_mask(tuple(flags)))


def encode_variant_plain(frags: torch.Tensor, lengths: torch.Tensor, flags: tuple = ()):
    """Plain version of :func:`encode_variant` on CPU uint8 rows."""
    return encode_walk_plain(frags, lengths, *flags_mask(tuple(flags)))


def _r4_mask(variant: str) -> int:
    if variant not in R4_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {sorted(R4_VARIANTS)}")
    return R4_VARIANTS[variant]


def encode_r4(frags, lengths, variant: str = "encpre"):
    """The production walk in a named restructuring
    (``tools/perf_probe_r4.py::encode_r4``)."""
    return _encode(frags, lengths, "encode_r4", "encode_r4", _r4_mask(variant), HASH_BITS, 1)


def encode_r4_layout(frags, variant: str = "encpre") -> dict:
    """The launch layout of :func:`encode_r4` for ``variant`` on these rows,
    as :func:`encode_variant_layout` gives it."""
    return _layout("encode_r4_layout", byte_rows(frags, "frags"), _r4_mask(variant), HASH_BITS, 1)


def encode_r4_plain(frags: torch.Tensor, lengths: torch.Tensor, variant: str = "encpre"):
    """Plain version of :func:`encode_r4` on CPU uint8 rows."""
    return encode_walk_plain(frags, lengths, _r4_mask(variant), HASH_BITS, 1)


def encode_stats_plain(frags: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`encode_stats` on CPU uint8 rows."""
    B, F = frags.shape
    rows = frags.numpy()
    lens = lengths.tolist()
    stats = np.zeros((B, 4), np.int32)
    for b in range(B):
        st = [0, 0, 0, 0]
        _walk_row(rows[b], min(max(lens[b], 0), F), STATS_MASK, HASH_BITS, 1, st)
        stats[b] = st
    return torch.from_numpy(stats)


def encode_stats(frags, lengths) -> torch.Tensor:
    """The encoder's budget per fragment (``tools/perf_probe_r4.py::
    encode_stats``): int32 [B, 4] of miss iterations, hits, extension
    iterations and matched bytes of the walk of :data:`STATS_MASK`."""
    frags = byte_rows(frags, "frags")
    B, F = frags.shape
    lengths = lengths_vector(lengths, B, "lengths")
    if not 0 < F <= BLOCK_SIZE:
        raise ValueError(f"fragment width must be in (0, {BLOCK_SIZE}], got {F}")
    if not on_cuda(frags, lengths):
        return encode_stats_plain(frags, lengths)
    stats = torch.empty((B, 4), dtype=torch.int32, device=frags.device)
    _build.launch("encode_stats", frags.device, frags.data_ptr(), F, lengths.data_ptr(), B,
                  stats.data_ptr())
    return stats


def encode_stats_layout(frags) -> dict:
    """The launch layout of :func:`encode_stats` for these rows, as
    :func:`encode_variant_layout` gives it."""
    return _layout("encode_stats_layout", byte_rows(frags, "frags"))
