"""Vectorized Snappy block encoder: the parallel-scan engine's encode side
(port of ``snappier_tpu/ops/encode.py``).

Compressed bytes are an encoder's choice; the contract is that the output
decodes bit-exactly and is no larger than the greedy hash-table encoder's.
This encoder derives a greedy parse as data-parallel passes over a whole
fragment:

1. **Exact match candidates**: a stable sort by (4-byte key, position)
   makes each position's nearest previous occurrence its left neighbour in
   sort order; rank doubling (four more sorts on rank pairs) builds the
   8/16/32/64-byte groups, and the candidate of the widest non-empty group
   wins.
2. **Match lengths**: extended 4 bytes a step by comparing the key array
   at stride 4 (15 gathers), refined to byte granularity (3 gathers),
   capped at 64, the longest copy.
3. **Greedy cover**: the token chain ``next(p) = p + len(p)`` (match) or
   ``p + 1`` (literal byte), resolved by pointer doubling.
4. **Emission**: maximal literal runs merged by position; tag sizes
   prefix-summed into output offsets; bytes materialized through a scatter
   and a running-max cover map, one select per output byte.

This is tensor code (``sort``, ``gather``, ``scatter_reduce``, ``cumsum``,
``cummax``), the same on the CPU and on the card, as the JAX package
leaves these passes to XLA; the batch dimension that the JAX codec loops
over with ``lax.map`` is written out. Every gather index that the
reference clamps is clamped to the same bound here, into the fragment and
not into its padding, because the emitted bytes depend on it: they equal
the reference's byte for byte.

Output is the fragment *body* (no varint preamble).
"""

from __future__ import annotations

import torch

from snappier_tpu_torch.constants import (
    BLOCK_SIZE,
    FRAGMENT_OUT_CAP,
    MAX_COPY1_LENGTH,
    MAX_COPY1_OFFSET,
    MAX_COPY_LENGTH,
    MAX_SHORT_LITERAL,
    MIN_MATCH_LENGTH,
    TAG_COPY1,
    TAG_COPY2,
    greedy_emit_bound,
)
from snappier_tpu_torch.ops.decode import SLAB_ROWS, _log2_ceil, scatter_amax_drop

#: Per-fragment output-slot headroom beyond the fragment size: it covers
#: ``greedy_emit_bound`` with about 1 KiB to spare.
FRAGMENT_SLACK = FRAGMENT_OUT_CAP - BLOCK_SIZE
assert greedy_emit_bound(BLOCK_SIZE) + 8 < FRAGMENT_OUT_CAP

_KEY_STEPS = 15  # 15 * 4 = 60 bytes of stride-4 extension beyond the seed 4


def _group_candidates(eq_prev: torch.Tensor, pos_sorted: torch.Tensor) -> torch.Tensor:
    """Per position, the nearest previous member of its sort group (-1 for
    none); ``pos_sorted`` is int64 [B, F], a permutation per row."""
    prev = torch.full_like(pos_sorted, -1)
    prev[:, 1:] = torch.where(eq_prev[:, 1:], pos_sorted[:, :-1], -1)
    return torch.empty_like(prev).scatter_(1, pos_sorted, prev)


def _ranks(eq_prev: torch.Tensor, pos_sorted: torch.Tensor) -> torch.Tensor:
    """Per position, the number of its sort group (1-based, in sort order)."""
    rank_sorted = torch.cumsum(~eq_prev, dim=1)
    return torch.empty_like(rank_sorted).scatter_(1, pos_sorted, rank_sorted)


def _encode_slab(data: torch.Tensor, n: torch.Tensor):
    """:func:`encode_blocks_scan` on int32 rows [B, F] and int32 lengths [B]."""
    B, F = data.shape
    dev = data.device
    pos = torch.arange(F, dtype=torch.int32, device=dev)[None, :]
    pos64 = pos.long()
    nn = n[:, None]

    # --- 1. candidates via rank doubling (widths 4, 8, 16, 32, 64) -------
    # One stable sort per level. Level 0 sorts the 4-byte key; the later
    # levels sort the pair (rank, rank `half` bytes on) as one int64 key,
    # which groups the same positions as the reference's two-key sort:
    # only equality of neighbours and the position order inside a group
    # reach the result, not the order of the groups.
    d = torch.nn.functional.pad(data.long(), (0, 4))
    key64 = d[:, 0:F] | (d[:, 1 : F + 1] << 8) | (d[:, 2 : F + 2] << 16) | (d[:, 3 : F + 3] << 24)
    key = (((key64 + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)
    del d
    sk, pos_sorted = torch.sort(key64, dim=1, stable=True)
    eq_prev = torch.zeros((B, F), dtype=torch.bool, device=dev)
    eq_prev[:, 1:] = sk[:, 1:] == sk[:, :-1]
    cand = _group_candidates(eq_prev, pos_sorted)
    rank = _ranks(eq_prev, pos_sorted)
    for half in (4, 8, 16, 32):
        # The rank `half` bytes on; past the fragment a negative value
        # unique to the position, so that such positions pair with nothing.
        ahead = rank[:, (pos64[0] + half).clamp(max=F - 1)]
        tail_rank = torch.where(pos64 + half < F, ahead, -(pos64 + 2))
        sk, pos_sorted = torch.sort(rank * (1 << 32) + (tail_rank & 0xFFFFFFFF), dim=1,
                                    stable=True)
        eq_prev[:, 1:] = sk[:, 1:] == sk[:, :-1]
        c = _group_candidates(eq_prev, pos_sorted)
        cand = torch.where(c >= 0, c, cand)  # the widest level wins
        rank = _ranks(eq_prev, pos_sorted)
    del sk, pos_sorted, eq_prev, rank, key64

    has_key = pos + MIN_MATCH_LENGTH <= nn
    has_match = has_key & (cand >= 0)
    cand = cand.clamp(0, F - 1)  # int64: it indexes the gathers below

    # --- 2. match lengths: stride-4 key compares + byte refinement -------
    extend_ok = torch.ones((B, F), dtype=torch.bool, device=dev)
    base = torch.full((B, F), MIN_MATCH_LENGTH, dtype=torch.int32, device=dev)
    for j in range(_KEY_STEPS):
        at = MIN_MATCH_LENGTH + 4 * j
        here = key[:, (pos64[0] + at).clamp(max=F - 1)]
        there = key.gather(1, (cand + at).clamp(max=F - 1))
        extend_ok = extend_ok & (here == there)
        base = base + torch.where(extend_ok, 4, 0).to(torch.int32)
    # Byte-level refinement of the first failing 4-byte step.
    ref_ok = base < MAX_COPY_LENGTH
    for _ in range(3):
        b64 = base.long()
        step_ok = ref_ok & (
            data.gather(1, (pos64 + b64).clamp(max=F - 1))
            == data.gather(1, (cand + b64).clamp(max=F - 1))
        )
        base = base + step_ok.to(torch.int32)
        ref_ok = step_ok
    mlen = torch.minimum(base.clamp(max=MAX_COPY_LENGTH), nn - pos)
    has_match = has_match & (mlen >= MIN_MATCH_LENGTH)
    offset = pos - torch.where(has_match, cand.to(torch.int32), 0)
    # Marginal-match rejection: a 4-byte match that needs a copy-2 tag saves
    # 1 byte over literal bytes but usually costs a fresh literal tag right
    # after it.
    has_match = has_match & ~((mlen == MIN_MATCH_LENGTH) & (offset >= MAX_COPY1_OFFSET))
    del key, cand, base, extend_ok, ref_ok

    # --- 3. greedy token cover by pointer doubling -----------------------
    sentinel = F
    step = torch.where(has_match, mlen, 1)
    nxt = torch.where(pos < nn, torch.minimum(pos + step, nn), sentinel)
    nxt = torch.where(nxt >= nn, sentinel, nxt)
    nxt = torch.nn.functional.pad(nxt, (0, 1), value=sentinel).long()
    reach = torch.zeros((B, F + 1), dtype=torch.int32, device=dev)
    reach[:, 0] = 1
    for _ in range(_log2_ceil(F + 1)):
        reach = reach.scatter_reduce(1, nxt, reach, "amax", include_self=True)
        nxt = nxt.gather(1, nxt)
    is_token = (reach[:, :F] > 0) & (pos < nn)
    is_copy = is_token & has_match
    is_lit = is_token & ~has_match
    del nxt, reach, step

    # --- 4. literal-run merge (positional) -------------------------------
    run_start = is_lit.clone()
    run_start[:, 1:] &= ~is_lit[:, :-1]
    # Next copy-token position at or after p (reverse running min).
    ncp = torch.where(is_copy, pos, F).flip(1).cummin(dim=1).values.flip(1)
    run_len = torch.minimum(ncp, nn) - pos  # valid at run_start positions

    lit_extra = torch.where(
        run_len > MAX_SHORT_LITERAL, torch.where(run_len <= 256, 1, 2), 0
    ).to(torch.int32)
    size_lit = 1 + lit_extra + run_len
    use_copy1 = (mlen <= MAX_COPY1_LENGTH) & (offset < MAX_COPY1_OFFSET)
    size_copy = torch.where(use_copy1, 2, 3).to(torch.int32)
    emit = run_start | is_copy
    size = torch.where(is_copy, size_copy, torch.where(run_start, size_lit, 0))

    out_off = torch.cumsum(size, dim=1, dtype=torch.int32) - size  # exclusive prefix sum
    total = out_off[:, -1] + size[:, -1]

    # --- 5. byte materialization -----------------------------------------
    out_cap = F + FRAGMENT_SLACK
    scatter_idx = torch.where(emit, out_off, out_cap)
    cover = scatter_amax_drop(out_cap, scatter_idx, (pos + 1).expand(B, F).contiguous())
    cover = (torch.cummax(cover, dim=1).values - 1).clamp(0, F - 1).long()

    q = torch.arange(out_cap, dtype=torch.int32, device=dev)[None, :]
    j = q - out_off.gather(1, cover)
    cp = is_copy.gather(1, cover)
    ln = mlen.gather(1, cover)
    dist = offset.gather(1, cover)
    c1 = use_copy1.gather(1, cover)
    tag_c1 = TAG_COPY1 | ((ln - 4) << 2) | ((dist >> 8) << 5)
    tag_c2 = TAG_COPY2 | ((ln - 1) << 2)
    v_copy = torch.where(
        j == 0,
        torch.where(c1, tag_c1, tag_c2),
        torch.where(j == 1, dist & 0xFF, (dist >> 8) & 0xFF),
    )
    L1 = run_len.gather(1, cover) - 1
    e = lit_extra.gather(1, cover)
    tag_lit = torch.where(e == 0, L1 << 2, (59 + e) << 2)
    v_lenbyte = torch.where(j == 1, L1 & 0xFF, (L1 >> 8) & 0xFF)
    v_data = data.gather(1, (cover + (j - 1 - e)).clamp(0, F - 1))
    v_lit = torch.where(j == 0, tag_lit, torch.where(j <= e, v_lenbyte, v_data))
    out = torch.where(q < total[:, None], torch.where(cp, v_copy, v_lit), 0)
    return out, total


def encode_blocks_scan(data: torch.Tensor, lengths: torch.Tensor):
    """Compress a batch of fragments with the scan engine.

    Args:
      data: [B, F] int32 or uint8 byte values on any device, zero-padded
        past each length, for any fragment width F <= BLOCK_SIZE (the
        format's offset window).
      lengths: [B], 0 <= length <= F.

    Returns ``(out int32 [B, F + FRAGMENT_SLACK], out_len int32 [B])`` on
    ``data``'s device: the tag-stream bytes (zero past each length) and
    the compressed body lengths.
    """
    if data.dim() != 2 or lengths.shape != (data.shape[0],):
        raise ValueError("data must be [B, F] and lengths [B]")
    F = data.shape[1]
    if not 0 < F <= BLOCK_SIZE:
        raise ValueError(f"fragment width must be in (0, {BLOCK_SIZE}], got {F}")
    lens = lengths.to(device=data.device, dtype=torch.int32)
    parts = [
        _encode_slab(data[lo : lo + SLAB_ROWS].to(torch.int32), lens[lo : lo + SLAB_ROWS])
        for lo in range(0, data.shape[0], SLAB_ROWS)
    ]
    if not parts:
        z = torch.zeros(0, dtype=torch.int32, device=data.device)
        return z.new_zeros((0, F + FRAGMENT_SLACK)), z
    return tuple(torch.cat(p) for p in zip(*parts))


def encode_block(data: torch.Tensor, length):
    """Compress one fragment: :func:`encode_blocks_scan` on a single row.

    ``data`` is int32 or uint8 [F], ``length`` a scalar. Returns
    ``(out int32 [F + FRAGMENT_SLACK], out_len)`` with a 0-d length."""
    n = torch.as_tensor(length, device=data.device).reshape(1)
    out, out_len = encode_blocks_scan(data[None, :], n)
    return out[0], out_len[0]
