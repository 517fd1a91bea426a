"""Vectorized Snappy block decoder: the parallel-scan engine's decode side
(port of ``snappier_tpu/ops/decode.py``), and the decoders' error words.

The decoder re-derives the wire semantics as three data-parallel passes
over the whole compressed row:

1. **Speculative tag parse**: for every byte position, the fields of the
   tag that would start there (advance, output length, copy offset,
   literal source). Elementwise integer arithmetic.
2. **Tag-boundary resolution**: the real tag starts are the orbit of
   ``next(p) = p + advance(p)`` from the end of the varint preamble,
   resolved by pointer doubling in O(log n) gather and scatter rounds that
   also accumulate suffix sums of the output lengths, which give every
   tag's output offset.
3. **Output materialization**: each output byte's provenance is a pointer:
   a literal byte points (negated) into the compressed input, a copied
   byte at an earlier output byte. Chains of copies, overlapping ones
   included, collapse in O(log n) rounds of path halving, and one gather
   from the input produces the output.

This is tensor code (``gather``, ``scatter_reduce``, ``cummax``), the same
on the CPU and on the card, as the JAX package leaves these passes to XLA;
the batch dimension that the JAX codec loops over with ``lax.map`` is
written out. Values stay int32, so that sums of poisoned lengths wrap on
corrupt input exactly as the reference's do and the error words agree;
only index tensors are int64.

Error words: this decoder reports each failure as its own bit
(``ERR_TRUNCATED_TAG``, ``ERR_BAD_OFFSET``, ``ERR_LENGTH_MISMATCH``,
``ERR_BAD_PREAMBLE``, which can be OR-ed). The scalar decode kernel
(:mod:`snappier_tpu_torch.ops.cuda.scalar_codec`) reports every mid-stream
failure as ``ERR_MALFORMED``, the OR of the first three.
"""

from __future__ import annotations

import torch

from snappier_tpu_torch.constants import (
    MAX_SHORT_LITERAL,
    TAG_COPY1,
    TAG_COPY2,
    TAG_LITERAL,
)

ERR_TRUNCATED_TAG = 1  # a tag (or its literal payload) overruns the input
ERR_BAD_OFFSET = 2  # copy offset of zero or beyond produced output
ERR_LENGTH_MISMATCH = 4  # tag stream output != varint preamble claim
ERR_BAD_PREAMBLE = 8  # malformed/oversized varint preamble

#: The combined word of a failed tag walk (the scalar kernels).
ERR_MALFORMED = ERR_TRUNCATED_TAG | ERR_BAD_OFFSET | ERR_LENGTH_MISMATCH

#: "Impossibly large" length that poisons fields of more than 31 bits, so
#: that they trip the bounds checks.
_HUGE = 1 << 28

#: Rows decoded at a time. The passes hold some twenty [rows, width]
#: tensors, several of them int64; 128 rows of a 64 KiB block keep that
#: below 2 GiB whatever the batch.
SLAB_ROWS = 128


def _log2_ceil(n: int) -> int:
    return max(1, (n - 1).bit_length())


def scatter_amax_drop(size: int, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Row-wise ``out[b, idx[b, i]] = max(out[b, idx[b, i]], src[b, i])``
    into ``size`` zeroed slots, dropping out-of-range indices as the
    reference's ``.at[idx].max(mode="drop")`` does: a negative index counts
    from the end first, and what is still outside is dropped. The dropped
    updates land in one extra slot that is cut off."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + size, idx)
    idx = torch.where((idx < 0) | (idx >= size), size, idx)
    out = src.new_zeros((src.shape[0], size + 1))
    out.scatter_reduce_(1, idx, src, "amax", include_self=True)
    return out[:, :size]


def parse_varint_device(comp: torch.Tensor):
    """Parse the LEB128 length preamble from the first 5 bytes of each row
    of ``comp`` (int32 [B, >= 5]).

    Returns ``(value, nbytes, err)`` as int32 [B]. Mirrors
    VarIntEncoding.Read.cs:26-91 including 5-byte/u32 strictness."""
    b = [comp[:, i] for i in range(5)]
    cont = [x >= 128 for x in b]
    n = torch.where(
        ~cont[0], 1,
        torch.where(~cont[1], 2, torch.where(~cont[2], 3, torch.where(~cont[3], 4, 5))),
    ).to(torch.int32)
    use = [n > i for i in range(5)]
    val = b[0] & 0x7F
    val = val + torch.where(use[1], (b[1] & 0x7F) << 7, 0)
    val = val + torch.where(use[2], (b[2] & 0x7F) << 14, 0)
    val = val + torch.where(use[3], (b[3] & 0x7F) << 21, 0)
    # Byte 5 holds bits 28..31; >= 8 overflows u32, and any value >= 2^28
    # overflows the int32 pipeline: poison instead of wrapping.
    big5 = use[4] & (b[4] > 0)
    val = torch.where(big5, _HUGE, val).to(torch.int32)
    err = torch.where((n == 5) & (b[4] >= 8), ERR_BAD_PREAMBLE, 0)
    err = err | torch.where(val < 0, ERR_BAD_PREAMBLE, 0)
    return val, n, err.to(torch.int32)


def _speculative_parse(c0, c1, c2, c3, c4):
    """Per-position tag fields, assuming a tag starts at each byte (wire
    law per Constants.cs:18-41, SnappyDecompressor.cs:254-340)."""
    tag_type = c0 & 3
    len6 = c0 >> 2

    # Literal: inline payload follows the (1 + extra)-byte descriptor.
    lit_extra = torch.where(len6 < MAX_SHORT_LITERAL, 0, len6 - 59)
    lit_len_long = (
        c1
        + torch.where(lit_extra >= 2, c2 << 8, 0)
        + torch.where(lit_extra >= 3, c3 << 16, 0)
    )
    # A 4th length byte pushes past 2^24; any nonzero value exceeds the
    # 2^28 pipeline cap, so poison rather than overflow int32.
    lit_big = (lit_extra == 4) & (c4 > 0)
    lit_len = torch.where(lit_extra == 0, len6 + 1, lit_len_long + 1)
    lit_len = torch.where(lit_big, _HUGE, lit_len)

    copy1_len = ((c0 >> 2) & 7) + 4
    copy1_off = ((c0 >> 5) << 8) | c1
    copy2_len = len6 + 1
    copy2_off = c1 | (c2 << 8)
    copy4_off = c1 | (c2 << 8) | (c3 << 16)
    copy4_off = torch.where(c4 > 0, _HUGE, copy4_off)  # > 2^24 can't be valid

    is_literal = tag_type == TAG_LITERAL
    is_c1 = tag_type == TAG_COPY1
    is_c2 = tag_type == TAG_COPY2
    out_len = torch.where(is_literal, lit_len, torch.where(is_c1, copy1_len, copy2_len))
    copy_hdr = torch.where(is_c1, 2, torch.where(is_c2, 3, 5)).to(torch.int32)
    advance = torch.where(is_literal, 1 + lit_extra + lit_len, copy_hdr)
    offset = torch.where(is_c1, copy1_off, torch.where(is_c2, copy2_off, copy4_off))
    lit_src = 1 + lit_extra  # literal payload offset relative to the tag
    return is_literal, out_len, advance, offset, lit_src


def _decode_slab(comp: torch.Tensor, n: torch.Tensor, out_cap: int):
    """:func:`decode_blocks_scan` on int32 rows [B, CC] and int32 lengths [B]."""
    B, CC = comp.shape
    dev = comp.device
    cpad = torch.nn.functional.pad(comp, (0, 8))

    expected, pre_len, err = parse_varint_device(cpad)
    err = err | torch.where(expected > out_cap, ERR_BAD_PREAMBLE, 0)
    err = err | torch.where(pre_len > n, ERR_BAD_PREAMBLE, 0)

    # Shifted views c0..c4 (c_k[p] = comp[p + k], zero past the end).
    c0, c1, c2, c3, c4 = (cpad[:, k : k + CC] for k in range(5))
    is_literal, out_len_at, advance, offset, lit_rel = _speculative_parse(c0, c1, c2, c3, c4)

    pos = torch.arange(CC, dtype=torch.int32, device=dev)[None, :]
    nn = n[:, None]
    in_body = pos < nn
    raw_next = pos + advance.clamp(max=_HUGE)

    # Sentinel-extended (width CC + 1) jump and suffix-sum tables.
    sentinel = CC
    nxt = torch.where(in_body & (raw_next <= nn), raw_next, sentinel)
    nxt = torch.nn.functional.pad(nxt, (0, 1), value=sentinel)
    tail = torch.nn.functional.pad(torch.where(in_body, out_len_at, 0), (0, 1))

    # Reachability from the body's start and suffix sums, by pointer
    # doubling. A jump past the sentinel (a length beyond the row's width)
    # clamps to it on the gathers and lands in it on the scatter, where it
    # marks nothing that is read.
    reach = (torch.arange(CC + 1, dtype=torch.int32, device=dev)[None, :]
             == pre_len[:, None]).to(torch.int32)
    for _ in range(_log2_ceil(CC + 1)):
        idx = nxt.long().clamp(0, CC)
        reach = reach.scatter_reduce(1, idx, reach, "amax", include_self=True)
        tail = tail + tail.gather(1, idx)
        nxt = nxt.gather(1, idx)
    is_tag = (reach[:, :CC] > 0) & in_body

    total_out = tail.gather(1, pre_len[:, None].long().clamp(0, CC))
    out_start = total_out - tail[:, :CC]  # valid where is_tag

    def flag(cond, bit):
        return torch.where(cond.any(dim=1), bit, 0)

    err = err | flag(is_tag & (raw_next > nn), ERR_TRUNCATED_TAG)
    err = err | flag(is_tag & ~is_literal & ((offset == 0) | (offset > out_start)),
                     ERR_BAD_OFFSET)
    err = err | torch.where(total_out[:, 0] != expected, ERR_LENGTH_MISMATCH, 0)

    # --- Output materialization ------------------------------------------
    # Covering tag per output byte: scatter tag positions at their output
    # offsets, then a running max.
    scatter_idx = torch.where(is_tag, out_start, out_cap)
    cover = scatter_amax_drop(out_cap, scatter_idx, (pos + 1).expand(B, CC).contiguous())
    cover = (torch.cummax(cover, dim=1).values - 1).clamp(0, CC - 1).long()

    q = torch.arange(out_cap, dtype=torch.int32, device=dev)[None, :]
    j = q - out_start.gather(1, cover)  # byte index within the covering tag
    tag_is_lit = is_literal.gather(1, cover)
    # Provenance pointer: literals resolve (negative encoding of an input
    # index); copies point at an earlier output byte.
    lit_ptr = -(cover.to(torch.int32) + lit_rel.gather(1, cover) + j) - 1
    copy_ptr = q - offset.gather(1, cover)
    ptr = torch.where(tag_is_lit, lit_ptr, copy_ptr.clamp(min=0))
    in_out = q < expected[:, None]
    ptr = torch.where(in_out, ptr, -1)

    for _ in range(_log2_ceil(out_cap)):
        hop = ptr.gather(1, ptr.long().clamp(0, out_cap - 1))
        ptr = torch.where(ptr >= 0, hop, ptr)

    src = (-ptr - 1).long().clamp(0, CC - 1)
    out = torch.where(in_out, comp.gather(1, src), 0)
    return out, expected, err.to(torch.int32)


def decode_blocks_scan(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int):
    """Decode a batch of Snappy blocks with the scan engine.

    Args:
      comp: [B, CC] int32 or uint8 compressed bytes (varint preamble + tag
        stream) on any device. As in the reference, a row must be
        zero-padded past its length wherever a tag may straddle the end,
        and CC should be at least the longest length + 8.
      comp_lens: [B] actual compressed lengths.
      out_cap: output capacity; a preamble claiming more sets
        ``ERR_BAD_PREAMBLE``.

    Returns ``(out int32 [B, out_cap], out_len int32 [B], err int32 [B])``
    on ``comp``'s device: the decoded bytes (zero past the claimed length),
    the length the preamble claims (whatever ``err`` says, as in the
    reference) and the error word (0 = success).
    """
    if comp.dim() != 2 or comp_lens.shape != (comp.shape[0],):
        raise ValueError("comp must be [B, CC] and comp_lens [B]")
    out_cap = int(out_cap)
    lens = comp_lens.to(device=comp.device, dtype=torch.int32)
    parts = [
        _decode_slab(comp[lo : lo + SLAB_ROWS].to(torch.int32), lens[lo : lo + SLAB_ROWS], out_cap)
        for lo in range(0, comp.shape[0], SLAB_ROWS)
    ]
    if not parts:
        z = torch.zeros(0, dtype=torch.int32, device=comp.device)
        return z.new_zeros((0, out_cap)), z, z.clone()
    return tuple(torch.cat(p) for p in zip(*parts))


def decode_block(comp: torch.Tensor, comp_len, out_cap: int):
    """Decode one Snappy block: :func:`decode_blocks_scan` on a single row.

    ``comp`` is int32 or uint8 [comp_cap], ``comp_len`` a scalar. Returns
    ``(out int32 [out_cap], out_len, err)`` with 0-d tensors for the last
    two."""
    n = torch.as_tensor(comp_len, device=comp.device).reshape(1)
    out, out_len, err = decode_blocks_scan(comp[None, :], n, out_cap)
    return out[0], out_len[0], err[0]
