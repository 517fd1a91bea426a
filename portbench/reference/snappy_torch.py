"""Snappy tag streams decoded in plain PyTorch tensor operations: the
reference that decides whether a run's outputs are correct.

It is written from the format's description and shares no code with the
program under test. Every operation is a stock tensor operation (gathers,
scatters, cumulative sums, ``searchsorted``), so it runs the same on the
CPU and on the card, and a batch of rows decodes at once:

1. Each byte of a row is read as if a tag started there: its header size,
   the bytes it produces, its copy offset, and the position of the tag
   after it.
2. The tags that really start are those reached from position 0 by
   following "next tag" links; pointer doubling marks them in
   ``log2(width)`` rounds. A stream is whole when a tag ends exactly at
   its length.
3. Each output byte finds its tag by ``searchsorted`` over the running sum
   of produced bytes. A literal byte names its source in the stream; a copy
   byte names the output byte ``offset`` before it, and pointer doubling
   over those names resolves every copy to the literal byte it repeats.

A row is valid when its tags tile its stream exactly, every copy offset is
1 or more and reaches no further back than the output written so far, and
the output length equals the expected one.
"""

from __future__ import annotations

import torch


def _rounds(n: int) -> int:
    """Pointer-doubling rounds that cover chains of up to ``n`` links."""
    return max(1, int(n).bit_length())


def decode_bodies(comp: torch.Tensor, body_lens: torch.Tensor, out_lens: torch.Tensor,
                  out_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode tag streams (no preamble) row by row.

    Args:
      comp: uint8 [R, C], each row a tag stream; bytes past its length are
        ignored.
      body_lens: [R] stream lengths, 0..C.
      out_lens: [R] lengths each stream must decode to, 0..out_cap.
      out_cap: width of the output rows.

    Returns ``(out uint8 [R, out_cap], ok bool [R])``; a row's output is
    meaningful only where ``ok``.
    """
    dev = comp.device
    R, C = comp.shape
    blen = body_lens.to(device=dev, dtype=torch.int64)
    olen_exp = out_lens.to(device=dev, dtype=torch.int64)
    pad = torch.nn.functional.pad(comp.to(torch.int64), (0, 5))
    b0, b1, b2, b3, b4 = (pad[:, k : k + C] for k in range(5))
    kind = b0 & 3
    l6 = b0 >> 2

    # 1. every position read as a tag
    extra = (l6 - 59).clamp(0, 4)  # literal length bytes, 1..4 where l6 >= 60
    ext_len = torch.where(extra == 1, b1, torch.where(
        extra == 2, b1 | (b2 << 8), torch.where(
            extra == 3, b1 | (b2 << 8) | (b3 << 16), b1 | (b2 << 8) | (b3 << 16) | (b4 << 24))))
    lit_n = torch.where(l6 < 60, l6 + 1, ext_len + 1)
    hdr = torch.where(kind == 0, 1 + extra, torch.where(kind == 1, 2, torch.where(kind == 2, 3, 5)))
    produced = torch.where(kind == 0, lit_n, torch.where(kind == 1, ((b0 >> 2) & 7) + 4, l6 + 1))
    offset = torch.where(kind == 1, ((b0 >> 5) << 8) | b1, torch.where(
        kind == 2, b1 | (b2 << 8), b1 | (b2 << 8) | (b3 << 16) | (b4 << 24)))
    pos = torch.arange(C, device=dev, dtype=torch.int64)[None, :]
    inside = pos < blen[:, None]
    nxt = pos + hdr + torch.where(kind == 0, lit_n, 0)
    # columns: 0..C positions (C is the end of a full-width stream), C + 1
    # a tag that ends past the row, C + 2 a sink for unmarked scatters
    nxt = torch.where(inside, nxt.clamp(max=C + 1), pos)
    tail = torch.arange(C, C + 3, device=dev, dtype=torch.int64).expand(R, 3)
    jump = torch.cat([nxt, tail], dim=1)

    # 2. the tags reached from 0
    mark = torch.zeros((R, C + 3), dtype=torch.bool, device=dev)
    mark[:, 0] = True
    sink = torch.full_like(jump, C + 2)
    for _ in range(_rounds(C + 1)):
        mark.scatter_(1, torch.where(mark, jump, sink), True)
        jump = jump.gather(1, jump)
    whole = mark.gather(1, blen[:, None]).squeeze(1)
    starts = mark[:, :C] & inside

    # 3. output bytes
    made = torch.where(starts, produced, 0)
    ends = made.cumsum(1)  # output end of the tag at each start
    total = ends[:, -1] if C else torch.zeros(R, dtype=torch.int64, device=dev)
    op = ends - made
    bad_copy = (starts & (kind != 0) & ((offset == 0) | (offset > op))).any(1)
    ok = whole & ~bad_copy & (total == olen_exp)

    j = torch.arange(out_cap, device=dev, dtype=torch.int64)[None, :].expand(R, out_cap)
    if C == 0:
        return torch.zeros((R, out_cap), dtype=torch.uint8, device=dev), ok
    s = torch.searchsorted(ends, j.contiguous(), right=True).clamp(max=C - 1)
    live = j < torch.minimum(total, olen_exp)[:, None]
    k = j - op.gather(1, s)
    lit = kind.gather(1, s) == 0
    src = (s + hdr.gather(1, s) + k).clamp(0, C + 4)
    value = torch.where(live & lit, pad.gather(1, src), 0)
    ptr = torch.where(live & ~lit, (j - offset.gather(1, s)).clamp(min=0), j)
    for _ in range(_rounds(out_cap)):
        ptr = ptr.gather(1, ptr)
    return value.gather(1, ptr).to(torch.uint8), ok


def check_rows(comp: torch.Tensor, body_lens: torch.Tensor, plain: torch.Tensor,
               lengths: torch.Tensor, block_rows: int = 64) -> torch.Tensor:
    """Per row: does the tag stream decode to exactly the first
    ``lengths[i]`` bytes of ``plain[i]``? Rows go ``block_rows`` at a time,
    so that the reference fits beside whatever else the device holds.
    Returns bool [R] on ``comp``'s device."""
    R = comp.shape[0]
    good = []
    for a in range(0, R, block_rows):
        c, bl = comp[a : a + block_rows], body_lens[a : a + block_rows]
        p, n = plain[a : a + block_rows], lengths[a : a + block_rows]
        out, ok = decode_bodies(c, bl, n, p.shape[1])
        col = torch.arange(p.shape[1], device=p.device)[None, :]
        same = torch.where(col < n.to(p.device)[:, None].long(), out.to(p.device) == p, True)
        good.append(ok.to(p.device) & same.all(1))
    return torch.cat(good) if good else torch.zeros(0, dtype=torch.bool)
