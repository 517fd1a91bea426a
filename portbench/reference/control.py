"""The control: the plain reference put in the program's place with one
guarantee broken, which the check has to find.

A codec states no precision to lower. The shortcut that would tempt a later
change is to take a match candidate on the strength of its hash and skip
comparing its bytes. The control encoder does exactly that: every 4-byte
chunk of a row becomes a copy of the nearest earlier chunk whose 4 bytes
hash to the same ``key_bits``-bit key, or a literal where none does. With
``key_bits=None`` it compares the bytes themselves and is a sound (lossless,
valid, if weak) encoder, which the tests use to show that the check passes
an encoder that is not the program's. Decoding is the reference decoder
(:mod:`portbench.reference.snappy_torch`). All of it is tensor code, at the
cell's own sizes on the card. Each driver's ``Control`` puts these in its
program's place, with the program's call shapes.
"""

from __future__ import annotations

import torch

HASH_MUL = 0x1E35A7BD
MAX_OFFSET = 65535


def chunk_encode(rows: torch.Tensor, lengths: torch.Tensor, key_bits: int | None):
    """Encode byte rows [R, F]: (bodies uint8 [R, W], body_lens int32 [R])
    with W = 5 * (F // 4) + 5."""
    dev = rows.device
    R, F = rows.shape
    K = F // 4
    n = lengths.to(device=dev, dtype=torch.int64)
    q = rows[:, : 4 * K].to(torch.int64).view(R, K, 4)
    word = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)
    k = torch.arange(K, device=dev, dtype=torch.int64)[None, :]
    full = k < (n // 4)[:, None]
    key = word if key_bits is None else ((word * HASH_MUL) & 0xFFFFFFFF) >> (32 - key_bits)
    key = torch.where(full, key, (1 << 33) + k)  # chunks past the end pair with nothing
    sk, sp = torch.sort(key * K + k, dim=1)
    grp = sk // K
    prev = torch.full_like(sp, -1)
    prev[:, 1:] = torch.where(grp[:, 1:] == grp[:, :-1], sp[:, :-1], -1)
    near = torch.empty_like(prev).scatter_(1, sp, prev)  # nearest earlier chunk with the key
    dist = (k - near) * 4
    copy = full & (near >= 0) & (dist <= MAX_OFFSET)
    size = torch.where(full, torch.where(copy, 3, 5), 0)
    at = size.cumsum(1) - size
    tail = n % 4
    tail_at = size.sum(1)
    W = 5 * K + 5
    body = torch.zeros((R, W + 5), dtype=torch.uint8, device=dev)
    rr = torch.arange(R, device=dev)[:, None].expand(R, K)
    sink = W + 4  # chunks that emit nothing write here
    b0 = torch.where(copy, (3 << 2) | 2, 3 << 2)
    b1 = torch.where(copy, dist & 0xFF, word & 0xFF)
    b2 = torch.where(copy, dist >> 8, (word >> 8) & 0xFF)
    for j, val in enumerate((b0, b1, b2, (word >> 16) & 0xFF, (word >> 24) & 0xFF)):
        live = full if j < 3 else full & ~copy
        body[rr, torch.where(live, at + j, sink)] = val.to(torch.uint8)
    t = torch.arange(R, device=dev)
    has_tail = tail > 0
    body[t, torch.where(has_tail, tail_at, sink)] = ((tail - 1).clamp(min=0) << 2).to(torch.uint8)
    base = (n // 4) * 4
    for j in range(3):
        live = j < tail
        col = (base + j).clamp(max=F - 1)
        body[t, torch.where(live, tail_at + 1 + j, sink)] = rows[t, col].to(torch.uint8)
    body_lens = tail_at + torch.where(has_tail, 1 + tail, 0)
    # a row that the chunks would grow is one literal instead, as a Snappy
    # encoder keeps incompressible input within its bound
    m = (n - 1).clamp(min=0)
    hdr = torch.where(m < 60, 1, torch.where(m < 256, 2, 3))
    lit = torch.zeros_like(body)
    for h in (1, 2, 3):
        head = torch.stack([torch.where(m < 60, m << 2, (58 + h) << 2), m & 0xFF, m >> 8],
                           dim=1)[:, :h].to(torch.uint8)
        shifted = torch.cat([head, rows, body.new_zeros((R, W + 5 - h - F))], dim=1)
        lit = torch.where((hdr == h)[:, None], shifted, lit)
    grow = body_lens > n + hdr
    body = torch.where(grow[:, None], lit, body)
    body_lens = torch.where(grow, n + hdr, body_lens)
    return body[:, :W].contiguous(), body_lens.to(torch.int32)


def read_preambles(comp: torch.Tensor):
    """Varint lengths (up to 3 bytes) of whole blocks: (lengths, bytes)."""
    c = comp[:, :3].to(torch.int64)
    one = c[:, 0] < 0x80
    two = ~one & (c[:, 1] < 0x80)
    low = c[:, 0] & 0x7F
    n = torch.where(one, c[:, 0], torch.where(
        two, low | (c[:, 1] << 7), low | ((c[:, 1] & 0x7F) << 7) | (c[:, 2] << 14)))
    pre = torch.where(one, 1, torch.where(two, 2, 3))
    return n, pre
