"""Exact-nearest multi-width match candidates for ``level="best"`` (port of
``snappier_tpu/ops/best_match.py``).

For each position i and each width w of a ladder, the nearest j < i whose
first w bytes fingerprint-match position i's; the widest width that has
such a j wins. Width 4 compares the exact 4-byte key; wider widths fold two
32-bit fingerprints by doubling, ``fp(2w)[i] = fold(fp(w)[i], fp(w)[i+w])``.
A collision cannot corrupt output: the encode walk verifies each
candidate's first 4 bytes and measures the true match length, so a bogus
candidate only costs density.

Each width is one row sort and one scatter. These are tensor operations
outside any kernel, as the JAX package leaves its sorts to XLA, and the same
code runs on the CPU and on the card. The fingerprint arithmetic runs in
int64 and wraps to int32 at each step, so it gives the JAX package's
wrapping int32 products on either device.
"""

from __future__ import annotations

import torch

from snappier_tpu_torch.utils.profiling import span

#: Two independent 32-bit fold multipliers (odd, so each step is bijective),
#: as int32 values.
_M1 = -1640531527  # 0x9E3779B9
_M2 = -1028477387  # 0xC2B2AE35

#: The width ladder: adding 128 gained density on html, 256 did not
#: (measured by the JAX package).
DEFAULT_WIDTHS = (4, 8, 16, 32, 64, 128)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> the int32 they wrap to (two's complement)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _nearest_prev(hi, lo, valid, pos):
    """Per row: nearest previous position with an equal (hi, lo)
    fingerprint, -1 where none or invalid. Invalid positions get unique
    keys so they never pair with each other.

    One int64 key per position (hi in the top half, lo's bits below) and a
    stable sort stand for the JAX package's 3-key sort on (hi, lo, pos):
    equal keys mean equal pairs, and a stable sort keeps each group in
    position order. The groups' order differs, which changes no result."""
    hi = torch.where(valid, hi.long(), 0x7F000000 + pos)
    lo = torch.where(valid, lo.long(), pos)
    key = hi * (1 << 32) + (lo & 0xFFFFFFFF)
    sk, sp = torch.sort(key, dim=1, stable=True)
    prev = torch.full_like(sp, -1)
    prev[:, 1:] = torch.where(sk[:, 1:] == sk[:, :-1], sp[:, :-1], -1)
    cand = torch.empty_like(prev)
    return cand.scatter_(1, sp, prev)


def exact_candidates(frags: torch.Tensor, lengths: torch.Tensor,
                     widths: tuple = DEFAULT_WIDTHS) -> torch.Tensor:
    """Byte rows [B, F] (int32 or uint8) -> int32 [B, F] candidate positions.

    cand[b, i] is the nearest j < i whose first-w bytes fingerprint-match
    position i, for the LARGEST w in ``widths`` that has such a j; -1 when no
    width matches. Positions with fewer than w valid bytes left
    (i + w > lengths[b]) take no part at width w. The result lies on
    ``frags``' device."""
    ws = sorted(widths)
    if not ws or ws[0] != 4:
        raise ValueError("width ladder must start at the exact 4-byte key")
    if any(w & (w - 1) for w in ws):
        raise ValueError(f"widths must be powers of two (doubling fingerprints); got {ws}")
    if frags.dim() != 2 or lengths.shape != (frags.shape[0],):
        raise ValueError("frags must be [B, F] and lengths [B]")
    B, F = frags.shape
    with span("best.candidates", B * F, device=frags.device):  # the fingerprints, every width
        d = torch.nn.functional.pad(frags.long(), (0, 4))
        pos = torch.arange(F, dtype=torch.int64, device=frags.device)[None, :]
        k4 = _wrap32(d[:, 0:F] | (d[:, 1 : F + 1] << 8) | (d[:, 2 : F + 2] << 16)
                     | (d[:, 3 : F + 3] << 24))
        fps = {4: (k4, _wrap32(k4.long() * _M2))}
        w = 4
        while w < ws[-1]:
            hi, lo = fps[w]
            hi_s = torch.roll(hi, -w, dims=1)  # [i+w]; wrapped positions are
            lo_s = torch.roll(lo, -w, dims=1)  # masked by the validity test
            fps[2 * w] = (_wrap32(hi.long() * _M1 + hi_s.long()),
                          _wrap32(lo.long() * _M2 + lo_s.long()))
            w *= 2

        lens = lengths.to(device=frags.device, dtype=torch.int64)[:, None]
        cand = torch.full((B, F), -1, dtype=torch.int64, device=frags.device)
        for w in ws:  # narrowest first; a wider width overwrites, so it wins
            hi, lo = fps[w]
            cw = _nearest_prev(hi, lo, pos + w <= lens, pos)
            cand = torch.where(cw >= 0, cw, cand)
        return cand.to(torch.int32)
