"""Exact-nearest multi-width match candidates for ``level="best"`` (port of
``snappier_tpu/ops/best_match.py``).

For each position i and each width w of a ladder, the nearest j < i whose
first w bytes fingerprint-match position i's; the widest width that has
such a j wins. Width 4 compares the exact 4-byte key; wider widths fold two
32-bit fingerprints by doubling, ``fp(2w)[i] = fold(fp(w)[i], fp(w)[i+w])``.
A collision cannot corrupt output: the encode walk verifies each
candidate's first 4 bytes and measures the true match length, so a bogus
candidate only costs density.

On the card :func:`exact_candidates` is one launch of a hand-written
kernel (``csrc/best_candidates.cu``: a thread-block cluster a row, every
width's fingerprints, a radix sort a width and the merge on chip), counted
as ``best_candidates``. :func:`exact_candidates_plain` is its plain version,
the tensor code that runs for CPU tensors: each width one row sort and one
scatter, as the JAX package leaves its sorts to XLA. Its fingerprint
arithmetic runs in int64 and wraps to int32 at each step, so it gives the
JAX package's wrapping int32 products.
"""

from __future__ import annotations

import ctypes

import torch

from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.ops.cuda._tensors import on_cuda
from snappier_tpu_torch.utils.profiling import span

#: Two independent 32-bit fold multipliers (odd, so each step is bijective),
#: as int32 values.
_M1 = -1640531527  # 0x9E3779B9
_M2 = -1028477387  # 0xC2B2AE35

#: The width ladder: adding 128 gained density on html, 256 did not
#: (measured by the JAX package).
DEFAULT_WIDTHS = (4, 8, 16, 32, 64, 128)

#: The widest row the kernel takes: a cluster of 8 CTAs of 8,192 positions.
MAX_WIDTH = 65536


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


def ladder(widths) -> list:
    """The width ladder, sorted, or ValueError: it starts at the exact
    4-byte key and every width is a power of two (doubling fingerprints)."""
    ws = sorted(int(w) for w in widths)
    if not ws or ws[0] != 4:
        raise ValueError("width ladder must start at the exact 4-byte key")
    if any(w & (w - 1) for w in ws):
        raise ValueError(f"widths must be powers of two (doubling fingerprints); got {ws}")
    return ws


def widths_mask(widths) -> int:
    """The kernel's ladder: bit k set for width 2^k, for each width of
    :func:`ladder` up to 2^30 (a wider one exceeds every int32 length, so no
    position takes it)."""
    return sum({1 << (w.bit_length() - 1) for w in ladder(widths) if w <= 1 << 30})


def exact_candidates(frags: torch.Tensor, lengths: torch.Tensor,
                     widths: tuple = DEFAULT_WIDTHS) -> torch.Tensor:
    """Byte rows [B, F] (int32 or uint8, F <= 65,536) -> int32 [B, F]
    candidate positions.

    cand[b, i] is the nearest j < i whose first-w bytes fingerprint-match
    position i, for the LARGEST w in ``widths`` that has such a j; -1 when no
    width matches. Positions with fewer than w valid bytes left
    (i + w > lengths[b]) take no part at width w. The result lies on
    ``frags``' device: for CUDA rows one launch of the ``best_candidates``
    kernel (:func:`launch_candidates`), for CPU rows
    :func:`exact_candidates_plain`."""
    ws = ladder(widths)
    if not isinstance(frags, torch.Tensor) or frags.dim() != 2:
        raise ValueError("frags must be a [B, F] tensor")
    if frags.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"frags must be uint8 or int32 byte values, not {frags.dtype}")
    if not isinstance(lengths, torch.Tensor) or lengths.shape != (frags.shape[0],):
        raise ValueError(f"lengths must be a tensor of shape ({frags.shape[0]},)")
    if lengths.dtype.is_floating_point or lengths.dtype == torch.bool:
        raise ValueError(f"lengths must be integers, not {lengths.dtype}")
    B, F = frags.shape
    if F > MAX_WIDTH:
        raise ValueError(f"rows of at most {MAX_WIDTH} bytes, got {F}")
    with span("best.candidates", B * F, device=frags.device):
        lens = lengths.to(device=frags.device, dtype=torch.int32)
        if not on_cuda(frags, lens):
            return exact_candidates_plain(frags, lens, ws)
        return launch_candidates(frags, lens, ws)


def launch_candidates(frags: torch.Tensor, lengths: torch.Tensor, widths=DEFAULT_WIDTHS,
                      fallbacks: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`exact_candidates`' kernel on CUDA rows, which the caller has
    checked as :func:`exact_candidates` does, and lengths on their device.
    ``fallbacks``: an int32 [1] tensor on that device to which each width
    that a row sorted by its whole key (a walk over one bucket crossed more
    than 32 runs of equal keys) adds 1."""
    B, F = frags.shape
    out = torch.empty((B, F), dtype=torch.int32, device=frags.device)
    if fallbacks is not None and (fallbacks.dtype != torch.int32 or fallbacks.numel() != 1
                                  or fallbacks.device != frags.device):
        raise ValueError("fallbacks must be an int32 tensor of one word on the rows' device")
    if B and F:
        rows = frags.to(torch.uint8).contiguous()
        lens = lengths.to(dtype=torch.int32).contiguous()
        _build.launch("best_candidates", rows.device, rows.data_ptr(), F, lens.data_ptr(), B,
                      widths_mask(widths), out.data_ptr(),
                      None if fallbacks is None else fallbacks.data_ptr())
    return out


def candidates_layout(F: int, device=None) -> dict:
    """The kernel's launch layout for rows of F bytes on a CUDA device (the
    current one by default): ``ctas`` a cluster, which takes one row,
    ``smem_bytes`` and ``threads`` a CTA, and ``clusters``, how many the
    card holds at once (CUDA's occupancy calculator under the attributes
    the launch sets)."""
    if not 0 < F <= MAX_WIDTH:
        raise ValueError(f"rows of 1 to {MAX_WIDTH} bytes, got {F}")
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the layout is the CUDA kernel's: give a CUDA device")
    out = (ctypes.c_int32 * 4)()
    with torch.cuda.device(dev):
        rc = _build.launcher("best_candidates_layout")(F, out)
    if rc != 0:
        raise RuntimeError(f"best_candidates_layout failed with cudaError {rc}")
    return {"ctas": out[0], "smem_bytes": out[1], "threads": out[2], "clusters": out[3]}


def exact_candidates_plain(frags: torch.Tensor, lengths: torch.Tensor,
                           widths: tuple = DEFAULT_WIDTHS) -> torch.Tensor:
    """Plain version of :func:`exact_candidates` (the same contract) in
    tensor code, on any device: each width one stable row sort and one
    scatter."""
    ws = ladder(widths)
    B, F = frags.shape
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
