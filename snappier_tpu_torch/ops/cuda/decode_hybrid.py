"""The descriptor-driven block decode (port of the decode kernels of
``tools/perf_probe_hybrid.py``): a pre-pass computes, for every byte
position of a compressed row, the descriptor of the tag that would start
there, and a walk reads one descriptor per tag.

Pre-passes, each bit-equal to its JAX function. The tensor code is the
plain version and the CPU path; on a CUDA tensor each form's pre-pass is
one kernel (``csrc/decode_hybrid.cu``'s ``prepass_kernel``: a thread a word
of a row, int32 arithmetic, ``hy::spec_at`` / ``hy::spec2_at``):

- :func:`spec_from_comp` (``_spec_from_comp``): one int32 per byte from the
  byte rows. A literal is ``adv:18 | hdr:3 << 18`` (``hdr`` 7 poisons it),
  a copy ``off:16 | len:7 << 16 | (adv - 2):2 << 23 | poison << 25 | 1 << 31``;
  its kernel, :func:`prepass_v5`, reads the rows a byte at a time;
- :func:`pack_words` (``decode_v5``'s word packing): the rows as
  little-endian int32 words;
- :func:`spec_from_words` (``_spec_from_words``): the same descriptor from
  the words, with a shift per byte phase; its kernel, :func:`prepass_v6`,
  reads word rows as words (two words and a shift a byte phase), other rows
  a byte at a time;
- :func:`spec2_from_words` (``_spec2_from_words``): two arrays,
  ``spec0 = adv:18 | F:7 << 18 | small << 30 | is_copy << 31`` (``F`` the
  header length of a literal, the length of a copy) and ``spec1``, the
  source relative to ``ip`` (a literal) or ``op`` (a copy, ``-off``); a
  poisoned position is a copy of offset 0. Its kernel is :func:`prepass_v7`.

The tensor pre-passes compute in int64 and wrap to int32 where the JAX
functions wrap (``b4 << 24``, sums of a 4-byte literal length), so that no
shift is arithmetic where the TPU's is logical and no overflow is left to
the compiler.

Walks: one kernel for every form (``csrc/decode_hybrid.cu`` over
``csrc/decode_hybrid.cuh``), the decode kernel's (``csrc/decode.cu``): a
batch of tags a warp step, lane ``l`` taking its tag from the descriptors
at ``ip + l``, two warps a block and only the output image in shared memory
(:func:`decode_hybrid_layout`).

- :func:`decode_v5` (``_decode_kernel_v5``): error words 2 (the tag
  overruns the input), overwritten by 3 (copy offset 0 or beyond the
  output), by 4 (a poisoned literal), by 3 (a poisoned copy offset), by 4
  (the tag overruns the claimed length), as the TPU's chain of ``where``\\ s;
  8 for the preamble; 4 for a clean walk that ends short of the claim;
- :func:`decode_v5_spec` (``v5parts``): the same kernel on words and
  descriptors computed beforehand, counted as ``decode_v5_parts``;
- :func:`decode_v6` (``_decode_kernel_v6``): ``decode_v5``'s checks over
  :func:`spec_from_words`. The TPU clamps a bad tag's append instead of
  skipping it, to save a branch; its output is discarded all the same, so
  the port stops at the first bad tag;
- :func:`decode_v7` (``_decode_kernel_v7``, ``unroll2`` its two-units-a-loop
  form, ``v7u`` in the tool): over :func:`prepass_v7`, one validity test
  per tag, error 4 for any bad tag, 8 for the preamble; ``unroll2`` parses
  two batches a loop iteration.

Each wrapper takes ``(comp [B, CC] uint8 or int32, comp_lens [B], out_cap)``
and returns ``(out uint8 [B, out_cap], out_lens int32 [B], errs int32
[B])``; ``out_lens`` is 0 on any error and bytes past it are unspecified. A
CUDA tensor launches the kernels or raises; a CPU tensor runs the plain
version: the tensor pre-pass, then a Python walk over the same descriptors,
a tag at a time. Each wrapper counts its launches.

Divergences from the TPU functions, by design:

- The TPU walks round their output image up to 1024 words and accept a
  preamble up to ``owc * 4 - 1024`` bytes (68,608 at ``out_cap`` 65,536),
  then cut the row. Here a claim above ``out_cap`` is error 8, as the
  production kernel and ``decode_variants`` do. The two agree where
  ``out_cap + 1024`` is a multiple of 4096.
- A 4-byte literal length of ``0xFFFFFFFB``-``0xFFFFFFFE`` is a literal of
  -4 to -1 bytes in the descriptor. ``_decode_kernel_v5`` takes it and steps
  its output position back (``v6`` and ``v7`` clamp it to 0); where that
  would take the position below 0, the TPU walk writes into its input image.
  ``decode_v5`` gives error 4 for such a tag instead.
- The JAX wrappers assert ``CC % 1024 == 0`` and ``out_cap % 1024 == 0``
  (their DMA tiling). The port takes any shape whose output image fits a
  block's shared memory (the row is never staged) and raises on one that
  does not. Lengths outside ``[0, CC]`` are taken as 0 or ``CC``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from snappier_tpu_torch.constants import BLOCK_SIZE
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.ops.cuda._tensors import byte_rows, lengths_vector, on_cuda
from snappier_tpu_torch.ops.cuda.decode_variants import read_preamble
from snappier_tpu_torch.ops.cuda.scalar_codec import MAX_OUT_CAP, _layout

ERR_TRUNC = 2  # the tag overruns the input
ERR_OFF = 3  # copy offset 0, beyond the output, or poisoned
ERR_LEN = 4  # the tag overruns the claim, a poisoned literal, a short walk

#: form -> (the launcher's form number, launch-counter name).
FORMS = {"v5": (5, "decode_v5"), "v6": (6, "decode_v6"), "v7": (7, "decode_v7")}

_LIT_POISON = 1 | (7 << 18)
#: Static shared memory of a block of each form (``csrc/decode_hybrid.cu``):
#: a descriptor ring of 1 KiB a descriptor row (two for ``v7``) and the
#: queue of ``csrc/batched_decode.cuh`` (four slots of 284 bytes, two
#: counters, the result).
STATIC_SMEM = {form: rings * 1024 + 4 * 284 + 8 + 8
               for form, rings in (("v5", 1), ("v6", 1), ("v7", 2))}


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to the int32 range, as int32 arithmetic wraps."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _fields(b0, b1, b2, b3, b4):
    """The speculative tag at each position from its 5 bytes (int64): the
    fields every descriptor layout is made of."""
    tt = b0 & 3
    l6 = b0 >> 2
    ext = torch.where(l6 < 60, 0, l6 - 59)
    hdr = 1 + ext
    ext_len = _i32(
        torch.where(ext >= 1, b1, 0)
        | torch.where(ext >= 2, b2 << 8, 0)
        | torch.where(ext >= 3, b3 << 16, 0)
        | torch.where(ext >= 4, b4 << 24, 0)
    )
    litlen = torch.where(ext == 0, l6 + 1, _i32(ext_len + 1))
    adv_l = _i32(hdr + litlen)
    pois_l = (adv_l >= (1 << 18)) | (adv_l <= 0)
    len_c = torch.where(tt == 1, (l6 & 7) + 4, l6 + 1)
    off4 = _i32(b1 | (b2 << 8) | (b3 << 16) | (b4 << 24))
    off_c = torch.where(tt == 1, ((b0 >> 5) << 8) | b1,
                        torch.where(tt == 2, b1 | (b2 << 8), off4 & 0xFFFF))
    pois_c = (tt == 3) & ((off4 > 0xFFFF) | (off4 < 0))
    return tt, hdr, adv_l, pois_l, len_c, off_c, pois_c


def _spec(b) -> torch.Tensor:
    tt, hdr, adv_l, pois_l, len_c, off_c, pois_c = _fields(*b)
    lit_word = torch.where(pois_l, _LIT_POISON, adv_l | (hdr << 18))
    advc = torch.where(tt == 1, 0, torch.where(tt == 2, 1, 3))
    copy_word = off_c | (len_c << 16) | (advc << 23) | (pois_c.long() << 25) | -(1 << 31)
    return torch.where(tt == 0, lit_word, copy_word).to(torch.int32)


def _comp_bytes(comp: torch.Tensor):
    c = F.pad(comp.to(torch.int64), (0, 4))
    cc = comp.shape[1]
    return tuple(c[:, k : k + cc] for k in range(5))


def _word_bytes(words: torch.Tensor, cc: int):
    """Bytes i .. i + 4 of every position i < cc from the word image, with a
    static shift per byte phase (no misaligned byte slices)."""
    B, wc = words.shape
    w = words.to(torch.int64) & 0xFFFFFFFF
    zero = w.new_zeros((B, 1))
    w1 = torch.cat([w[:, 1:], zero], dim=1)
    w2 = torch.cat([w[:, 2:], zero, zero], dim=1)

    def bcast(x):  # (B, wc) -> (B, cc), each word 4 times
        return x.repeat_interleave(4, dim=1)[:, :cc]

    w0, w1, w2 = bcast(w), bcast(w1), bcast(w2)
    ph = (torch.arange(cc, device=words.device) & 3)[None, :] * 8
    # v32 holds bytes i .. i + 3, hi32 bytes i + 4 .. i + 7; the shift by 32
    # at phase 0 is an int64 shift and discarded by the where.
    v32 = torch.where(ph == 0, w0, ((w0 >> ph) | (w1 << (32 - ph))) & 0xFFFFFFFF)
    hi32 = torch.where(ph == 0, w1, ((w1 >> ph) | (w2 << (32 - ph))) & 0xFFFFFFFF)
    return v32 & 0xFF, (v32 >> 8) & 0xFF, (v32 >> 16) & 0xFF, (v32 >> 24) & 0xFF, hi32 & 0xFF


def spec_from_comp(comp: torch.Tensor) -> torch.Tensor:
    """int32[B, CC] descriptor per byte position from byte rows
    (``tools/perf_probe_hybrid.py::_spec_from_comp``)."""
    return _spec(_comp_bytes(comp))


def pack_words(comp: torch.Tensor) -> torch.Tensor:
    """Byte rows as int32[B, ceil(CC / 4)] little-endian words, zero-padded
    (the packing of ``decode_v5``; the port keeps no 1024-word tiles)."""
    c = comp.to(torch.uint8)
    c = F.pad(c, (0, (-c.shape[1]) % 4)).contiguous()
    b = c.reshape(c.shape[0], -1, 4).to(torch.int64)
    w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    return _i32(w).to(torch.int32)


def spec_from_words(words: torch.Tensor, cc: int) -> torch.Tensor:
    """:func:`spec_from_comp` computed from the word image of rows of ``cc``
    bytes (``_spec_from_words``)."""
    return _spec(_word_bytes(words, cc))


def spec2_from_words(words: torch.Tensor, cc: int):
    """``(spec0, spec1)``, int32[B, cc] each (``_spec2_from_words``)."""
    tt, hdr, adv_l, pois_l, len_c, off_c, pois_c = _fields(*_word_bytes(words, cc))
    off_c = torch.where(pois_c, 0, off_c)
    adv_c = torch.where(tt == 1, 2, torch.where(tt == 2, 3, 5))
    is_lit = (tt == 0) & ~pois_l
    adv = torch.where(is_lit, adv_l, torch.where(tt == 0, 1, adv_c))
    f = torch.where(is_lit, hdr, torch.where(tt == 0, 4, len_c))
    off_c = torch.where((tt == 0) & pois_l, 0, off_c)
    small = ~is_lit & (off_c < 8)
    spec0 = adv | (f << 18) | (small.long() << 30) | torch.where(is_lit, 0, -(1 << 31))
    spec1 = torch.where(is_lit, hdr, -off_c)
    return spec0.to(torch.int32), spec1.to(torch.int32)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _tag(form: int, d0: int, d1: int, ip: int, op: int, n: int, expected: int):
    """One tag from its descriptor: (error word, advance, length, is_copy,
    offset, literal source); the error word mirrors ``hy::tag_error`` (forms
    5 and 6) and ``hy::DescribedTags::bad`` (form 7)."""
    is_copy = d0 < 0
    d = d0 & 0xFFFFFFFF
    if form == 7:
        adv = d & 0x3FFFF
        f = (d >> 18) & 0x7F
        length = f if is_copy else adv - f
        offm1 = -d1 - 1
        bad = (ip + adv > n or op + length > expected
               or (is_copy and (offm1 >= op or offm1 < 0)))
        return (ERR_LEN if bad else 0), adv, length, is_copy, -d1, ip + d1
    hdr = (d >> 18) & 7
    off = d & 0xFFFF
    adv = ((d >> 23) & 3) + 2 if is_copy else d & 0x3FFFF
    length = (d >> 16) & 0x7F if is_copy else (d & 0x3FFFF) - hdr
    e = ERR_TRUNC if ip + adv > n else 0
    if is_copy and (off == 0 or off > op):
        e = ERR_OFF
    if not is_copy and hdr >= 6:
        e = ERR_LEN
    if is_copy and (d >> 25) & 1:
        e = ERR_OFF
    if op + length > expected:
        e = ERR_LEN
    if form == 5 and e == 0 and op + length < 0:
        e = ERR_LEN  # the port's one divergence from _decode_kernel_v5
    return e, adv, length, is_copy, off, ip + hdr


def _walk_row(form: int, row: bytes, n: int, out_cap: int, spec0, spec1, out: bytearray):
    """One block's walk over its descriptors, a tag at a time, as the TPU
    walks go; returns (out_len, err) and writes the output into ``out``."""
    pre_len, expected, err = read_preamble(row, n, out_cap)
    ip, op = pre_len, 0
    while ip < n and err == 0:
        e, adv, length, is_copy, off, src = _tag(
            form, int(spec0[ip]), int(spec1[ip]) if form == 7 else 0, ip, op, n, expected)
        if e:
            err = e
            break
        if length > 0:
            if is_copy:
                pat = out[op - off : op]
                out[op : op + length] = (pat * (length // off + 1))[:length]
            else:
                out[op : op + length] = row[src : src + length]
        op += length if form == 5 else max(length, 0)
        ip += adv
    if err == 0 and op != expected:
        err = ERR_LEN
    return (expected if err == 0 else 0), err


def walk_plain(rows: torch.Tensor, spec0: torch.Tensor, spec1, comp_lens: torch.Tensor,
               out_cap: int, form: str):
    """Plain version of the walks on CPU tensors: uint8 ``rows`` [B, >= CC],
    descriptors int32 [B, CC] (``spec1`` only for ``"v7"``). Returns
    ``(out uint8[B, out_cap], out_lens int32[B], errs int32[B])``."""
    number = FORMS[form][0]
    B, cc = spec0.shape
    rows_np = rows.numpy()
    s0 = spec0.numpy()
    s1 = spec1.numpy() if spec1 is not None else s0
    lens = comp_lens.tolist()
    out = np.zeros((B, out_cap), np.uint8)
    out_lens = np.zeros(B, np.int32)
    errs = np.zeros(B, np.int32)
    for b in range(B):
        buf = bytearray(out_cap)
        n = min(max(lens[b], 0), cc)
        out_lens[b], errs[b] = _walk_row(number, rows_np[b].tobytes(), n, out_cap,
                                         s0[b].tolist(), s1[b].tolist(), buf)
        out[b] = np.frombuffer(buf, np.uint8)
    return torch.from_numpy(out), torch.from_numpy(out_lens), torch.from_numpy(errs)


def decode_hybrid_plain(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int,
                        form: str = "v5"):
    """Plain version of :func:`decode_v5`, :func:`decode_v6` and
    :func:`decode_v7` (``form``) on CPU tensors: the pre-pass of the form,
    then the walk."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}: one of {sorted(FORMS)}")
    comp = byte_rows(comp, "comp")
    lens = lengths_vector(comp_lens, comp.shape[0], "comp_lens")
    spec0, spec1 = _prepass(comp, form)
    return walk_plain(comp, spec0, spec1, lens, int(out_cap), form)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def block_smem_bytes(form: str, out_cap: int) -> int:
    """Shared memory of one block of ``form`` (``"v5"``, ``"v6"``, ``"v7"``),
    dynamic and static: the output image and the descriptor rings, whatever
    the row's width."""
    return ((out_cap + 15) & ~15) + STATIC_SMEM[form]


def _prepass_kernel(comp, form: str):
    """Launch the pre-pass kernel of ``form`` on CUDA byte rows; counted as
    ``prepass_<form>``. Returns spec0, and spec1 for ``"v7"``."""
    B, cc = comp.shape
    specs = [torch.empty((B, cc), dtype=torch.int32, device=comp.device)
             for _ in range(2 if form == "v7" else 1)]
    _build.launch("prepass", comp.device, FORMS[form][0], comp.data_ptr(), cc, B,
                  specs[0].data_ptr(), specs[-1].data_ptr(), count_as=f"prepass_{form}")
    return specs


def prepass_v5(comp) -> torch.Tensor:
    """``decode_v5``'s descriptors, int32 [B, CC], of byte rows [B, CC] (uint8
    or int32 byte values). A CUDA tensor launches the pre-pass kernel (the
    rows read a byte at a time; counted as ``prepass_v5``); a CPU tensor runs
    its plain version, :func:`spec_from_comp`."""
    comp = byte_rows(comp, "comp")
    if not on_cuda(comp):
        return spec_from_comp(comp)
    return _prepass_kernel(comp, "v5")[0]


def prepass_v6(comp) -> torch.Tensor:
    """``decode_v6``'s descriptors, int32 [B, CC], of byte rows [B, CC]. A
    CUDA tensor launches the pre-pass kernel (word rows read as words; counted
    as ``prepass_v6``); a CPU tensor runs its plain version,
    :func:`spec_from_words` of :func:`pack_words`."""
    comp = byte_rows(comp, "comp")
    if not on_cuda(comp):
        return spec_from_words(pack_words(comp), comp.shape[1])
    return _prepass_kernel(comp, "v6")[0]


def prepass_v7(comp):
    """``decode_v7``'s descriptors ``(spec0, spec1)``, int32 [B, CC] each, of
    byte rows [B, CC]. A CUDA tensor launches the pre-pass kernel (counted as
    ``prepass_v7``); a CPU tensor runs its plain version,
    :func:`spec2_from_words` of :func:`pack_words`."""
    comp = byte_rows(comp, "comp")
    if not on_cuda(comp):
        return spec2_from_words(pack_words(comp), comp.shape[1])
    return tuple(_prepass_kernel(comp, "v7"))


def decode_hybrid_layout(comp, out_cap: int = BLOCK_SIZE, form: str = "v7") -> dict:
    """The launch layout of ``form`` for these rows: ``blocks_per_sm`` (the
    CUDA occupancy calculator's count under the attributes the launch sets),
    ``smem_bytes`` per block (dynamic and static), ``threads`` and the
    compressed row's ``loader`` (``"words"`` for a base and width that are
    multiples of 4, else ``"bytes"``), in the manner of
    ``scalar_codec.decode_layout``."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}: one of {sorted(FORMS)}")
    comp = byte_rows(comp, "comp")
    _check_fit(form, int(out_cap))
    return _layout("decode_hybrid_layout", comp, int(out_cap), FORMS[form][0],
                   loaders=("words", "bytes"))


def _prepass(comp: torch.Tensor, form: str):
    """The form's descriptors of byte rows: (spec0, spec1 or None)."""
    if form == "v5":
        return prepass_v5(comp), None
    if form == "v6":
        return prepass_v6(comp), None
    return prepass_v7(comp)


def _check_fit(form: str, out_cap: int) -> None:
    need = block_smem_bytes(form, out_cap)
    if out_cap <= 0 or need > MAX_OUT_CAP:
        raise ValueError(f"out_cap {out_cap} does not fit one block's shared memory ({need} of "
                         f"{MAX_OUT_CAP} bytes)")


def _launch(form: str, unroll2: bool, rows: torch.Tensor, spec0: torch.Tensor, spec1,
            lens: torch.Tensor, out_cap: int, counter: str):
    B, row_bytes = rows.shape
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=rows.device)
    out_lens = torch.empty(B, dtype=torch.int32, device=rows.device)
    errs = torch.empty(B, dtype=torch.int32, device=rows.device)
    _build.launch(
        "decode_hybrid", rows.device, FORMS[form][0], int(unroll2), rows.data_ptr(), row_bytes,
        spec0.data_ptr(), 0 if spec1 is None else spec1.data_ptr(), spec0.shape[1],
        lens.data_ptr(), B, out_cap, out.data_ptr(), out_lens.data_ptr(), errs.data_ptr(),
        count_as=counter,
    )
    return out, out_lens, errs


def _decode(comp, comp_lens, out_cap: int, form: str, unroll2: bool = False):
    comp = byte_rows(comp, "comp")
    B, cc = comp.shape
    lens = lengths_vector(comp_lens, B, "comp_lens")
    out_cap = int(out_cap)
    _check_fit(form, out_cap)
    if not on_cuda(comp, lens):
        return decode_hybrid_plain(comp, lens, out_cap, form)
    spec0, spec1 = _prepass(comp, form)
    return _launch(form, unroll2, comp, spec0, spec1, lens, out_cap, FORMS[form][1])


def decode_v5(comp, comp_lens, out_cap: int = BLOCK_SIZE):
    """Block decode over one descriptor per byte from :func:`spec_from_comp`
    (``tools/perf_probe_hybrid.py::decode_v5``)."""
    return _decode(comp, comp_lens, out_cap, "v5")


def decode_v6(comp, comp_lens, out_cap: int = BLOCK_SIZE):
    """``decode_v5``'s walk over :func:`spec_from_words`
    (``tools/perf_probe_hybrid.py::decode_v6``)."""
    return _decode(comp, comp_lens, out_cap, "v6")


def decode_v7(comp, comp_lens, out_cap: int = BLOCK_SIZE, unroll2: bool = False):
    """Block decode over the two arrays of :func:`prepass_v7`, one validity
    test per tag, error 4 for any bad tag; ``unroll2`` takes two units of
    the walk per loop iteration, two batches on the card
    (``tools/perf_probe_hybrid.py::decode_v7``)."""
    return _decode(comp, comp_lens, out_cap, "v7", bool(unroll2))


def decode_v5_spec(words, spec, comp_lens, out_cap: int = BLOCK_SIZE):
    """``decode_v5``'s kernel alone, on the word image :func:`pack_words`
    (viewed as byte rows and read as words) and the descriptors
    :func:`spec_from_comp` computed beforehand
    (``tools/perf_probe_hybrid.py::v5parts``). ``words`` int32 [B, WC],
    ``spec`` int32 [B, CC] with ``CC <= 4 * WC``; counted as
    ``decode_v5_parts``."""
    if not isinstance(words, torch.Tensor) or words.dim() != 2 or words.dtype != torch.int32:
        raise ValueError("words must be a 2-D int32 tensor")
    if not isinstance(spec, torch.Tensor) or spec.dim() != 2 or spec.dtype != torch.int32:
        raise ValueError("spec must be a 2-D int32 tensor")
    B = words.shape[0]
    if spec.shape[0] != B or spec.shape[1] > 4 * words.shape[1]:
        raise ValueError(f"spec {tuple(spec.shape)} does not fit words {tuple(words.shape)}")
    lens = lengths_vector(comp_lens, B, "comp_lens")
    out_cap = int(out_cap)
    rows = words.contiguous().view(torch.uint8)
    spec = spec.contiguous()
    _check_fit("v5", out_cap)
    if not on_cuda(rows, spec, lens):
        return walk_plain(rows, spec, None, lens, out_cap, "v5")
    return _launch("v5", False, rows, spec, None, lens, out_cap, "decode_v5_parts")
