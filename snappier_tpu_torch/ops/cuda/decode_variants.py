"""The decode-walk ablation: six forms of the batched Snappy block decode
(port of the kernels of ``tools/perf_probe.py``).

``decode_v2``, ``decode_v4``, ``decode_v3`` and ``decode_variant`` (``"v1"``,
``"v1nock"``, ``"v1nocp"``) compute one function, the decode of a batch of
blocks; on the TPU they differed in how the walk keeps its output image and
appends a tag's payload. On the card they are one kernel
(``csrc/decode_variants.cu``) on the production kernel's block and batched
walk, over a tag source with the TPU kernels' error words
(``csrc/decode_variants.cuh``), each TPU knob as its nearest counterpart there
(that file says which); the ablation (``tools/torch_perf_probe.py``) times
them against the production kernel,
:func:`snappier_tpu_torch.ops.cuda.scalar_codec.decode_blocks_bytes`.

Each wrapper takes ``(comp [B, CC] uint8 or int32, comp_lens [B], out_cap)``
and returns ``(out uint8 [B, out_cap], out_lens int32 [B], errs int32 [B])``.
``out_lens`` is 0 on any error and bytes of a row past its ``out_len`` are
unspecified. The error word is classified per tag, unlike the production
kernel's combined word: 1 (the tag overruns the input), overwritten by 2
(copy offset 0 or beyond the output), overwritten by 4 (the tag overruns
the claimed length); 8 for a bad preamble, which includes a claim above
``out_cap``; 4 for a clean walk that ends short of the claim. Lengths
outside ``[0, CC]`` are taken as 0 or ``CC``, and bytes at or past ``CC``
read as zero.

The wrappers accept what ``decode_pipe`` accepts: rows of any width, and an
``out_cap`` whose image (with its slack) fits one block's shared memory.
The TPU kernels' ``% 1024`` shapes were their DMA tiling and are not carried
over, with one consequence: the TPU word variants round their output image
up to 1024 words, so their capacity is ``owc * 4 - 1024`` bytes, which
exceeds ``out_cap`` unless ``out_cap + 1024`` is a multiple of 4096 (68,608
at ``out_cap`` 65,536), and they accept a preamble up to that and cut the
row. Here every variant gives ``ERR_BAD_PREAMBLE`` for a claim above
``out_cap``, as ``v1`` and the production kernel do on either machine.
:func:`decode_variant_layout` gives a variant's launch layout.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
Python walk, which the four share because they compute one function. Each
wrapper counts its own launches.

``decode_pipe`` and ``decode_pipe2`` (port of the pipelined walks of
``tools/perf_probe_r4.py``; one kernel in ``csrc/decode_pipe.cu`` on the
production kernel's block and batched walk) take the same arguments and
return the same triple, with the production kernel's error words: 8 for the
preamble, the combined 7 for any bad tag, 4 for a clean walk that ends short
of the claim. ``decode_pipe`` computes the production kernel's function.
``decode_pipe2`` differs in one case, as its TPU kernel does: a 4-byte
literal length field of ``0xFFFFFFFF`` is a literal of no bytes, taken where
the production kernel refuses it. Its knobs are the TPU's, each as its
nearest counterpart on the batched walk: ``unroll`` batches parsed a loop
iteration, ``unc`` the writing warp's rounds stored whole past a batch's end
(1: its last round, 2: every round left in that step), ``dma_pipe`` the
finished row drained by the copy engine where the rows allow it, and
``emit=False`` a walk that hands nothing on (only ``out_lens`` and ``errs``
mean anything). :func:`decode_pipe_layout` gives a form's launch layout.
"""

from __future__ import annotations

import numpy as np
import torch

from snappier_tpu_torch.constants import BLOCK_SIZE
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.ops.cuda._tensors import byte_rows, lengths_vector, on_cuda
from snappier_tpu_torch.ops.cuda.scalar_codec import MAX_OUT_CAP, _layout
from snappier_tpu_torch.ops.decode import (
    ERR_BAD_OFFSET,
    ERR_BAD_PREAMBLE,
    ERR_LENGTH_MISMATCH,
    ERR_MALFORMED,
    ERR_TRUNCATED_TAG,
)

_POISON = 1 << 28

#: variant name -> (the launcher's variant number, launch-counter name).
VARIANTS = {
    "v2": (0, "decode_v2"),
    "v4": (1, "decode_v4"),
    "v3": (2, "decode_v3"),
    "v1": (3, "decode_variant"),
    "v1nock": (4, "decode_variant"),
    "v1nocp": (5, "decode_variant"),
}


def _parse_tag(rd, ip: int):
    """The tag at ``ip``: (hdr, is_lit, length, off, advance), as the TPU
    kernels read it: a 4-byte length or offset field whose top byte is set
    is poisoned (``dv::variant_error`` reads it the same way)."""
    tag = rd(ip)
    tt, l6 = tag & 3, tag >> 2
    rest = rd(ip + 1) | rd(ip + 2) << 8 | rd(ip + 3) << 16
    b4 = rd(ip + 4)
    off = 0
    if tt == 0:
        if l6 < 60:
            hdr, length = 1, l6 + 1
        else:
            extra = l6 - 59
            hdr = 1 + extra
            length = (rest & ((1 << (8 * min(extra, 3))) - 1)) + 1
            if extra == 4 and b4 > 0:
                length = _POISON
    elif tt == 1:
        hdr, length, off = 2, ((tag >> 2) & 7) + 4, ((tag >> 5) << 8) | (rest & 0xFF)
    elif tt == 2:
        hdr, length, off = 3, l6 + 1, rest & 0xFFFF
    else:
        hdr, length, off = 5, l6 + 1, _POISON if b4 > 0 else rest
    return hdr, tt == 0, length, off, hdr + (length if tt == 0 else 0)


def read_preamble(comp: bytes, n: int, out_cap: int):
    """``(pre_len, expected, err)`` of a row's varint preamble, bytes at or
    past the row's end read as zero; mirrors ``sc::read_preamble``: err is
    ``ERR_BAD_PREAMBLE`` for more than 5 bytes, a 5th byte of 8 or more, a
    preamble longer than ``n`` or a claim above ``out_cap``, else 0."""
    pre_len, val, done, err = 0, 0, False, 0
    while not done and pre_len < 5 and err == 0:
        byte = comp[pre_len] if pre_len < len(comp) else 0
        val |= (byte & 0x7F) << min(7 * pre_len, 28)
        done = byte < 0x80
        if pre_len == 4 and byte >= 8:
            err = ERR_BAD_PREAMBLE
        pre_len += 1
    if not done or pre_len > n or val > out_cap:  # val is below 2**31: the 5th byte is below 8
        err = ERR_BAD_PREAMBLE
    return pre_len, val, err


def _walk_row(comp: bytes, n: int, out_cap: int, out: bytearray, checks: bool, copies: bool):
    """One block's walk, a tag at a time, as the TPU kernels walk it;
    computes what ``csrc/decode_variants.cu`` computes. Returns ``(out_len,
    err)`` and, with ``copies``, writes the output into ``out``. Without
    ``checks`` no tag is tested: the result is defined for valid blocks only,
    and a payload is cut to the room that is left."""
    cc = len(comp)
    n = min(max(n, 0), cc)

    def rd(i):
        return comp[i] if 0 <= i < cc else 0

    pre_len, expected, err = read_preamble(comp, n, out_cap)
    ip, op = pre_len, 0
    while ip < n and err == 0:
        hdr, is_lit, length, off, advance = _parse_tag(rd, ip)
        if checks:
            if ip + advance > n:
                err = ERR_TRUNCATED_TAG
            if not is_lit and (off <= 0 or off > op):
                err = ERR_BAD_OFFSET
            if op + length > expected:
                err = ERR_LENGTH_MISMATCH
        else:
            op = min(op, out_cap)
            length = min(length, out_cap - op)
        if err == 0:
            if copies and length > 0:
                if is_lit:
                    seg = comp[ip + hdr : ip + hdr + length]
                    out[op : op + length] = seg + bytes(length - len(seg))
                elif 0 < off <= op:
                    pat = out[op - off : op]
                    out[op : op + length] = (pat * (length // off + 1))[:length]
            op += length
        ip += advance
    if err == 0 and op != expected:
        err = ERR_LENGTH_MISMATCH
    return (expected if err == 0 else 0), err


def decode_variant_plain(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int,
                         variant: str = "v1"):
    """Plain version of the ablation kernels on CPU uint8 rows: returns
    ``(out uint8[B, out_cap], out_lens int32[B], errs int32[B])``. Every
    variant computes the same function; ``"v1nock"`` tests no tag and
    ``"v1nocp"`` leaves ``out`` zero."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {sorted(VARIANTS)}")
    B = comp.shape[0]
    rows = comp.numpy()
    lens = comp_lens.tolist()
    out = np.zeros((B, out_cap), np.uint8)
    out_lens = np.zeros(B, np.int32)
    errs = np.zeros(B, np.int32)
    for b in range(B):
        buf = bytearray(out_cap)
        out_lens[b], errs[b] = _walk_row(rows[b].tobytes(), lens[b], out_cap, buf,
                                         variant != "v1nock", variant != "v1nocp")
        out[b] = np.frombuffer(buf, np.uint8)
    return torch.from_numpy(out), torch.from_numpy(out_lens), torch.from_numpy(errs)


#: The rounds each variant's writing warp stores whole past a batch's end
#: (``unc`` of ``decode_pipe2``), by the launcher's variant number
#: (``dv::with_variant``): v2 0, v4 1, v3 0, v1 / v1nock / v1nocp 2.
_VARIANT_UNC = (0, 1, 0, 2, 2, 2)


def _smem_bytes(variant: int, out_cap: int) -> int:
    """Shared memory of one block of variant number ``variant``, dynamic and
    static: the output image with its slack, whatever the row's width (the
    block of ``csrc/decode_pipe.cu``)."""
    return _pipe_smem_bytes(out_cap, _VARIANT_UNC[variant])


def _check_variant(variant: str, out_cap: int) -> int:
    """The launcher's number of ``variant``, after checking that ``out_cap``
    fits one block's shared memory."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {sorted(VARIANTS)}")
    number = VARIANTS[variant][0]
    if out_cap <= 0 or _smem_bytes(number, out_cap) > MAX_OUT_CAP:
        raise ValueError(
            f"out_cap {out_cap} does not fit one block's shared memory "
            f"({_smem_bytes(number, out_cap)} of {MAX_OUT_CAP} bytes)"
        )
    return number


def decode_variant_layout(comp, out_cap: int = BLOCK_SIZE, variant: str = "v1") -> dict:
    """The launch layout of ``variant`` for these rows, as its wrapper
    launches it: ``blocks_per_sm``, ``smem_bytes`` per block (dynamic and
    static), ``threads`` and ``loader`` (``"ring"`` for a base and width that
    are multiples of 4, else ``"bytes"``), in the manner of
    ``scalar_codec.decode_layout``."""
    comp = byte_rows(comp, "comp")
    number = _check_variant(variant, int(out_cap))
    return _layout("decode_variant_layout", comp, int(out_cap), number,
                   loaders=("ring", "bytes"))


def _decode(comp, comp_lens, out_cap: int, variant: str):
    out_cap = int(out_cap)
    number = _check_variant(variant, out_cap)
    counter = VARIANTS[variant][1]
    comp = byte_rows(comp, "comp")
    B, cc = comp.shape
    comp_lens = lengths_vector(comp_lens, B, "comp_lens")
    if not on_cuda(comp, comp_lens):
        return decode_variant_plain(comp, comp_lens, out_cap, variant)
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=comp.device)
    out_lens = torch.empty(B, dtype=torch.int32, device=comp.device)
    errs = torch.empty(B, dtype=torch.int32, device=comp.device)
    _build.launch(
        "decode_variants", comp.device, number, comp.data_ptr(), cc,
        comp_lens.data_ptr(), B, out_cap, out.data_ptr(), out_lens.data_ptr(), errs.data_ptr(),
        count_as=counter,
    )
    return out, out_lens, errs


def decode_v2(comp, comp_lens, out_cap: int = BLOCK_SIZE):
    """``tools/perf_probe.py::decode_v2`` (on the TPU a word-packed output
    image and the error word carried through the walk); on the card the
    batched walk, each batch's bytes written up to its end."""
    return _decode(comp, comp_lens, out_cap, "v2")


def decode_v4(comp, comp_lens, out_cap: int = BLOCK_SIZE):
    """``tools/perf_probe.py::decode_v4`` (on the TPU ``decode_v2`` with the
    words after the frontier always stored and the error word worked out
    after the walk); on the card each batch's last round stored whole."""
    return _decode(comp, comp_lens, out_cap, "v4")


def decode_v3(comp, comp_lens, out_cap: int = BLOCK_SIZE):
    """``tools/perf_probe.py::decode_v3`` (on the TPU one image for the
    compressed and the output words, one append path); on the card
    ``decode_v2``'s kernel, whose writing warp already reads literals and
    copies through one source word."""
    return _decode(comp, comp_lens, out_cap, "v3")


def decode_variant(comp, comp_lens, out_cap: int = BLOCK_SIZE, variant: str = "v1"):
    """``tools/perf_probe.py::decode_variant`` (on the TPU a byte image with a
    fixed 16-byte move per tag; on the card every round left in a batch's
    step stored whole). ``variant`` is ``"v1"``, ``"v1nock"`` (no per-tag
    checks but those that keep every access inside the image and the row:
    trusted input only, the result is defined for valid blocks) or
    ``"v1nocp"`` (the walk alone: ``out`` is not written, only ``out_lens``
    and ``errs`` mean anything)."""
    if variant not in ("v1", "v1nock", "v1nocp"):
        raise ValueError(f"unknown variant {variant!r}: 'v1', 'v1nock' or 'v1nocp'")
    return _decode(comp, comp_lens, out_cap, variant)


# ---------------------------------------------------------------------------
# Pipelined walks
# ---------------------------------------------------------------------------


def _int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _pipe_row(comp: bytes, n: int, out_cap: int, out: bytearray, fold: bool, emit: bool):
    """One block's walk, a tag at a time, as the TPU kernels walk it;
    computes what ``csrc/decode_pipe.cu`` computes. Returns ``(out_len,
    err)`` and, with ``emit``, writes the output into ``out``. With ``fold``
    a 4-byte literal length keeps all 32 bits and wraps, so ``0xFFFFFFFF``
    is a literal of no bytes; without it a set 4th byte poisons the length."""
    cc = len(comp)
    n = min(max(n, 0), cc)

    def rd(i):
        return comp[i] if 0 <= i < cc else 0

    pre_len, expected, err = read_preamble(comp, n, out_cap)
    if err:
        return 0, err

    ip, op = pre_len, 0
    while ip < n:
        tag = rd(ip)
        rest = rd(ip + 1) | rd(ip + 2) << 8 | rd(ip + 3) << 16 | rd(ip + 4) << 24
        tt, l6, off = tag & 3, tag >> 2, 0
        if tt == 0:
            if l6 < 60:
                hdr, length = 1, l6 + 1
            else:
                extra = l6 - 59
                hdr = 1 + extra
                if fold:
                    length = _int32((rest & ((1 << (8 * extra)) - 1)) + 1)
                else:
                    length = (rest & ((1 << (8 * min(extra, 3))) - 1)) + 1
                    if extra == 4 and rest >> 24:
                        length = _POISON
        elif tt == 1:
            hdr, length, off = 2, ((tag >> 2) & 7) + 4, ((tag >> 5) << 8) | (rest & 0xFF)
        elif tt == 2:
            hdr, length, off = 3, l6 + 1, rest & 0xFFFF
        else:
            hdr, length, off = 5, l6 + 1, _int32(rest)
        ip2 = ip + hdr + (length if tt == 0 else 0)
        if (ip2 > n or length < 0 or op + length > expected
                or (tt != 0 and (off <= 0 or off > op))):
            return 0, ERR_MALFORMED
        if emit and length > 0:
            if tt == 0:
                out[op : op + length] = comp[ip + hdr : ip2]
            else:
                pat = out[op - off : op]
                out[op : op + length] = (pat * (length // off + 1))[:length]
        op += length
        ip = ip2
    if op != expected:
        return 0, ERR_LENGTH_MISMATCH
    return expected, 0


def decode_pipe_plain(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int,
                      fold: bool = False, emit: bool = True):
    """Plain version of the pipelined kernels on CPU uint8 rows: returns
    ``(out uint8[B, out_cap], out_lens int32[B], errs int32[B])``.
    ``fold`` chooses ``decode_pipe2``'s reading of a 4-byte literal length;
    without ``emit`` ``out`` stays zero."""
    B = comp.shape[0]
    rows = comp.numpy()
    lens = comp_lens.tolist()
    out = np.zeros((B, out_cap), np.uint8)
    out_lens = np.zeros(B, np.int32)
    errs = np.zeros(B, np.int32)
    for b in range(B):
        buf = bytearray(out_cap)
        out_lens[b], errs[b] = _pipe_row(rows[b].tobytes(), lens[b], out_cap, buf, fold, emit)
        out[b] = np.frombuffer(buf, np.uint8)
    return torch.from_numpy(out), torch.from_numpy(out_lens), torch.from_numpy(errs)


#: Static shared memory of a block of ``csrc/decode_pipe.cu``, the
#: production kernel's: the tag table and the input ring (1 KiB each) and the
#: queue of ``csrc/batched_decode.cuh`` (four slots of 284 bytes, two
#: counters, the result).
PIPE_STATIC_SMEM = 1024 + 1024 + 4 * 284 + 8 + 8
#: Bytes past the output image that ``unc`` 0, 1 and 2 may store
#: (``sc::emit_slack``: none, a round of 32 lanes, four rounds).
PIPE_SLACK = (0, 32, 128)


def _pipe_smem_bytes(out_cap: int, unc: int = 0) -> int:
    """Shared memory of one block of ``csrc/decode_pipe.cu``, dynamic and
    static: the output image with its slack for ``unc``, whatever the row's
    width."""
    return ((out_cap + 15) & ~15) + PIPE_SLACK[unc] + PIPE_STATIC_SMEM


def _check_pipe_form(out_cap: int, fold: bool, unroll: int, unc: int) -> None:
    if not 1 <= unroll <= 4:
        raise ValueError(f"unroll must be 1, 2, 3 or 4, got {unroll}")
    if unc not in (0, 1, 2):
        raise ValueError(f"unc must be 0, 1 or 2, got {unc}")
    if not fold and (unroll, unc) != (1, 0):
        raise ValueError("decode_pipe takes unroll 1 and unc 0 only")
    if out_cap <= 0 or _pipe_smem_bytes(out_cap, unc) > MAX_OUT_CAP:
        raise ValueError(
            f"out_cap {out_cap} does not fit one block's shared memory "
            f"({_pipe_smem_bytes(out_cap, unc)} of {MAX_OUT_CAP} bytes)"
        )


def decode_pipe_layout(comp, out_cap: int = BLOCK_SIZE, fold: bool = True, unroll: int = 1,
                       unc: int = 0, emit: bool = True, dma_pipe: bool = False) -> dict:
    """The launch layout of a pipelined form for these rows, as
    :func:`decode_pipe` (``fold=False``) or :func:`decode_pipe2` with these
    arguments launches it: ``blocks_per_sm``, ``smem_bytes`` per block
    (dynamic and static), ``threads`` and ``loader`` (``"ring"`` for a base
    and width that are multiples of 4, else ``"bytes"``), in the manner of
    ``scalar_codec.decode_layout``. ``emit`` and ``dma_pipe`` do not change
    it."""
    comp = byte_rows(comp, "comp")
    out_cap, unroll, unc = int(out_cap), int(unroll), int(unc)
    _check_pipe_form(out_cap, fold, unroll, unc)
    return _layout("decode_pipe_layout", comp, out_cap, int(bool(fold)), unroll, unc,
                   loaders=("ring", "bytes"))


def _decode_pipe(comp, comp_lens, out_cap: int, counter: str, fold: bool, unroll: int,
                 emit: bool, unc: int, dma_pipe: bool):
    comp = byte_rows(comp, "comp")
    B, cc = comp.shape
    comp_lens = lengths_vector(comp_lens, B, "comp_lens")
    out_cap, unroll, unc = int(out_cap), int(unroll), int(unc)
    _check_pipe_form(out_cap, fold, unroll, unc)
    if not on_cuda(comp, comp_lens):
        return decode_pipe_plain(comp, comp_lens, out_cap, fold, bool(emit))
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=comp.device)
    out_lens = torch.empty(B, dtype=torch.int32, device=comp.device)
    errs = torch.empty(B, dtype=torch.int32, device=comp.device)
    _build.launch(
        "decode_pipe", comp.device, int(fold), unroll, unc, int(bool(emit)), int(bool(dma_pipe)),
        comp.data_ptr(), cc, comp_lens.data_ptr(), B, out_cap, out.data_ptr(),
        out_lens.data_ptr(), errs.data_ptr(), count_as=counter,
    )
    return out, out_lens, errs


def decode_pipe(comp, comp_lens, out_cap: int = BLOCK_SIZE):
    """The pipelined walk of ``tools/perf_probe_r4.py::decode_pipe``: on the
    card the production kernel's walk, its function and its tag source."""
    return _decode_pipe(comp, comp_lens, out_cap, "decode_pipe", False, 1, True, 0, False)


def decode_pipe2(comp, comp_lens, out_cap: int = BLOCK_SIZE, unroll: int = 1, emit: bool = True,
                 unc: int = 0, dma_pipe: bool = False):
    """``tools/perf_probe_r4.py::decode_pipe2``: ``decode_pipe`` that takes a
    4-byte literal length field of ``0xFFFFFFFF`` as a literal of no bytes.
    ``unroll`` batches are parsed a loop iteration; ``unc`` 1 stores the
    whole last round of each batch's output, 2 every round left in that step
    (garbage past the batch that the next one overwrites); ``dma_pipe``
    drains the finished row by one bulk asynchronous copy where ``out_cap``
    is a multiple of 16 and the output 16-byte aligned (the form's rule: other
    rows take the coalesced pass); without ``emit`` the walk hands nothing on
    and only ``out_lens`` and ``errs`` mean anything."""
    return _decode_pipe(comp, comp_lens, out_cap, "decode_pipe2", True, unroll, emit, unc,
                        dma_pipe)
