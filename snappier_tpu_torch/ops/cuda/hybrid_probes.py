"""The hybrid decode's micro-probes (port of ``chain``, ``vcopy`` and
``coissue`` of ``tools/perf_probe_hybrid.py``): the primitives of a decode
that parses tag boundaries on one thread and copies payloads on many.

Inputs (plain numpy, shared by the tests, the tool and ``chip_smoke.py``):

- :func:`tags_from_block` (``_tags_from_html``): the advance array (1 at
  every byte, the tag's length at a tag's first byte) and one record
  ``(op, src, len, is_literal)`` per tag of a compressed block;
- :func:`chain_inputs`: the advance array padded to a multiple of 1,024
  words, as ``chain`` stages it;
- :func:`vcopy_records`: ``vcopy``'s record array (dst, src, len at 0, 8,192
  and 16,384, the loop count at 24,576), with its ``2 * nrec`` loop count:
  the records past ``nrec`` read the other regions, as on the TPU.

Probes (``csrc/hybrid_probes.cu`` over ``csrc/hybrid_probes.cuh``):

- :func:`chain` (``_chain_kernel``; ``with_rec`` is ``chainrec``): ``R``
  trials of the walk ``ip += adv[ip]`` from ``start + (r & 1)`` while
  ``ip < n``; returns ``(checksum int32 [1], records int32 [16384])``, the
  checksum the sum of the final ``ip`` (plus the step count with
  ``with_rec``), the records the buffer after the last trial (empty without
  ``with_rec``): ``(ip << 8) | (adv & 0xFF)`` at ``t & 8191`` and the running
  sum of advances at ``(t & 8191) + 8192``;
- :func:`vcopy` (``_vcopy_kernel``, modes ``"2d"`` and ``"3d"``): per record,
  the 128 words at word ``src >> 2`` of a 16,384-word image, funnel-shifted
  by the byte phase, rotated to lane ``dst & 127`` and merged under lane
  masks into the destination rows; returns ``(checksum int32 [1], image
  int32 [16384])``, the checksum the sum over records of ``rolled & 1`` on
  all 128 lanes;
- :func:`coissue` (``_coissue_kernel``): 8,192 iterations (``iters``) of a
  24-operation scalar chain through a 64-word scratch beside ``nvec``
  updates ``v = v * 3 + roll(v, 1 + k)`` of an int32 [8, 128] tile; returns
  ``(checksum int32 [1], tile int32 [8, 128])``.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version. ``chain`` and ``vcopy`` check their inputs on the host first (a
sync); :func:`launch_chain`, :func:`launch_vcopy` and :func:`launch_coissue`
launch the kernel alone on inputs that the wrapper has accepted, for
timing. The launches count as ``chain``, ``vcopy`` and ``coissue``.

No result of the TPU's ``coissue`` depends on its vector work: an update is
``v <- (3 + S^k) v`` (``S`` the rotation by one lane), and modulo 2
``(3 + S^k)^128 = 1 + S^(128 k) = 0``, so 4,096 updates take any tile to 0
modulo 2**32. At 8,192 iterations and ``nvec >= 1`` the tile is 0 and the
checksum the scalar chain's, whatever the tile. The tests hold the vector
path at a few iterations (``iters``), where it is not.

Divergences from the TPU functions, by design:

- ``chainrec`` stores record ``t`` at ``t & 8191``: a walk of more than 8,192
  steps would store past the TPU's 16,384-word buffer. The buffer is never
  read, so the checksum does not change.
- ``vcopy`` refuses a record whose source or destination rows leave the
  image (2d: rows ``src >> 9`` and the next, ``dst >> 9`` and the next; 3d:
  tiles ``src >> 12`` and ``dst >> 12``); the TPU's reads and writes there
  are undefined (interpret mode clamps them).
- The TPU's ``coissue`` reads its scratch and its tile before it writes
  them: it computes with whatever SMEM and VMEM held. The port starts from
  what interpret mode holds, ``0x80000000`` in every word but ``scratch[0] =
  seed``, unless the caller passes a tile.
- The TPU's ``chain`` never ends on an advance of 0 below ``n``; the port
  refuses advances outside ``[1, 2**24]`` below ``n``.
"""

from __future__ import annotations

import numpy as np
import torch

from snappier_tpu_torch.format.varint import read_varint
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.ops.cuda._tensors import on_cuda

CHAIN_R = 200  # chain's trials per call, as the TPU tool
REC_HALF = 8192  # chainrec: records at t & 8191, op at + 8192; vcopy: region stride
REC_WORDS = 2 * REC_HALF
IMAGE_WORDS = 16384  # vcopy's image: 128 rows of 128 lanes (2d), 16 tiles of 8 (3d)
LANES = 128
VCOPY_WORDS = 4 * REC_HALF
COUNT_AT = 3 * REC_HALF  # vcopy's loop count
COISSUE_ITERS = 8192
COISSUE_NVEC = (0, 1, 2, 8)  # the kernel's instantiations
TILE = (8, 128)
FILL = -(1 << 31)  # 0x80000000: what interpret mode reads from unwritten scratch
MAX_ADV = 1 << 24
SMEM_LIMIT = 232448  # dynamic shared memory a block may have (227 KB)
MODES = ("2d", "3d")

_M32 = 0xFFFFFFFF


def _i32(x: int) -> int:
    x &= _M32
    return x - (1 << 32) if x >> 31 else x


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def tags_from_block(block: bytes):
    """Advance array and tag records of one compressed block
    (``tools/perf_probe_hybrid.py::_tags_from_html`` on a given block).
    Returns ``(adv int32 [len + 8], recs int32 [n_tags, 4], n, out_len)``:
    ``adv`` is 1 except at each tag's first byte, which holds the tag's
    length; a record is ``(op, src, len, 1)`` for a literal (``src`` its
    first byte in the block) and ``(op, op - offset, len, 0)`` for a copy;
    ``n`` is where the walk ended, ``out_len`` the output it accounts for."""
    body = bytes(block)
    _, pos = read_varint(body)
    adv = np.ones(len(body) + 8, np.int32)
    recs = []
    op = 0
    while pos < len(body):
        t = body[pos]
        tt = t & 3
        if tt == 0:
            l6 = t >> 2
            if l6 < 60:
                ln = l6 + 1
                a = 1 + ln
            else:
                e = l6 - 59
                ln = int.from_bytes(body[pos + 1 : pos + 1 + e], "little") + 1
                a = 1 + e + ln
            recs.append((op, pos + a - ln, ln, 1))
        else:
            if tt == 1:
                ln = ((t >> 2) & 7) + 4
                off = ((t >> 5) << 8) | body[pos + 1]
                a = 2
            elif tt == 2:
                ln = (t >> 2) + 1
                off = int.from_bytes(body[pos + 1 : pos + 3], "little")
                a = 3
            else:
                ln = (t >> 2) + 1
                off = int.from_bytes(body[pos + 1 : pos + 5], "little")
                a = 5
            recs.append((op, op - off, ln, 0))
        adv[pos] = a
        pos += a
        op += ln
    return adv, np.array(recs, np.int32).reshape(-1, 4), pos, op


def chain_inputs(block: bytes):
    """``chain``'s inputs from one compressed block (the tool's padding):
    ``(adv int32 [pad], n, n_tags)`` with ``pad`` the advance array's length
    rounded up to 1,024 and zeros past it."""
    adv, recs, n, _ = tags_from_block(block)
    pad = -(-len(adv) // 1024) * 1024
    advp = np.zeros(pad, np.int32)
    advp[: len(adv)] = adv
    return advp, n, len(recs)


def vcopy_records(recs: np.ndarray) -> np.ndarray:
    """``vcopy``'s record array from :func:`tags_from_block`'s records (the
    tool's construction): ``dst = op % 64936``, ``src = max(src, 0) % 64936``,
    ``len = min(len, 64)``, loop count ``2 * nrec``. Pair it with the image
    ``np.arange(16384, dtype=np.int32)``."""
    nrec = len(recs)
    if nrec > REC_HALF:
        raise ValueError(f"{nrec} records: the layout holds at most {REC_HALF}")
    rec = np.zeros(VCOPY_WORDS, np.int32)
    rec[0:nrec] = recs[:, 0] % (65536 - 600)
    rec[REC_HALF : REC_HALF + nrec] = np.maximum(recs[:, 1], 0) % (65536 - 600)
    rec[2 * REC_HALF : 2 * REC_HALF + nrec] = np.minimum(recs[:, 2], 64)
    rec[COUNT_AT] = nrec * 2  # the records past nrec read the other regions
    return rec


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _chain_trial(adv: list, n: int, ip: int, rec: list | None):
    """One walk from ``ip``; stores its records into ``rec`` when given.
    Returns ``(final ip, steps)``; mirrors ``hp::chain_trial``."""
    op = t = 0
    while ip < n:
        a = adv[ip]
        if rec is not None:
            rec[t & (REC_HALF - 1)] = _i32((ip << 8) | (a & 0xFF))
            rec[(t & (REC_HALF - 1)) + REC_HALF] = _i32(op)
            op += a
        t += 1
        ip += a
    return ip, t


def chain_plain(adv: torch.Tensor, n: int, start: int = 3, R: int = CHAIN_R,
                with_rec: bool = False):
    """Plain version of :func:`chain` on a CPU tensor. Trials from the same
    start are the same walk, so each start is walked once and the record
    buffer replays the last two trials."""
    adv_l = adv.tolist()
    walks = {s: _chain_trial(adv_l, n, s, None) for s in {start, start + 1}}
    acc = 0
    for r in range(R):
        ip, steps = walks[start + (r & 1)]
        acc += ip + (steps if with_rec else 0)
    rec = [0] * REC_WORDS if with_rec else []
    if with_rec:
        for r in range(max(R - 2, 0), R):
            _chain_trial(adv_l, n, start + (r & 1), rec)
    return (torch.tensor([_i32(acc)], dtype=torch.int32), torch.tensor(rec, dtype=torch.int32))


def _vcopy_rows(mode: str, sw: int, dw: int):
    """The rows a record reads (``r0``, ``r1``) and writes (``dr`` and, unless
    the 3d body drops it, ``dr + 1``); mirrors ``hp::vcopy_record``."""
    r0 = sw >> 7
    r1 = r0 + 1
    dr = dw >> 7
    spill = True
    if mode == "3d":
        if r0 & 7 == 7:  # pair[:, 7:8] of the sublane-rotated tile pair
            r1 = min((sw >> 10) + 1, 15) * 8 + 6
        spill = dr & 7 != 7  # the write stays inside tile dw >> 10
    return r0, r1, dr, spill


def _vcopy_walk(rec: np.ndarray, img: np.ndarray, mode: str):
    flat = img.astype(np.uint32).copy()
    lanes = np.arange(LANES)
    acc = 0
    for t in range(int(rec[COUNT_AT])):
        dst, src, ln = int(rec[t]), int(rec[t + REC_HALF]), int(rec[t + 2 * REC_HALF])
        sw, dw = src >> 2, dst >> 2
        nw = (_i32(ln + 3) >> 2) + 1
        r0, r1, dr, spill = _vcopy_rows(mode, sw, dw)
        sl, dl = sw & 127, dw & 127
        row0 = flat[r0 * LANES : (r0 + 1) * LANES]
        row1 = flat[r1 * LANES : (r1 + 1) * LANES]
        w = np.where(lanes < LANES - sl, np.roll(row0, -sl), np.roll(row1, -sl))
        a8 = (src & 3) * 8
        sv = w if a8 == 0 else (w >> np.uint32(a8)) | (np.roll(w, -1) << np.uint32(32 - a8))
        rolled = np.roll(sv, dl)
        m0 = (lanes >= dl) & (lanes < dl + nw)
        flat[dr * LANES + lanes[m0]] = rolled[m0]
        if spill:
            m1 = lanes < dl + nw - LANES
            flat[(dr + 1) * LANES + lanes[m1]] = rolled[m1]
        acc += int((rolled & 1).sum())
    return _i32(acc), flat.view(np.int32)


def vcopy_plain(rec: torch.Tensor, img: torch.Tensor, mode: str = "2d"):
    """Plain version of :func:`vcopy` on CPU tensors."""
    acc, flat = _vcopy_walk(rec.numpy(), img.reshape(-1).numpy(), mode)
    return torch.tensor([acc], dtype=torch.int32), torch.from_numpy(flat.copy())


def _coissue_scalar(seed: int, iters: int) -> int:
    """The scalar chain's sum of ``x``; mirrors ``hp::coissue_step``."""
    scratch = [FILL & _M32] * 64
    scratch[0] = seed & _M32
    acc = 0
    for t in range(iters):
        x = scratch[t & 63]
        for _ in range(6):
            x = (x * 5 + 1) & 0x7FFFFFFF
            scratch[(t + x) & 63] = x
            x ^= scratch[(x >> 3) & 63]
        acc += x
    return acc


def coissue_plain(seed: int, nvec: int, tile: torch.Tensor | None = None,
                  iters: int = COISSUE_ITERS):
    """Plain version of :func:`coissue` (any ``nvec``)."""
    v = _tile_or_fill(tile, torch.device("cpu")).numpy().view(np.uint32).copy()
    for _ in range(iters if nvec else 0):
        for k in range(nvec):
            v = v * np.uint32(3) + np.roll(v, 1 + k, axis=1)
    acc = _coissue_scalar(seed, iters) + int((v & 1).sum())
    return torch.tensor([_i32(acc)], dtype=torch.int32), torch.from_numpy(v.view(np.int32))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _int32_vector(x, name: str, size: int | None = None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise ValueError(f"{name} must be an int32 tensor")
    x = x.reshape(-1).contiguous()
    if size is not None and x.numel() != size:
        raise ValueError(f"{name} must hold {size} int32 words, not {x.numel()}")
    return x


def chain_smem_bytes(adv_words: int, with_rec: bool) -> int:
    """Dynamic shared memory of :func:`chain`'s block; mirrors
    ``csrc/hybrid_probes.cu``."""
    return 4 * (((adv_words + 3) & ~3) + (REC_WORDS if with_rec else 0))


def chain(adv, n: int, start: int = 3, R: int = CHAIN_R, with_rec: bool = False):
    """``R`` trials of the tag-boundary walk over ``adv`` (int32 [len])
    (``tools/perf_probe_hybrid.py::chain``; ``with_rec`` is ``chainrec``).
    Returns ``(checksum int32 [1], records int32 [16384] or [0])``."""
    adv = _int32_vector(adv, "adv")
    n, start, R = int(n), int(start), int(R)
    if not 0 <= n <= adv.numel() or not 0 <= start < (1 << 30) or not 0 <= R < (1 << 31):
        raise ValueError(f"need 0 <= n <= len(adv), 0 <= start < 2**30, R >= 0; got n={n}, "
                         f"len(adv)={adv.numel()}, start={start}, R={R}")
    below = adv[min(start, n) : n]
    if bool(((below < 1) | (below > MAX_ADV)).any()):
        raise ValueError(f"adv[start:n] must lie in [1, {MAX_ADV}]: the walk would not end")
    if chain_smem_bytes(adv.numel(), with_rec) > SMEM_LIMIT:
        raise ValueError(f"an advance array of {adv.numel()} words does not fit one block's "
                         f"shared memory")
    if not on_cuda(adv):
        return chain_plain(adv, n, start, R, with_rec)
    return launch_chain(adv, n, start, R, with_rec)


def launch_chain(adv: torch.Tensor, n: int, start: int, R: int, with_rec: bool):
    """:func:`chain`'s kernel on a contiguous CUDA int32 ``adv`` that
    :func:`chain` accepts, without its checks."""
    out = torch.empty(1, dtype=torch.int32, device=adv.device)
    recs = torch.empty(REC_WORDS if with_rec else 0, dtype=torch.int32, device=adv.device)
    _build.launch("chain", adv.device, int(bool(with_rec)), adv.data_ptr(), adv.numel(), n, start,
                  R, out.data_ptr(), recs.data_ptr())
    return out, recs


def _check_records(rec: torch.Tensor, mode: str) -> None:
    """Refuse a loop count past the record array and any record whose rows
    leave the image."""
    count = int(rec[COUNT_AT])
    if count > REC_WORDS:
        raise ValueError(f"loop count {count}: records past {REC_WORDS} lie outside the array")
    t = torch.arange(max(count, 0), device=rec.device)
    sw, dw = rec[t + REC_HALF] >> 2, rec[t] >> 2
    top = IMAGE_WORDS - LANES if mode == "2d" else IMAGE_WORDS  # 2d reads and writes row + 1
    bad = (sw < 0) | (sw >= top) | (dw < 0) | (dw >= top)
    if bool(bad.any()):
        i = int(bad.nonzero()[0])
        raise ValueError(f"record {i} (dst {int(rec[i])}, src {int(rec[i + REC_HALF])}) leaves "
                         f"the image in mode {mode}")


def vcopy(rec, img, mode: str = "2d"):
    """The per-record vector copy body over ``rec`` (int32 [32768], see
    :func:`vcopy_records`) and an image of 16,384 int32 words (any shape)
    (``tools/perf_probe_hybrid.py::vcopy``). Returns ``(checksum int32 [1],
    image int32 [16384])``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: one of {MODES}")
    rec = _int32_vector(rec, "rec", VCOPY_WORDS)
    img = _int32_vector(img, "img", IMAGE_WORDS)
    cuda = on_cuda(rec, img)
    _check_records(rec, mode)
    if not cuda:
        return vcopy_plain(rec, img, mode)
    return launch_vcopy(rec, img, mode)


def launch_vcopy(rec: torch.Tensor, img: torch.Tensor, mode: str):
    """:func:`vcopy`'s kernel on contiguous CUDA int32 inputs that
    :func:`vcopy` accepts, without its checks."""
    out = torch.empty(1, dtype=torch.int32, device=rec.device)
    img_out = torch.empty(IMAGE_WORDS, dtype=torch.int32, device=rec.device)
    _build.launch("vcopy", rec.device, int(mode == "3d"), rec.data_ptr(), img.data_ptr(),
                  out.data_ptr(), img_out.data_ptr())
    return out, img_out


def _tile_or_fill(tile, device) -> torch.Tensor:
    if tile is None:
        return torch.full(TILE, FILL, dtype=torch.int32, device=device)
    return _int32_vector(tile, "tile", TILE[0] * TILE[1]).reshape(TILE)


def coissue(seed: int, nvec: int, tile=None, iters: int = COISSUE_ITERS, device=None):
    """The scalar chain beside ``nvec`` tile updates, ``iters`` iterations
    (``tools/perf_probe_hybrid.py::coissue``, which passes seed 3 and runs
    8,192). ``tile`` (int32, 1,024 words) defaults to ``0x80000000``
    everywhere on ``device`` (the card unless given; a given tile's device
    rules). Returns ``(checksum int32 [1], tile int32 [8, 128])``."""
    nvec, iters = int(nvec), int(iters)
    if nvec < 0 or not 0 <= iters < (1 << 31):
        raise ValueError(f"need nvec >= 0 and 0 <= iters < 2**31, got {nvec}, {iters}")
    if tile is None:
        device = torch.device(device if device is not None else "cuda")
    tile = _tile_or_fill(tile, device)
    if not on_cuda(tile):
        return coissue_plain(seed, nvec, tile, iters)
    if nvec not in COISSUE_NVEC:
        raise ValueError(f"the kernel is built for nvec in {COISSUE_NVEC}, not {nvec}")
    return launch_coissue(seed, nvec, tile, iters)


def launch_coissue(seed: int, nvec: int, tile: torch.Tensor, iters: int = COISSUE_ITERS):
    """:func:`coissue`'s kernel on a contiguous CUDA int32 [8, 128] tile
    (``nvec`` in :data:`COISSUE_NVEC`)."""
    out = torch.empty(1, dtype=torch.int32, device=tile.device)
    tile_out = torch.empty(TILE, dtype=torch.int32, device=tile.device)
    _build.launch("coissue", tile.device, nvec, _i32(int(seed)), iters, tile.data_ptr(),
                  out.data_ptr(), tile_out.data_ptr())
    return out, tile_out
