"""The hybrid decode's micro-probes (port of ``chain``, ``vcopy``,
``coissue``, ``iso``, ``bprobe``, ``cliff`` and ``bitonic`` of
``tools/perf_probe_hybrid.py``): the primitives of a decode that parses tag
boundaries on one thread and copies payloads on many.

Inputs (plain numpy, shared by the tests, the tool and ``chip_smoke.py``):

- :func:`tags_from_block` (``_tags_from_html``): the advance array (1 at
  every byte, the tag's length at a tag's first byte) and one record
  ``(op, src, len, is_literal)`` per tag of a compressed block;
- :func:`chain_inputs`: the advance array padded to a multiple of 1,024
  words, as the TPU's ``chain`` stages it;
- :func:`vcopy_records`: ``vcopy``'s record array (dst, src, len at 0, 8,192
  and 16,384, the loop count at 24,576), with its ``2 * nrec`` loop count:
  the records past ``nrec`` read the other regions, as on the TPU;
- :func:`iso_records`: the same array with the loop count ``nrec``, as
  ``iso`` stages it.

Probes (``csrc/hybrid_probes.cu`` and ``csrc/bitonic_probe.cu`` over
``csrc/hybrid_probes.cuh``):

- :func:`chain` (``_chain_kernel``; ``with_rec`` is ``chainrec``): ``R``
  trials of the walk ``ip += adv[ip]`` from ``start + (r & 1)`` while
  ``ip < n``; returns ``(checksum int32 [1], records int32 [16384])``, the
  checksum the sum of the final ``ip`` (plus the step count with
  ``with_rec``), the records the buffer after the last trial (empty without
  ``with_rec``): ``(ip << 8) | (adv & 0xFF)`` at ``t & 8191`` and the running
  sum of advances at ``(t & 8191) + 8192``; on the card ``cliff``'s walk
  with no body (the chase's kernel) or with the record stores;
- :func:`vcopy` (``_vcopy_kernel``, modes ``"2d"`` and ``"3d"``): per record,
  the 128 words at word ``src >> 2`` of a 16,384-word image, funnel-shifted
  by the byte phase, rotated to lane ``dst & 127`` and merged under lane
  masks into the destination rows; returns ``(checksum int32 [1], image
  int32 [16384])``, the checksum the sum over records of ``rolled & 1`` on
  all 128 lanes;
- :func:`coissue` (``_coissue_kernel``): 8,192 iterations (``iters``) of a
  24-operation scalar chain through a 64-word scratch beside ``nvec``
  updates ``v = v * 3 + roll(v, 1 + k)`` of an int32 [8, 128] tile; returns
  ``(checksum int32 [1], tile int32 [8, 128])``;
- :func:`coissue_vec`: ``coissue``'s tile warps at nvec 8 with no scalar
  chain (the vector stream alone); returns ``(count of odd words int32 [1],
  tile int32 [8, 128])``: the floor of nvec 8's tile work, a yardstick and
  not a TPU kernel (counted as ``coissue_vec``);
- :func:`iso` (``_iso_kernel``, :data:`ISO_MODES`): 20 passes over the
  records (pass ``r`` from record ``r & 1``), each doing one part of
  ``vcopy``'s 2d body alone to the image (``scalar``: an 8-step chain of the
  record's words and no image work; ``dynload``: row ``src >> 9`` stored at
  row ``dst >> 9``; ``dynload8``: the aligned group of 8 rows; ``statroll``,
  ``dynroll``: the row rolled by 5 and by ``(128 - sl) & 127`` lanes;
  ``full``: the whole body); returns ``(checksum int32 [1], image int32
  [16384])``, the checksum the sum of ``dst`` (``scalar``: of the chain)
  plus row 0's odd words;
- :func:`bprobe` (``_bprobe_kernel``): 524,288 iterations of a 4-step mix of
  a 64-word scratch followed by ``nwhen`` conditional stores (or, at 0,
  three select-stores); returns ``(checksum int32 [1], scratch int32
  [64])``;
- :func:`bprobe_floor`: ``bprobe``'s mix alone, ``x_t = mix(x_{t-1} ^ t)``
  from the seed over the same iterations, no scratch; returns the sum of
  the ``x`` (int32 [1]): the floor of ``bprobe``'s chain, a yardstick and
  not a TPU kernel (counted as ``bprobe_floor``);
- :func:`cliff` (``_cliff_kernel``, :data:`CLIFF_MODES`): ``chain``'s walk
  with a body per tag that stores into a 16,384-word image kept across the
  ``R`` trials; returns ``(checksum int32 [1], image int32 [16384])``, the
  checksum the sum of each trial's final ``ip`` and step count plus
  ``image[0]``;
- :func:`chase`: ``cliff``'s walk with no body, ``chain``'s function (the
  sum of the final ``ip``, int32 [1]) on the same kernel layout: the latency
  floor the ``cliff`` modes are held to, a yardstick and not a TPU kernel
  (counted as ``chase``);
- :func:`bitonic` (``_bitonic_kernel``): one merge pass (16 stages, ``j =
  32768 ... 1``, ``k = 15``) of a bitonic network over 65,536 int32 keys and
  their indices; returns ``(keys, vals)``, both int32 [512, 128].

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version. ``chain``, ``vcopy``, ``iso`` and ``cliff`` check their inputs on
the host first (a sync); the ``launch_*`` functions launch the kernel alone
on inputs that the wrapper has accepted, for timing. Each launch counts
under the wrapper's name.

The TPU's checksums cannot see most of what these probes do: on the
tool's inputs ``iso``'s sum is blind to the image (four of its modes give
one sum), ``cliff``'s ``img[0]`` is never written in four modes,
``bprobe`` at 0 and 3 compute the same thing, and ``bitonic`` drops its
indices. So each returns the state beside the sum.

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
- ``iso`` refuses a record whose rows leave the image (``full``: as
  ``vcopy`` 2d; the other row modes: a row outside 0-127), as ``vcopy``
  does; ``scalar`` touches no row and takes any record.
- ``bprobe`` and ``cliff`` read their scratch and image before they write
  them; the port starts from what interpret mode holds, ``0x80000000`` in
  every word but ``scratch[0] = seed``. The kernel is built for ``nwhen`` in
  :data:`BPROBE_NWHEN` and refuses any other on the card; the plain version
  takes 0-31 (a shift by 32 or more is not defined on the TPU).
- ``chain``, ``cliff`` and ``chase`` refuse an advance array whose staged
  copy (its own words, and past ``n`` room for the largest advance below
  ``n``: :func:`cliff_staged_words`) with the record buffer or image does
  not fit one block's shared memory.
- ``bitonic`` returns the indices beside the keys; the TPU computes and
  drops them.
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
# vcopy's and iso's block: the image and a ring of 64 16-byte record plans
# (hp::kRecordSmemWords in csrc/hybrid_probes.cuh).
COPY_SMEM_BYTES = 4 * IMAGE_WORDS + 16 * 64
LANES = 128
VCOPY_WORDS = 4 * REC_HALF
COUNT_AT = 3 * REC_HALF  # vcopy's loop count
COISSUE_ITERS = 8192
COISSUE_NVEC = (0, 1, 2, 8)  # the kernel's instantiations
COISSUE_VEC = -1  # the coissue launcher's nvec for the vector stream alone (hp::kCoissueVec)
COISSUE_VEC_NVEC = 8  # its updates an iteration
TILE = (8, 128)
FILL = -(1 << 31)  # 0x80000000: what interpret mode reads from unwritten scratch
MAX_ADV = 1 << 24
SMEM_LIMIT = 232448  # dynamic shared memory a block may have (227 KB)
MODES = ("2d", "3d")
ISO_MODES = ("scalar", "dynload", "dynload8", "statroll", "dynroll", "full")  # hp::IsoMode
ISO_PASSES = 20
BPROBE_ITERS = 524288
BPROBE_NWHEN = (0, 1, 2, 3, 4, 8)  # the kernel's instantiations
BPROBE_FLOOR = -1  # the bprobe launcher's nwhen for the floor (hp::kBprobeFloor)
SCRATCH_WORDS = 64
CLIFF_MODES = ("when1", "when2", "fori", "store4", "load4")  # hp::CliffMode
SORT_SHAPE = (512, 128)
SORT_N = SORT_SHAPE[0] * SORT_SHAPE[1]
BITONIC_K = 15  # the one merge pass: j = 32768 ... 1

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


def iso_records(recs: np.ndarray) -> np.ndarray:
    """``iso``'s record array: :func:`vcopy_records` with the loop count
    ``nrec`` (``tools/perf_probe_hybrid.py:497``)."""
    rec = vcopy_records(recs)
    rec[COUNT_AT] = len(recs)
    return rec


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _chain_trial(adv: list, n: int, ip: int, rec: list | None):
    """One walk from ``ip``; stores its records into ``rec`` when given.
    Returns ``(final ip, steps)``; ``hp::cliff_walk<kChainRec>`` walks it
    on staged advances."""
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


def _roll(v: np.ndarray, s: int) -> np.ndarray:
    """``pltpu.roll(v, s)`` on one row: ``out[p] = v[(p - s) & 127]``."""
    s &= LANES - 1
    return np.concatenate((v[LANES - s :], v[: LANES - s]))


def _vcopy_step(flat: np.ndarray, mode: str, dst: int, src: int, ln: int) -> np.ndarray:
    """One record of the copy body on the uint32 image ``flat`` (in place);
    returns the rolled row."""
    sw, dw = src >> 2, dst >> 2
    nw = (_i32(ln + 3) >> 2) + 1
    r0, r1, dr, spill = _vcopy_rows(mode, sw, dw)
    sl, dl = sw & 127, dw & 127
    # w[q]: word q of the 128 from lane sl of row r0 on, going on in row r1.
    w = np.concatenate((flat[r0 * LANES + sl : (r0 + 1) * LANES],
                        flat[r1 * LANES : r1 * LANES + sl]))
    a8 = (src & 3) * 8
    if a8:  # the funnel from the next lane's word (lane 127 takes lane 0)
        w = (w >> np.uint32(a8)) | (_roll(w, -1) << np.uint32(32 - a8))
    rolled = _roll(w, dl)
    end = min(dl + nw, LANES)  # row dr under lanes [dl, dl + nw)
    if end > dl:
        flat[dr * LANES + dl : dr * LANES + end] = rolled[dl:end]
    end = min(dl + nw - LANES, LANES)  # row dr + 1 under lanes below dl + nw - 128
    if spill and end > 0:
        flat[(dr + 1) * LANES : (dr + 1) * LANES + end] = rolled[:end]
    return rolled


def _records(rec: np.ndarray, t: int):
    return int(rec[t]), int(rec[t + REC_HALF]), int(rec[t + 2 * REC_HALF])


def _vcopy_walk(rec: np.ndarray, img: np.ndarray, mode: str):
    flat = img.astype(np.uint32).copy()
    acc = 0
    for t in range(int(rec[COUNT_AT])):
        acc += int((_vcopy_step(flat, mode, *_records(rec, t)) & 1).sum())
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


def _coissue_tile(tile, nvec: int, iters: int) -> np.ndarray:
    """The tile (uint32) after ``iters`` iterations of ``nvec`` updates."""
    v = _tile_or_fill(tile, torch.device("cpu")).numpy().view(np.uint32).copy()
    for _ in range(iters if nvec else 0):
        for k in range(nvec):
            v = v * np.uint32(3) + np.roll(v, 1 + k, axis=1)
    return v


def coissue_plain(seed: int, nvec: int, tile: torch.Tensor | None = None,
                  iters: int = COISSUE_ITERS):
    """Plain version of :func:`coissue` (any ``nvec``)."""
    v = _coissue_tile(tile, nvec, iters)
    acc = _coissue_scalar(seed, iters) + int((v & 1).sum())
    return torch.tensor([_i32(acc)], dtype=torch.int32), torch.from_numpy(v.view(np.int32))


def coissue_vec_plain(tile: torch.Tensor | None = None, iters: int = COISSUE_ITERS):
    """Plain version of :func:`coissue_vec`: ``coissue_plain``'s tile at
    nvec 8 and its count of odd words."""
    v = _coissue_tile(tile, COISSUE_VEC_NVEC, iters)
    return (torch.tensor([_i32(int((v & 1).sum()))], dtype=torch.int32),
            torch.from_numpy(v.view(np.int32)))


def iso_plain(rec: torch.Tensor, img: torch.Tensor, mode: str):
    """Plain version of :func:`iso` on CPU tensors."""
    r = rec.numpy()
    count = max(int(r[COUNT_AT]), 0)
    flat = img.reshape(-1).numpy().astype(np.uint32).copy()
    im = flat.reshape(LANES, LANES)
    acc = 0
    if mode == "scalar":  # records are independent: each pass sums them from r & 1
        dst, src, ln = (r[k * REC_HALF : k * REC_HALF + count].astype(np.uint32) for k in range(3))
        x = (dst * np.uint32(5) + src) ^ ln
        for _ in range(8):
            x = (x * np.uint32(5) + np.uint32(1)) & np.uint32(0x7FFFFFFF)
        x = x.astype(np.int64)
        acc = (ISO_PASSES // 2) * (int(x.sum()) + int(x[1:].sum()))
    passes = 0 if mode == "scalar" else ISO_PASSES
    for p in range(passes):
        for t in range(p & 1, count):
            dst, src, ln = _records(r, t)
            acc += dst
            if mode == "full":
                _vcopy_step(flat, "2d", dst, src, ln)
                continue
            sw = src >> 2
            sr, dr = sw >> 7, (dst >> 2) >> 7
            if mode == "dynload8":
                im[dr & 120 : (dr & 120) + 8] = im[sr & 120 : (sr & 120) + 8].copy()
            elif mode == "dynload":
                im[dr] = im[sr]
            else:
                im[dr] = _roll(im[sr], 5 if mode == "statroll" else 128 - (sw & 127))
    acc += int((im[0] & 1).sum())
    return torch.tensor([_i32(acc)], dtype=torch.int32), torch.from_numpy(flat.view(np.int32))


def _bprobe_mix(x: int) -> int:
    """The 4-step mix of one iteration on a signed int32 ``x``."""
    for _ in range(4):
        x = (x + (x >> 3)) & 0x7FFFFFFF  # x >> 3 is arithmetic on the signed value
    return x


def bprobe_plain(nwhen: int, seed: int = 3):
    """Plain version of :func:`bprobe` (``nwhen`` in 0-31), an iteration at a
    time over the scratch (``hp::bprobe_block`` runs 64 at once)."""
    scratch = [FILL & _M32] * SCRATCH_WORDS
    scratch[0] = seed & _M32
    acc = 0
    for t in range(BPROBE_ITERS):
        x = _bprobe_mix(_i32(scratch[t & 63] ^ t))
        for k in range(nwhen or 3):
            if (x >> k) & 1:
                scratch[(t + k) & 63] = (x + k) & _M32
        acc += x
    return (torch.tensor([_i32(acc)], dtype=torch.int32),
            torch.tensor([_i32(v) for v in scratch], dtype=torch.int32))


def bprobe_floor_plain(seed: int = 3, iters: int = BPROBE_ITERS):
    """Plain version of :func:`bprobe_floor` over ``iters`` iterations (the
    kernel's 524,288 by default)."""
    x, acc = _i32(seed), 0
    for t in range(iters):
        x = _bprobe_mix(_i32(x ^ t))
        acc += x
    return torch.tensor([_i32(acc)], dtype=torch.int32)


def cliff_plain(adv: torch.Tensor, n: int, mode: str, start: int = 3, R: int = CHAIN_R):
    """Plain version of :func:`cliff` on a CPU tensor; mirrors
    ``hp::cliff_walk``."""
    adv_l = adv.tolist()
    img = [FILL & _M32] * IMAGE_WORDS
    m = IMAGE_WORDS - 1
    acc = 0
    for r in range(R):
        ip, op, t = start + (r & 1), 0, 0
        while ip < n:
            a = adv_l[ip]
            if mode == "when1":
                if a > 3:
                    img[op & m] = a
            elif mode == "when2":
                if a > 2:
                    img[op & m] = a
                    img[(op + 1) & m] = a ^ ip
                    if a > 13:
                        img[(op + 2) & m] = a + ip
                        img[(op + 3) & m] = (a - ip) & _M32
            elif mode == "fori":
                if a > 2:
                    carry = a
                    for k in range(a & 7):
                        img[(op + k) & m] = carry + k
                        carry ^= k
            elif mode == "store4":
                img[op & m] = a
                img[(op + 1) & m] = a ^ ip
                img[(op + 2) & m] = a + ip
                img[(op + 3) & m] = (a - ip) & _M32
            else:  # load4: both loads, then both stores
                s0, s1 = img[(op - a) & m], img[(op - a + 1) & m]
                img[op & m] = s0
                img[(op + 1) & m] = s1
            ip += a
            op += a
            t += 1
        acc += ip + t
    return (torch.tensor([_i32(acc + img[0])], dtype=torch.int32),
            torch.tensor([_i32(v) for v in img], dtype=torch.int32))


def bitonic_plain(x: torch.Tensor):
    """Plain version of :func:`bitonic` on a CPU tensor: the TPU's stages,
    each over the whole array at once."""
    keys = x.reshape(-1).clone()
    idx = torch.arange(SORT_N, dtype=torch.int32)
    vals = idx.clone()
    up = ((idx >> (BITONIC_K + 1)) & 1) == 0
    for jj in range(BITONIC_K, -1, -1):
        j = 1 << jj
        partner = (idx ^ j).long()
        kq, vq = keys[partner], vals[partner]
        keep = torch.where(up == ((idx & j) == 0), torch.minimum(keys, kq) == keys,
                           torch.maximum(keys, kq) == keys)
        keys, vals = torch.where(keep, keys, kq), torch.where(keep, vals, vq)
    return keys.reshape(SORT_SHAPE), vals.reshape(SORT_SHAPE)


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


def _check_walk(adv: torch.Tensor, n: int, start: int, R: int) -> None:
    """Refuse a walk that could leave ``adv`` or never end (``chain``,
    ``cliff``)."""
    if not 0 <= n <= adv.numel() or not 0 <= start < (1 << 30) or not 0 <= R < (1 << 31):
        raise ValueError(f"need 0 <= n <= len(adv), 0 <= start < 2**30, R >= 0; got n={n}, "
                         f"len(adv)={adv.numel()}, start={start}, R={R}")
    below = adv[min(start, n) : n]
    if bool(((below < 1) | (below > MAX_ADV)).any()):
        raise ValueError(f"adv[start:n] must lie in [1, {MAX_ADV}]: the walk would not end")


def chain(adv, n: int, start: int = 3, R: int = CHAIN_R, with_rec: bool = False):
    """``R`` trials of the tag-boundary walk over ``adv`` (int32 [len])
    (``tools/perf_probe_hybrid.py::chain``; ``with_rec`` is ``chainrec``).
    Returns ``(checksum int32 [1], records int32 [16384] or [0])``."""
    adv, n, start, R, staged = _walk_staging(adv, n, start, R, REC_WORDS if with_rec else 0,
                                             " with the records" if with_rec else "")
    if not on_cuda(adv):
        return chain_plain(adv, n, start, R, with_rec)
    return launch_chain(adv, n, start, R, with_rec, staged)


def launch_chain(adv: torch.Tensor, n: int, start: int, R: int, with_rec: bool, staged: int):
    """:func:`chain`'s kernel on a contiguous CUDA int32 ``adv`` that
    :func:`chain` accepts, staged as ``staged`` words
    (:func:`cliff_staged_words`), without its checks."""
    out = torch.empty(1, dtype=torch.int32, device=adv.device)
    recs = torch.empty(REC_WORDS if with_rec else 0, dtype=torch.int32, device=adv.device)
    _build.launch("chain", adv.device, int(bool(with_rec)), adv.data_ptr(), n, staged, start, R,
                  out.data_ptr(), recs.data_ptr())
    return out, recs


def _check_records(rec: torch.Tensor, mode: str) -> None:
    """Refuse a loop count past the record array and any record whose rows
    leave the image (modes of ``vcopy`` and ``iso``)."""
    count = int(rec[COUNT_AT])
    if count > REC_WORDS:
        raise ValueError(f"loop count {count}: records past {REC_WORDS} lie outside the array")
    if mode == "scalar":
        return
    t = torch.arange(max(count, 0), device=rec.device)
    sw, dw = rec[t + REC_HALF] >> 2, rec[t] >> 2
    # 2d and full read and write row + 1; the other row modes one row (or
    # the aligned 8), 3d clamps to tile 15.
    top = IMAGE_WORDS - LANES if mode in ("2d", "full") else IMAGE_WORDS
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


def coissue_vec(tile=None, iters: int = COISSUE_ITERS, device=None):
    """:func:`coissue`'s tile warps at nvec 8 with no scalar chain: the
    vector stream alone, the floor of nvec 8's tile work (a yardstick, not a
    TPU kernel). ``tile`` and ``device`` as for :func:`coissue`. Returns
    ``(count of odd words int32 [1], tile int32 [8, 128])``."""
    iters = int(iters)
    if not 0 <= iters < (1 << 31):
        raise ValueError(f"need 0 <= iters < 2**31, got {iters}")
    if tile is None:
        device = torch.device(device if device is not None else "cuda")
    tile = _tile_or_fill(tile, device)
    if not on_cuda(tile):
        return coissue_vec_plain(tile, iters)
    return launch_coissue_vec(tile, iters)


def launch_coissue_vec(tile: torch.Tensor, iters: int = COISSUE_ITERS):
    """:func:`coissue_vec`'s kernel on a contiguous CUDA int32 [8, 128] tile
    (the ``coissue`` launcher at ``nvec`` -1, counted as ``coissue_vec``)."""
    out = torch.empty(1, dtype=torch.int32, device=tile.device)
    tile_out = torch.empty(TILE, dtype=torch.int32, device=tile.device)
    _build.launch("coissue", tile.device, COISSUE_VEC, 0, iters, tile.data_ptr(),
                  out.data_ptr(), tile_out.data_ptr(), count_as="coissue_vec")
    return out, tile_out


def iso(rec, img, mode: str):
    """One part of the copy body alone, 20 passes over ``rec`` (int32
    [32768], see :func:`iso_records`) and an image of 16,384 int32 words
    (any shape) (``tools/perf_probe_hybrid.py::iso``). Returns ``(checksum
    int32 [1], image int32 [16384])``."""
    if mode not in ISO_MODES:
        raise ValueError(f"unknown mode {mode!r}: one of {ISO_MODES}")
    rec = _int32_vector(rec, "rec", VCOPY_WORDS)
    img = _int32_vector(img, "img", IMAGE_WORDS)
    cuda = on_cuda(rec, img)
    _check_records(rec, mode)
    if not cuda:
        return iso_plain(rec, img, mode)
    return launch_iso(rec, img, mode)


def launch_iso(rec: torch.Tensor, img: torch.Tensor, mode: str):
    """:func:`iso`'s kernel on contiguous CUDA int32 inputs that :func:`iso`
    accepts, without its checks."""
    out = torch.empty(1, dtype=torch.int32, device=rec.device)
    img_out = torch.empty(IMAGE_WORDS, dtype=torch.int32, device=rec.device)
    _build.launch("iso", rec.device, ISO_MODES.index(mode), rec.data_ptr(), img.data_ptr(),
                  out.data_ptr(), img_out.data_ptr())
    return out, img_out


def bprobe(nwhen: int, seed: int = 3, device=None):
    """524,288 iterations of the mix and ``nwhen`` conditional stores on
    ``device`` (the card unless given) (``tools/perf_probe_hybrid.py::bprobe``,
    which passes seed 3). Returns ``(checksum int32 [1], scratch int32
    [64])``."""
    nwhen = int(nwhen)
    if not 0 <= nwhen < 32:
        raise ValueError(f"need 0 <= nwhen < 32, got {nwhen}")
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cpu":
        return bprobe_plain(nwhen, seed)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if nwhen not in BPROBE_NWHEN:
        raise ValueError(f"the kernel is built for nwhen in {BPROBE_NWHEN}, not {nwhen}")
    return launch_bprobe(nwhen, seed, device)


def launch_bprobe(nwhen: int, seed: int, device):
    """:func:`bprobe`'s kernel on a CUDA ``device`` (``nwhen`` in
    :data:`BPROBE_NWHEN`)."""
    out = torch.empty(1, dtype=torch.int32, device=device)
    scratch = torch.empty(SCRATCH_WORDS, dtype=torch.int32, device=device)
    _build.launch("bprobe", device, nwhen, _i32(int(seed)), out.data_ptr(), scratch.data_ptr())
    return out, scratch


def bprobe_floor(seed: int = 3, device=None):
    """``bprobe``'s mix alone over its 524,288 iterations on ``device`` (the
    card unless given): the sum of the ``x`` (int32 [1])."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cpu":
        return bprobe_floor_plain(seed)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return launch_bprobe_floor(seed, device)


def launch_bprobe_floor(seed: int, device):
    """:func:`bprobe_floor`'s kernel on a CUDA ``device`` (the ``bprobe``
    launcher at ``nwhen`` -1, counted as ``bprobe_floor``)."""
    out = torch.empty(1, dtype=torch.int32, device=device)
    _build.launch("bprobe", device, BPROBE_FLOOR, _i32(int(seed)), out.data_ptr(), None,
                  count_as="bprobe_floor")
    return out


def cliff_staged_words(adv: torch.Tensor, n: int, start: int) -> int:
    """Words of :func:`cliff`'s and :func:`chase`'s staged copy of ``adv``
    (``hp::cliff_staged``): ``adv``'s own and, past ``n``, the largest
    advance below ``n`` (a walk's last load lies below ``n`` plus it), in
    16-byte groups. Reads ``adv``: a sync on the card."""
    below = adv[min(start, n) : n]
    max_adv = int(below.max()) if below.numel() else 0
    return (max(adv.numel(), n + max_adv) + 3) & ~3


def _walk_staging(adv, n: int, start: int, R: int, tail: int, what: str):
    """The checked advance array, n, start, R and the staged words of a
    walk (``chain``, ``cliff``, ``chase``) whose block holds ``tail`` words
    after the staged advances (``csrc/hybrid_probes.cu``'s
    ``kWalkTail``)."""
    adv = _int32_vector(adv, "adv")
    n, start, R = int(n), int(start), int(R)
    _check_walk(adv, n, start, R)
    staged = cliff_staged_words(adv, n, start)
    if 4 * (staged + tail) > SMEM_LIMIT:
        raise ValueError(f"an advance array of {adv.numel()} words, staged as {staged}{what}, "
                         "does not fit one block's shared memory")
    return adv, n, start, R, staged


def cliff(adv, n: int, mode: str, start: int = 3, R: int = CHAIN_R):
    """``R`` trials of the walk over ``adv`` (int32 [len]) with ``mode``'s
    body into an image (``tools/perf_probe_hybrid.py::cliff``). Returns
    ``(checksum int32 [1], image int32 [16384])``."""
    if mode not in CLIFF_MODES:
        raise ValueError(f"unknown mode {mode!r}: one of {CLIFF_MODES}")
    # The image and its dummy word follow the staged advances.
    adv, n, start, R, staged = _walk_staging(adv, n, start, R, IMAGE_WORDS + 4, " with the image")
    if not on_cuda(adv):
        return cliff_plain(adv, n, mode, start, R)
    return launch_cliff(adv, n, mode, start, R, staged)


def launch_cliff(adv: torch.Tensor, n: int, mode: str, start: int, R: int, staged: int):
    """:func:`cliff`'s kernel on a contiguous CUDA int32 ``adv`` that
    :func:`cliff` accepts, staged as ``staged`` words
    (:func:`cliff_staged_words`), without its checks."""
    out = torch.empty(1, dtype=torch.int32, device=adv.device)
    img = torch.empty(IMAGE_WORDS, dtype=torch.int32, device=adv.device)
    _build.launch("cliff", adv.device, CLIFF_MODES.index(mode), adv.data_ptr(), n, staged,
                  start, R, out.data_ptr(), img.data_ptr())
    return out, img


def chase(adv, n: int, start: int = 3, R: int = CHAIN_R):
    """``R`` trials of ``cliff``'s walk over ``adv`` with no body: the sum of
    the final ``ip`` (int32 [1]), :func:`chain`'s checksum, whose plain
    version it shares."""
    adv, n, start, R, staged = _walk_staging(adv, n, start, R, 0, "")
    if not on_cuda(adv):
        return chain_plain(adv, n, start, R)[0]
    return launch_chase(adv, n, start, R, staged)


def launch_chase(adv: torch.Tensor, n: int, start: int, R: int, staged: int):
    """:func:`chase`'s kernel on a contiguous CUDA int32 ``adv`` that
    :func:`chase` accepts, staged as ``staged`` words, without its checks."""
    out = torch.empty(1, dtype=torch.int32, device=adv.device)
    _build.launch("chase", adv.device, adv.data_ptr(), n, staged, start, R, out.data_ptr())
    return out


def bitonic(x):
    """One merge pass of the bitonic network over 65,536 int32 keys (any
    shape) and their indices (``tools/perf_probe_hybrid.py::bitonic``).
    Returns ``(keys, vals)``, int32 [512, 128]: the keys after the pass and
    the flat index each came from."""
    x = _int32_vector(x, "x", SORT_N)
    if not on_cuda(x):
        return bitonic_plain(x)
    return launch_bitonic(x)


def launch_bitonic(x: torch.Tensor):
    """:func:`bitonic`'s kernel (one launch of one thread-block cluster) on a
    contiguous CUDA int32 ``x`` of 65,536 words; the kernel reads ``x`` by
    TMA, which needs a 16-byte aligned address, so a view that starts
    elsewhere is copied first."""
    if x.data_ptr() % 16:
        x = x.clone()
    keys = torch.empty(SORT_SHAPE, dtype=torch.int32, device=x.device)
    vals = torch.empty(SORT_SHAPE, dtype=torch.int32, device=x.device)
    _build.launch("bitonic", x.device, x.data_ptr(), keys.data_ptr(), vals.data_ptr())
    return keys, vals
