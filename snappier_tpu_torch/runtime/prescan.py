"""Full-file device decode: tag-boundary prescan + fragment assembly (port
of ``snappier_tpu/runtime/prescan.py``).

The reference decoder handles any input size serially with one big
lookback buffer (SnappyDecompressor.cs:43-184). The device path wants
block-granular work items instead, one CUDA block each: this module
splits a block-format stream at exact 64 KiB *output* boundaries by
walking tag headers (literal payloads are skipped, so the walk touches
a few bytes per tag), then re-wraps each fragment as a standalone
block for the batched device kernels.

Literal tags are splittable — a straddling literal becomes a synthetic
tail literal for one fragment plus a synthetic lead literal for the
next (the same bytes, re-tagged). Copies are not: the wire format
permits a copy to reach across a 64 KiB output line, but every known
encoder (the reference, google/snappy, this framework) resets its
window per fragment and never emits one. When such a copy appears the
scan reports a window crossing and the caller decodes host-side.

The scan itself runs through the native runtime when available
(``stpu_scan_fragments``, GB/s-class) with this module's Python walk
as the hermetic fallback.
"""

from __future__ import annotations

import numpy as np

from snappier_tpu_torch.constants import BLOCK_SIZE
from snappier_tpu_torch.errors import InvalidDataError
from snappier_tpu_torch.format.varint import read_varint, write_varint
from snappier_tpu_torch.runtime import native

#: Fragment record columns (mirrors snappy_core.cpp stpu_scan_fragments).
TAGS_BEGIN, TAGS_END, LEAD_SRC, LEAD_LEN, TAIL_SRC, TAIL_LEN, OUT_LEN = range(7)


def scan_fragments_py(arr: np.ndarray, fragment_size: int = BLOCK_SIZE):
    """Pure-Python fragment scan. Returns int64 [nf, 7] records, or
    None if a copy crosses a fragment output boundary. Raises
    InvalidDataError on malformed streams.

    ``fragment_size`` is the output line the stream is split at —
    BLOCK_SIZE in production (the format's window; no known encoder
    emits copies across it). Streams that cross a smaller line return
    None like any window crossing.

    PERFORMANCE WARNING: this walks every tag in a Python loop
    (~1-2 MB/s of compressed input). It exists only as the fallback
    when the C++ library is unavailable (``SNAPPIER_NO_NATIVE=1`` or no
    toolchain); multi-megabyte device decodes without the native
    scanner are minutes-slow — correct, but the wrong tool. The native
    ``stpu_scan_fragments`` (snappy_core.cpp) is ~1000x faster."""
    BLOCK = fragment_size
    buf = arr
    n = len(buf)
    expected, ip = read_varint(buf)
    recs: list[list[int]] = []
    op = 0
    frag_start = 0
    tags_begin = ip
    lead_src = lead_len = 0

    def close(tags_end, tail_src, tail_len, out_len):
        recs.append(
            [tags_begin, tags_end, lead_src, lead_len, tail_src, tail_len,
             out_len]
        )

    while ip < n:
        frag_end = frag_start + BLOCK
        tag = int(buf[ip])
        ttype = tag & 3
        if ttype == 0:
            len6 = tag >> 2
            hdr = 1
            if len6 < 60:
                length = len6 + 1
            else:
                extra = len6 - 59
                if ip + 1 + extra > n:
                    raise InvalidDataError("tag overruns compressed input")
                length = (
                    int.from_bytes(bytes(buf[ip + 1 : ip + 1 + extra]),
                                   "little") + 1
                )
                hdr += extra
            if ip + hdr + length > n:
                raise InvalidDataError("tag overruns compressed input")
            if op + length > expected:
                raise InvalidDataError("tag stream does not match preamble")
            if op + length <= frag_end:
                op += length
                ip += hdr + length
            else:
                take = frag_end - op
                close(ip, ip + hdr, take, BLOCK)
                src = ip + hdr + take
                rem = length - take
                while rem >= BLOCK:
                    lead_src, lead_len = src, BLOCK
                    tags_begin = ip + hdr + length
                    close(tags_begin, 0, 0, BLOCK)
                    src += BLOCK
                    rem -= BLOCK
                    frag_start += BLOCK
                lead_src, lead_len = src, rem
                tags_begin = ip + hdr + length
                frag_start += BLOCK
                op += length
                ip += hdr + length
                continue
        else:
            if ttype == 1:
                if ip + 2 > n:
                    raise InvalidDataError("tag overruns compressed input")
                length = ((tag >> 2) & 7) + 4
                offset = ((tag >> 5) << 8) | int(buf[ip + 1])
                hdr = 2
            elif ttype == 2:
                if ip + 3 > n:
                    raise InvalidDataError("tag overruns compressed input")
                length = (tag >> 2) + 1
                offset = int(buf[ip + 1]) | (int(buf[ip + 2]) << 8)
                hdr = 3
            else:
                if ip + 5 > n:
                    raise InvalidDataError("tag overruns compressed input")
                length = (tag >> 2) + 1
                offset = int.from_bytes(bytes(buf[ip + 1 : ip + 5]), "little")
                hdr = 5
            if offset == 0 or offset > op:
                raise InvalidDataError("copy offset out of range")
            if op + length > expected:
                raise InvalidDataError("tag stream does not match preamble")
            if op + length > frag_end or offset > op - frag_start:
                return None  # window crossing: host-serial decode
            op += length
            ip += hdr
        if op == frag_start + BLOCK and ip < n:
            close(ip, 0, 0, BLOCK)
            tags_begin = ip
            lead_src = lead_len = 0
            frag_start = op
    if op != expected:
        raise InvalidDataError("tag stream does not match preamble")
    if op > frag_start or lead_len > 0 or tags_begin < ip or not recs:
        close(ip, 0, 0, op - frag_start)
    return np.asarray(recs, np.int64).reshape(-1, 7)


def scan_fragments(arr: np.ndarray, fragment_size: int = BLOCK_SIZE):
    """Native scan when available, Python walk otherwise. The native
    scanner is hardwired to the production BLOCK_SIZE line; another
    ``fragment_size`` takes the Python walk."""
    if fragment_size == BLOCK_SIZE and native.available():
        return native.scan_fragments(arr.tobytes())
    return scan_fragments_py(arr, fragment_size)


def _literal_tag(length: int) -> bytes:
    """Synthetic literal tag bytes for a split slice (wire law:
    SnappyCompressor.cs:436-464)."""
    if length <= 60:
        return bytes([(length - 1) << 2])
    v = length - 1
    extra = 1 if v < (1 << 8) else 2 if v < (1 << 16) else 3
    return bytes([(59 + extra) << 2]) + v.to_bytes(extra, "little")


def assemble_fragment_rows(arr: np.ndarray, recs: np.ndarray):
    """Build the device batch for a fragment scan: each record becomes
    a standalone block (varint preamble + synthetic lead literal +
    complete tags + synthetic tail literal).

    Returns (comp uint8 [nf, cap], comp_lens int32 [nf],
    out_lens int64 [nf]) with cap padded to a multiple of 1024."""
    rows: list[bytes] = []
    for r in recs:
        parts = [write_varint(int(r[OUT_LEN]))]
        if r[LEAD_LEN] > 0:
            parts.append(_literal_tag(int(r[LEAD_LEN])))
            parts.append(
                bytes(arr[int(r[LEAD_SRC]) : int(r[LEAD_SRC] + r[LEAD_LEN])])
            )
        parts.append(bytes(arr[int(r[TAGS_BEGIN]) : int(r[TAGS_END])]))
        if r[TAIL_LEN] > 0:
            parts.append(_literal_tag(int(r[TAIL_LEN])))
            parts.append(
                bytes(arr[int(r[TAIL_SRC]) : int(r[TAIL_SRC] + r[TAIL_LEN])])
            )
        rows.append(b"".join(parts))
    cap = max(len(x) for x in rows) + 8
    cap = -(-cap // 1024) * 1024
    comp = np.zeros((len(rows), cap), np.uint8)
    comp_lens = np.zeros(len(rows), np.int32)
    for i, x in enumerate(rows):
        comp[i, : len(x)] = np.frombuffer(x, np.uint8)
        comp_lens[i] = len(x)
    return comp, comp_lens, recs[:, OUT_LEN].copy()
