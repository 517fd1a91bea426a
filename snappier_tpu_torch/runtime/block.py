"""Block-format runtime: the public compress/decompress API over the CUDA
kernels (port of ``snappier_tpu/runtime/block.py``).

The equivalent of the reference's ``Snappy`` static facade
(``Snappier/Snappy.cs``): whole-buffer compress/decompress, Try* variants
writing into caller buffers, ``*_to_memory`` pooled results and size
queries, plus the batched entry points the card wants (N independent
64 KiB fragments in one launch).

Engines: ``"cuda"`` runs the device kernels (greedy or best-mode encode,
decode), ``"native"`` the C++ host runtime, ``"oracle"`` the NumPy scalar
codec. The device engine itself comes in two kinds
(:func:`snappier_tpu_torch.models.codec.default_kernel`): the CUDA kernels
(``scalar``) or, with ``SNAPPIER_KERNEL=scan`` in the environment, the
parallel-scan engine, which is tensor code on either device. ``"auto"`` resolves to ``"cuda"``, because the port's entry points
run on the card unless the caller asks otherwise; the JAX package's
``"auto"`` prefers the native engine instead (its ``_pick_engine``).
``device=None`` puts the device engine on the card and raises without
one; ``device="cpu"`` runs each kernel's plain version.

Transfers: inputs cross to the card as uint8 fragment rows. A decode knows
its output sizes before it runs (the length preamble, the prescan
records), so the decoded rows are compacted on the card and fetched with
their lengths and error words in one device-to-host copy. An encode
fetches its body lengths, then the compacted bodies at their exact size.
The JAX facade also fetched an optimistic prefix of the bodies in the same
round trip and padded shapes to capacity buckets; both existed for its
28 ms host-link round trips and its per-shape compiles, which a
PCIe-attached card running eager kernels does not have.
"""

from __future__ import annotations

import numpy as np
import torch

from snappier_tpu_torch.constants import (
    BLOCK_SIZE,
    max_compressed_length,
    min_compressed_length,
    plausible_uncompressed_bound,
)
from snappier_tpu_torch.errors import (
    BufferTooSmallError,
    InvalidDataError,
    InvalidOperationError,
)
from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.format.varint import read_varint, write_varint
from snappier_tpu_torch.models.codec import (
    compact_words,
    decode_rows,
    default_kernel,
    encode_rows,
    pack_rows,
    resolve_device,
)
from snappier_tpu_torch.ops.best_match import exact_candidates
from snappier_tpu_torch.ops.cuda.scalar_codec import HASH_BITS, _encode_best
from snappier_tpu_torch.ops.decode import (
    ERR_BAD_OFFSET,
    ERR_BAD_PREAMBLE,
    ERR_LENGTH_MISMATCH,
    ERR_TRUNCATED_TAG,
)
from snappier_tpu_torch.runtime import native, prescan
from snappier_tpu_torch.utils.pool import PooledMemory, default_pool
from snappier_tpu_torch.utils.profiling import span

_ERR_MESSAGES = [
    (ERR_TRUNCATED_TAG, "tag overruns compressed input"),
    (ERR_BAD_OFFSET, "copy offset out of range"),
    (ERR_LENGTH_MISMATCH, "tag stream does not match length preamble"),
    (ERR_BAD_PREAMBLE, "bad length preamble"),
]

_ENGINES = ("cuda", "native", "oracle")


def _pick_engine(engine: str) -> str:
    if engine == "auto":
        return "cuda"
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine {engine!r}: 'auto' or one of {_ENGINES}")
    return engine


def _as_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return data.astype(np.uint8, copy=False).ravel()
    return np.frombuffer(bytes(data), dtype=np.uint8)


def _device_kernel() -> str:
    """The device engine's kind, ``"scalar"`` or ``"scan"``: one shared
    choice (models.codec.default_kernel)."""
    return default_kernel()


def _raise_for_err(err: int) -> None:
    if err:
        reasons = [m for bit, m in _ERR_MESSAGES if err & bit]
        raise InvalidDataError("; ".join(reasons) or f"error {err}")


def _fragment_rows(arr: np.ndarray):
    """``arr`` as zero-padded 64 KiB rows and their lengths (at least one
    row, so an empty input encodes to an empty body)."""
    n = len(arr)
    nfrags = max(1, -(-n // BLOCK_SIZE))
    frags = np.zeros((nfrags, BLOCK_SIZE), np.uint8)
    frags.reshape(-1)[:n] = arr
    lengths = np.full(nfrags, BLOCK_SIZE, np.int32)
    lengths[-1] = n - (nfrags - 1) * BLOCK_SIZE
    return frags, lengths


def _rows_from_flat(flat_h: np.ndarray, lens_h: np.ndarray) -> list[np.ndarray]:
    """Split a fetched compacted word buffer back into per-row uint8 views
    (row i occupies ceil(lens[i] / 4) words)."""
    buf = flat_h.view(np.uint8)
    offs = np.concatenate([[0], np.cumsum((np.asarray(lens_h, np.int64) + 3) >> 2)]) * 4
    return [buf[int(offs[j]) : int(offs[j]) + int(lens_h[j])] for j in range(len(lens_h))]


def _fetch_ragged_packed(packed: torch.Tensor, lens_h: np.ndarray) -> list[np.ndarray]:
    """Fetch the first ``lens_h[i]`` bytes of each word-packed row in one
    device-to-host copy of their exact size: the rows are compacted end to
    end on their device first (``compact_words``). Returns per-row uint8
    views."""
    wlens_h = (np.asarray(lens_h, np.int64) + 3) >> 2
    wlens = torch.as_tensor(wlens_h, dtype=torch.int32).to(packed.device)
    flat = compact_words(packed, wlens, int(wlens_h.sum()))
    return _rows_from_flat(flat.cpu().numpy(), lens_h)


# --- Batched device entry points -------------------------------------------


def _encode_rows(fs: torch.Tensor, ls: torch.Tensor, kernel: str, hash_bits: int,
                 skip_base: int):
    """Encode uint8 fragment rows on their device: (bodies uint8 [B, W],
    body_lens) with W = body_width(F) >= F + 2048."""
    if kernel == "best":
        return _encode_best(fs, ls, exact_candidates(fs, ls), skip_base)
    return encode_rows(fs, ls, kernel, hash_bits, skip_base)


def compress_fragments(frags, lengths, hash_bits: int = HASH_BITS, skip_base: int = 32,
                       kernel: str | None = None, device=None):
    """Compress a batch of fragments on the device.

    Args:
      frags: byte-valued [B, F] rows (numpy or torch), F <= BLOCK_SIZE,
        zero-padded past each length.
      lengths: [B] actual lengths (0..F).
      hash_bits: greedy-encoder match-table size log2 (8..16).
      skip_base: skip-heuristic start constant (SnappyCompressor.cs:227).
      kernel: ``"scalar"`` (the greedy CUDA kernel), ``"scan"`` (the
        parallel-scan engine, which ignores the two tunables above),
        ``"best"`` (``level="best"``: exact candidates and the best-mode
        walk) or None for the process-wide choice (``default_kernel``).
      device: as for :func:`compress`.

    Returns (bodies uint8 [B, F + 2048], body_lens int32 [B]) on the
    device: fragment tag streams without varint preambles.
    """
    dev = resolve_device(device)
    fs = torch.as_tensor(frags).to(device=dev, dtype=torch.uint8)
    ls = torch.as_tensor(lengths).to(device=dev, dtype=torch.int32)
    bodies, body_lens = _encode_rows(fs, ls, kernel or _device_kernel(), hash_bits, skip_base)
    return bodies[:, : fs.shape[1] + 2048], body_lens


def check_body_lens(bodies_width: int, body_lens: np.ndarray) -> None:
    """Hard-fail if any emitted body length exceeds its output slot.

    The emission bound (constants.greedy_emit_bound) makes this impossible
    for a correct kernel; the check turns a bound violation into a loud
    error instead of a silently truncated stream."""
    worst = int(np.max(body_lens)) if len(body_lens) else 0
    if worst > bodies_width:
        raise RuntimeError(
            f"encoder emitted {worst} bytes into a {bodies_width}-byte slot — emission bound "
            "violated (kernel bug)"
        )


def decompress_blocks(comp, comp_lens, out_cap: int, device=None):
    """Decode a batch of full blocks (varint preamble + tags) on the
    device. Returns (outs uint8 [B, out_cap], out_lens [B], errs [B])."""
    dev = resolve_device(device)
    return decode_rows(torch.as_tensor(comp).to(device=dev, dtype=torch.uint8),
                       torch.as_tensor(comp_lens).to(device=dev, dtype=torch.int32),
                       out_cap, _device_kernel())


def _device_bodies(arr: np.ndarray, level: str, dev: torch.device):
    """Fragment ``arr`` into 64 KiB rows, compress the batch on ``dev`` and
    return the host-fetched (per-row byte views, body_lens). Each step is a
    span: the host's fragmenting, the copy to ``dev``, the encode, the wait
    for the body lengths and the fetch of the bodies."""
    with span("block.fragment", len(arr)):
        frags, lengths = _fragment_rows(arr)
    with span("block.copy_in", frags.nbytes):
        fs = torch.from_numpy(frags).to(dev)
        ls = torch.from_numpy(lengths).to(dev)
        del frags  # a card's copy is done with the host rows: free them inside the span
    with span("block.encode"):
        bodies, body_lens = _encode_rows(fs, ls, "best" if level == "best" else _device_kernel(),
                                         HASH_BITS, 32)
    with span("block.wait"):
        lens_h = body_lens.cpu().numpy()
        check_body_lens(fs.shape[1] + 2048, lens_h)
    with span("block.fetch"):
        return _fetch_ragged_packed(pack_rows(bodies), lens_h), lens_h


def _decode_compact(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int, capw: int):
    """Decode, word-pack and compact the rows end to end into ``capw``
    words: (flat int32 [capw], out_lens, errs), all on the device."""
    outs, out_lens, errs = decode_rows(comp, comp_lens, out_cap, _device_kernel())
    return compact_words(pack_rows(outs), (out_lens + 3) >> 2, capw), out_lens, errs


def _decode_rows_device(comp: np.ndarray, comp_lens: np.ndarray, out_lens_exp,
                        out_cap: int, dev: torch.device) -> list[np.ndarray]:
    """Decode blocks on ``dev`` whose output lengths are known, fetch the
    decoded rows with their lengths and error words in one copy, and
    return per-row uint8 views after checking every error word and
    expected length."""
    exp = np.asarray(out_lens_exp, np.int64)
    B = len(exp)
    flat, out_lens, errs = _decode_compact(
        torch.from_numpy(np.ascontiguousarray(comp, np.uint8)).to(dev),
        torch.as_tensor(comp_lens, dtype=torch.int32).to(dev),
        out_cap, int(((exp + 3) >> 2).sum()))
    host = torch.cat([out_lens, errs, flat]).cpu().numpy()
    out_lens_h, errs_h = host[:B], host[B : 2 * B]
    for i in range(B):
        _raise_for_err(int(errs_h[i]))
        if int(out_lens_h[i]) != int(exp[i]):
            raise InvalidDataError("fragment output length mismatch")
    return _rows_from_flat(host[2 * B :], out_lens_h)


def _host_decode(arr: np.ndarray) -> bytes:
    """Serial host decode of a stream the device path cannot split: a copy
    reaches across a 64 KiB output line (legal per the wire format, emitted
    by no known encoder), which the reference decodes with its whole-output
    lookback buffer (SnappyDecompressor.cs:43-184). Format semantics, not a
    device fallback."""
    if native.available():
        return native.decompress(arr.tobytes())
    return oracle.decompress(arr)


def _decompress_device(arr: np.ndarray, dev: torch.device):
    """Device decode of a whole block-format buffer: one block for outputs
    up to 64 KiB, else the prescan's fragment rows as one batch. Returns
    the plaintext as a uint8 array (or bytes from the host decode)."""
    expected, _ = read_varint(arr)  # validates the preamble host-side
    if expected > plausible_uncompressed_bound(len(arr)):
        raise InvalidDataError("length preamble exceeds possible expansion")
    if expected <= BLOCK_SIZE:
        rows = _decode_rows_device(np.array(arr[None, :]), [len(arr)], [expected],
                                   max(16, -(-expected // 16) * 16), dev)
        return rows[0]
    recs = prescan.scan_fragments(arr)
    if recs is None:
        return _host_decode(arr)
    comp, comp_lens, out_lens_exp = prescan.assemble_fragment_rows(arr, recs)
    return np.concatenate(_decode_rows_device(comp, comp_lens, out_lens_exp, BLOCK_SIZE, dev))


# --- Public single-buffer API (Snappy.cs facade parity) ---------------------


def compress(data, engine: str = "auto", level: str = "fast", device=None) -> bytes:
    """Compress a buffer in the Snappy block format.
    Parity: ``Snappy.CompressToArray`` (Snappy.cs:123).

    ``level="fast"`` is the greedy encoder; ``level="best"`` drives the
    best-mode walk with exact-nearest multi-width candidates
    (ops/best_match.py), denser at more cost. ``"best"`` needs the device
    engine; host engines raise ``ValueError``."""
    if level not in ("fast", "best"):
        raise ValueError(f"unknown level {level!r}")
    if level == "best" and engine not in ("auto", "cuda"):
        raise ValueError("level='best' requires the device engine")
    engine = _pick_engine(engine)
    arr = _as_u8(data)
    with span(f"block.compress[{engine}]", len(arr)):
        if engine == "native":
            return native.compress(arr.tobytes())
        if engine == "oracle":
            return oracle.compress(arr)
        rows, _ = _device_bodies(arr, level, resolve_device(device))
        with span("block.join"):
            out = write_varint(len(arr)) + b"".join(row.tobytes() for row in rows)
            del rows  # free the fetched bodies inside the span
        return out


def decompress(data, engine: str = "auto", device=None) -> bytes:
    """Decompress a Snappy block-format buffer.
    Parity: ``Snappy.DecompressToArray`` (Snappy.cs:273). Raises
    :class:`InvalidDataError` on malformed input."""
    engine = _pick_engine(engine)
    arr = _as_u8(data)
    with span(f"block.decompress[{engine}]", len(arr)):
        if engine == "native":
            return native.decompress(arr.tobytes())
        if engine == "oracle":
            return oracle.decompress(arr)
        return bytes(_decompress_device(arr, resolve_device(device)))


def get_uncompressed_length(data) -> int:
    """Parity: ``Snappy.GetUncompressedLength`` (Snappy.cs:142)."""
    value, _ = read_varint(_as_u8(data))
    return value


def get_max_compressed_length(n: int) -> int:
    """Parity: ``Snappy.GetMaxCompressedLength`` (Snappy.cs:20-24)."""
    return max_compressed_length(n)


def _check_overlap(data, out) -> None:
    """Reject overlapping input and output buffers, as the reference does
    (SnappyCompressor.cs:27, SnappyTests.cs:204-210). Only buffer views
    can alias."""
    try:
        a = np.frombuffer(memoryview(data), np.uint8)
        b = np.frombuffer(memoryview(out), np.uint8)
    except (TypeError, ValueError):
        return
    if a.size and b.size and np.shares_memory(a, b):
        raise InvalidOperationError("input and output buffers overlap")


def _write_at(out, pos: int, blob) -> None:
    """Write a contiguous uint8 array or bytes into out[pos:] in place, one
    byte per element of ``out``."""
    if isinstance(out, np.ndarray):
        if not isinstance(blob, np.ndarray):
            blob = np.frombuffer(blob, np.uint8)
        out[pos : pos + len(blob)] = blob
    elif isinstance(blob, np.ndarray):
        out[pos : pos + len(blob)] = memoryview(np.ascontiguousarray(blob))
    else:
        out[pos : pos + len(blob)] = blob


def _write_full_checked(out, plain) -> int:
    """Write a complete result into ``out`` (capacity-checked)."""
    if len(out) < len(plain):
        raise BufferTooSmallError(f"need {len(plain)} bytes, destination holds {len(out)}")
    _write_at(out, 0, plain)
    return len(plain)


def _compress_into_checked(arr: np.ndarray, out, engine: str, device) -> int:
    """Compress ``arr`` into ``out`` (Snappy.cs:37 shape): the native
    engine emits straight into the caller's buffer, the device path writes
    the preamble and each fetched fragment body at its offset. Raises
    BufferTooSmallError when the result does not fit."""
    engine = _pick_engine(engine)
    if engine == "native":
        return native.compress_into(arr.tobytes(), out)
    if engine == "oracle":
        return _write_full_checked(out, oracle.compress(arr))
    rows, body_lens = _device_bodies(arr, "fast", resolve_device(device))
    pre = write_varint(len(arr))
    total = len(pre) + int(body_lens.sum())
    if len(out) < total:
        raise BufferTooSmallError(f"need {total} bytes, destination holds {len(out)}")
    _write_at(out, 0, pre)
    pos = len(pre)
    for row in rows:
        _write_at(out, pos, row)
        pos += len(row)
    return total


def compress_into(data, out, engine: str = "auto", device=None) -> int:
    """Compress into a caller buffer; returns bytes written.
    Parity: ``Snappy.Compress(input, output)`` (Snappy.cs:37)."""
    _check_overlap(data, out)
    arr = _as_u8(data)
    if len(out) < min_compressed_length(len(arr)):
        # Fail fast, before any device work (Snappy.cs:37-52).
        raise BufferTooSmallError(
            f"destination ({len(out)} bytes) is below the minimum possible compressed size"
        )
    return _compress_into_checked(arr, out, engine, device)


def try_compress(data, out, engine: str = "auto", device=None) -> tuple[bool, int]:
    """Parity: ``Snappy.TryCompress`` (Snappy.cs:55)."""
    _check_overlap(data, out)
    arr = _as_u8(data)
    if len(out) < min_compressed_length(len(arr)):
        return False, 0  # fail fast, no device work
    try:
        return True, _compress_into_checked(arr, out, engine, device)
    except BufferTooSmallError:
        return False, 0


def _decompress_into_checked(arr: np.ndarray, out, engine: str, device) -> int:
    """Decompress ``arr`` into ``out``: the native engine decodes straight
    into the caller's memory; the other engines write their result."""
    engine = _pick_engine(engine)
    if engine == "native":
        return native.decompress_into(arr.tobytes(), out)
    if engine == "oracle":
        return _write_full_checked(out, oracle.decompress(arr))
    return _write_full_checked(out, _decompress_device(arr, resolve_device(device)))


def decompress_into(data, out, engine: str = "auto", device=None) -> int:
    """Decompress into a caller buffer; returns bytes written.
    Parity: ``Snappy.Decompress(input, output)`` (Snappy.cs:153)."""
    _check_overlap(data, out)
    arr = _as_u8(data)
    if len(out) < get_uncompressed_length(arr):
        # Fail fast on the claimed length (SnappyDecompressor.cs:43-63).
        raise BufferTooSmallError(
            f"destination ({len(out)} bytes) is below the stream's claimed uncompressed length"
        )
    return _decompress_into_checked(arr, out, engine, device)


def try_decompress(data, out, engine: str = "auto", device=None) -> tuple[bool, int]:
    """Parity: ``Snappy.TryDecompress`` (Snappy.cs:172). Malformed input
    still raises; only an undersized destination returns False."""
    _check_overlap(data, out)
    arr = _as_u8(data)
    if len(out) < get_uncompressed_length(arr):
        return False, 0  # fail fast, no device work
    try:
        return True, _decompress_into_checked(arr, out, engine, device)
    except BufferTooSmallError:
        return False, 0


def compress_to_memory(data, engine: str = "auto", device=None):
    """Compress into a pooled buffer the caller hands back.
    Parity: ``Snappy.CompressToMemory`` (Snappy.cs:99-121): the returned
    :class:`~snappier_tpu_torch.utils.pool.PooledMemory` owns a pool-rented
    buffer sliced to the result; ``release()`` (or the context manager)
    returns it, zeroized, to the pool."""
    arr = _as_u8(data)
    buf = default_pool.rent(1 << max(10, (max_compressed_length(len(arr)) - 1).bit_length()),
                            np.uint8)
    try:
        n = _compress_into_checked(arr, buf, engine, device)
    except BaseException:
        buf[:] = 0  # partial result: zeroize like release() before pooling
        default_pool.giveback(buf)
        raise
    return PooledMemory(buf, n, default_pool)


def decompress_to_memory(data, engine: str = "auto", device=None):
    """Decompress into a pooled buffer the caller hands back.
    Parity: ``Snappy.DecompressToMemory`` (Snappy.cs:223-271)."""
    arr = _as_u8(data)
    expected = get_uncompressed_length(arr)
    if expected > plausible_uncompressed_bound(len(arr)):
        raise InvalidDataError("length preamble exceeds possible expansion")
    buf = default_pool.rent(1 << max(10, (max(expected, 1) - 1).bit_length()), np.uint8)
    try:
        n = _decompress_into_checked(arr, buf, engine, device)
    except BaseException:
        buf[:] = 0  # partial plaintext: zeroize like release() before pooling
        default_pool.giveback(buf)
        raise
    return PooledMemory(buf, n, default_pool)
