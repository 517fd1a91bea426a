"""ctypes bindings to the C++ host runtime (``native/snappy_core.cpp``), the
port's own copy of ``snappier_tpu/runtime/native.py`` for the block API.

The C++ engine is framework-neutral and shared with the JAX package: the
library ``native/libsnappy_core.so`` is built on demand by ``make`` with the
system compiler, under a cross-process lock file, and the entry points
raise ``RuntimeError`` when no toolchain or library is available.
``SNAPPIER_NO_NATIVE=1`` disables it. It serves the ``engine="native"``
block and stream calls, the fragment prescan of multi-block device decodes
and the host CRC32C of the stream layer.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
import time

import numpy as np

from snappier_tpu_torch.constants import plausible_uncompressed_bound
from snappier_tpu_torch.errors import BufferTooSmallError, InvalidDataError
from snappier_tpu_torch.utils.pool import default_pool

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_SO = _NATIVE_DIR / "libsnappy_core.so"

_lock = threading.Lock()
_lib = None
_load_failed = False

_OK, _INVALID, _TOO_SMALL, _WINDOW_CROSS = 0, 1, 2, 3


def _build() -> bool:
    """Run ``make`` under an O_EXCL lock file shared with every other
    process (the JAX package's wrapper included): a relink while another
    process opens the library would hand it a half-written file."""
    lockfile = _NATIVE_DIR / ".build.lock"
    deadline = time.monotonic() + 150
    acquired = False
    while time.monotonic() < deadline:
        try:
            os.close(os.open(lockfile, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            acquired = True
            break
        except FileExistsError:
            try:
                if time.time() - lockfile.stat().st_mtime > 180:
                    lockfile.unlink(missing_ok=True)  # stale holder
                    continue
            except OSError:
                pass
            time.sleep(0.1)
    if not acquired:
        return _SO.exists()  # let an existing build stand
    try:
        subprocess.run(["make", "-s", "libsnappy_core.so"], cwd=_NATIVE_DIR, check=True,
                       capture_output=True, timeout=120)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        lockfile.unlink(missing_ok=True)


_BUF_FN = [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
           ctypes.POINTER(ctypes.c_size_t)]
_SIGNATURES = {  # symbol -> (restype, argtypes)
    "stpu_max_compressed_length": (ctypes.c_size_t, [ctypes.c_size_t]),
    "stpu_compress": (ctypes.c_int, _BUF_FN),
    "stpu_decompress": (ctypes.c_int, _BUF_FN),
    "stpu_compress_mt": (ctypes.c_int, _BUF_FN + [ctypes.c_int]),
    "stpu_decompress_mt": (ctypes.c_int, _BUF_FN + [ctypes.c_int]),
    "stpu_uncompressed_length": (
        ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64)]),
    "stpu_match_length_test": (
        ctypes.c_size_t, [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t]),
    "stpu_scan_fragments": (
        ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64),
                       ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]),
    "stpu_crc32c": (ctypes.c_uint32, [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]),
    "stpu_stream_max_compressed_length": (ctypes.c_size_t, [ctypes.c_size_t]),
    "stpu_stream_uncompressed_length": (
        ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64)]),
    "stpu_stream_compress": (ctypes.c_int, _BUF_FN),
    "stpu_stream_decompress": (ctypes.c_int, _BUF_FN),
    "stpu_stream_compress_mt": (ctypes.c_int, _BUF_FN + [ctypes.c_int]),
    "stpu_stream_decompress_mt": (ctypes.c_int, _BUF_FN + [ctypes.c_int]),
}


def load():
    """The loaded library, or None if unavailable. Runs ``make`` once per
    process (a no-op when the library is fresh; the library is not
    committed, and a stale build missing newer entry points is worse than
    the probe)."""
    global _lib, _load_failed
    if os.environ.get("SNAPPIER_NO_NATIVE"):
        return None
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not _build() and not _SO.exists():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_SO))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
        except (OSError, AttributeError):
            _load_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _require():
    lib = load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    return lib


def _writable_view(out):
    """A writable uint8 view when ``out``'s raw memory IS its element
    sequence, None when the staging path must handle it; raises TypeError
    for read-only buffers (the C engine would write through them)."""
    try:
        mv = memoryview(out)
    except TypeError:
        return None
    if mv.readonly:
        raise TypeError("destination buffer is read-only")
    if mv.itemsize == 1 and not (isinstance(out, np.ndarray) and out.dtype != np.uint8):
        try:
            return np.frombuffer(mv, np.uint8)
        except (ValueError, BufferError, TypeError):
            return None  # non-contiguous / exotic buffer: stage instead
    return None


def _stage_writeback(out, view, stage, n: int) -> int:
    """Copy ``stage[:n]`` into the destination with one byte per ELEMENT
    (the device and oracle engines' layout). Raises BufferTooSmallError
    when it does not fit."""
    cap_avail = view.size if view is not None else len(out)
    if n > cap_avail:
        raise BufferTooSmallError(f"need {n} bytes, destination holds {cap_avail}")
    if view is not None:
        view[:n] = stage[:n]
    elif isinstance(out, np.ndarray):
        out[:n] = stage[:n]  # per-element, cast to out's dtype
    else:
        a = np.asarray(out)
        if not a.flags.owndata:
            a[:n] = stage[:n]
        else:
            out[:n] = stage[:n].tobytes()
    return n


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _block_compress_raw(lib, data: bytes, out, cap: int, threads: int) -> int:
    """One stpu_(compress|compress_mt) call; returns bytes written.
    ``threads``: 0 = hardware concurrency (the MT path serializes below 8
    fragments), 1 = serial; the bytes are the same at every count."""
    out_len = ctypes.c_size_t()
    if threads != 1:
        rc = lib.stpu_compress_mt(data, len(data), out, cap, ctypes.byref(out_len), threads)
    else:
        rc = lib.stpu_compress(data, len(data), out, cap, ctypes.byref(out_len))
    if rc != _OK:
        raise InvalidDataError(f"native compress failed rc={rc}")
    return out_len.value


def compress(data: bytes, threads: int = 0) -> bytes:
    lib = _require()
    data = bytes(data)
    cap = lib.stpu_max_compressed_length(len(data))
    arr = np.empty(cap, np.uint8)
    return arr[: _block_compress_raw(lib, data, _ptr(arr), cap, threads)].tobytes()


def compress_into(data: bytes, out, threads: int = 0) -> int:
    """Compress into the writable buffer ``out``: straight into its memory
    when it is a byte-shaped buffer of at least the worst-case size, else
    through a pooled stage. Returns bytes written; raises
    BufferTooSmallError when the result does not fit."""
    lib = _require()
    data = bytes(data)
    cap = lib.stpu_max_compressed_length(len(data))
    view = _writable_view(out)
    if view is not None and view.size >= cap:
        return _block_compress_raw(lib, data, _ptr(view), view.size, threads)
    # Power-of-two stage sizes bound the pool's bucket count.
    stage = default_pool.rent(1 << max(10, (max(cap, 1) - 1).bit_length()), np.uint8)
    try:
        n = _block_compress_raw(lib, data, _ptr(stage), stage.size, threads)
        return _stage_writeback(out, view, stage, n)
    finally:
        default_pool.giveback(stage)


def _block_decompress_raw(lib, data: bytes, out, cap: int, threads: int) -> int:
    out_len = ctypes.c_size_t()
    if threads != 1:
        rc = lib.stpu_decompress_mt(data, len(data), out, cap, ctypes.byref(out_len), threads)
    else:
        rc = lib.stpu_decompress(data, len(data), out, cap, ctypes.byref(out_len))
    if rc == _INVALID:
        raise InvalidDataError("malformed snappy block data")
    if rc == _TOO_SMALL:
        raise BufferTooSmallError("output buffer too small")
    return out_len.value


def _preamble_length(lib, data: bytes) -> int:
    val = ctypes.c_uint64()
    if lib.stpu_uncompressed_length(data, len(data), ctypes.byref(val)) != _OK:
        raise InvalidDataError("bad length preamble")
    return val.value


def get_uncompressed_length(data: bytes) -> int:
    """The length preamble of a block-format buffer."""
    return _preamble_length(_require(), bytes(data))


def _expected_length(lib, data: bytes) -> int:
    expected = _preamble_length(lib, data)
    if expected > plausible_uncompressed_bound(len(data)):
        raise InvalidDataError("length preamble exceeds possible expansion")
    return expected


def decompress(data: bytes, threads: int = 1) -> bytes:
    """Block-format decompress; ``threads`` defaults to the serial
    decoder (bytes and verdicts are the same at every count)."""
    lib = _require()
    data = bytes(data)
    expected = _expected_length(lib, data)
    # +64 slack: the native decoder's wide copies spill past the end.
    arr = np.empty(expected + 64, np.uint8)
    return arr[: _block_decompress_raw(lib, data, _ptr(arr), expected + 64, threads)].tobytes()


def decompress_into(data: bytes, out, threads: int = 1) -> int:
    """Decompress into the writable buffer ``out`` (straight into its
    memory when byte-shaped and large enough: the decoder is byte-precise
    near the end). Returns bytes written; raises BufferTooSmallError when
    the result does not fit."""
    lib = _require()
    data = bytes(data)
    expected = _expected_length(lib, data)
    view = _writable_view(out)
    if view is not None and view.size >= expected:
        return _block_decompress_raw(lib, data, _ptr(view), view.size, threads)
    stage = default_pool.rent(1 << max(10, (max(int(expected) + 64, 1) - 1).bit_length()),
                              np.uint8)
    try:
        n = _block_decompress_raw(lib, data, _ptr(stage), stage.size, threads)
        return _stage_writeback(out, view, stage, n)
    finally:
        default_pool.giveback(stage)


def scan_fragments(data: bytes):
    """Fragment-split prescan (``stpu_scan_fragments``): split a block
    stream at exact 64 KiB output boundaries. Returns int64 [nf, 7]
    records (layout in :mod:`snappier_tpu_torch.runtime.prescan`), or None
    when a copy crosses a boundary. Raises InvalidDataError on malformed
    streams."""
    lib = _require()
    data = bytes(data)
    max_frags = _preamble_length(lib, data) // 65536 + 3
    recs = np.zeros((max_frags, 7), np.int64)
    nf = ctypes.c_size_t()
    rc = lib.stpu_scan_fragments(data, len(data),
                                 recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                 max_frags, ctypes.byref(nf))
    if rc == _WINDOW_CROSS:
        return None
    if rc != _OK:
        raise InvalidDataError("malformed snappy block data")
    return recs[: nf.value]


def match_length_test(buf: bytes, a: int, b: int, b_limit: int) -> int:
    """TEST HOOK: the C++ engine's FindMatchLength analog, pinned by the
    golden vectors of ``tests/test_match_length.py``."""
    return int(_require().stpu_match_length_test(bytes(buf), a, b, b_limit))


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C of ``data`` continuing from ``crc`` (hardware CRC where the
    host has it, else slicing-by-8)."""
    data = bytes(data)
    return int(_require().stpu_crc32c(data, len(data), crc))


def stream_compress(data: bytes, threads: int = 0) -> bytes:
    """One-shot framing-format compress in the C++ runtime: chunking,
    CRC32C, headers and the uncompressed fallback.

    ``threads``: 0 = one worker per hardware thread (capped at the chunk
    count, so small inputs never spawn), 1 = the serial pipeline, N =
    exactly N workers. The bytes are the same at every count."""
    lib = _require()
    data = bytes(data)
    cap = lib.stpu_stream_max_compressed_length(len(data))
    arr = np.empty(cap, np.uint8)
    out_len = ctypes.c_size_t()
    if threads != 1:
        rc = lib.stpu_stream_compress_mt(data, len(data), _ptr(arr), cap, ctypes.byref(out_len),
                                         threads)
    else:
        rc = lib.stpu_stream_compress(data, len(data), _ptr(arr), cap, ctypes.byref(out_len))
    if rc != _OK:
        raise InvalidDataError(f"native stream compress failed rc={rc}")
    return arr[: out_len.value].tobytes()


def stream_decompress(data: bytes, threads: int = 0) -> bytes:
    """One-shot framing-format decompress with full CRC verification.
    ``threads`` as in :func:`stream_compress`; the verdicts are those of
    the serial pipeline."""
    lib = _require()
    data = bytes(data)
    total = ctypes.c_uint64()
    if lib.stpu_stream_uncompressed_length(data, len(data), ctypes.byref(total)) != _OK:
        raise InvalidDataError("malformed framed stream")
    cap = total.value + 64  # the decoder's wide copies spill past the end
    arr = np.empty(cap, np.uint8)
    out_len = ctypes.c_size_t()
    if threads != 1:
        rc = lib.stpu_stream_decompress_mt(data, len(data), _ptr(arr), cap,
                                           ctypes.byref(out_len), threads)
    else:
        rc = lib.stpu_stream_decompress(data, len(data), _ptr(arr), cap, ctypes.byref(out_len))
    if rc == _INVALID:
        raise InvalidDataError("corrupt framed stream")
    if rc != _OK:
        raise InvalidDataError(f"native stream decompress failed rc={rc}")
    return arr[: out_len.value].tobytes()
