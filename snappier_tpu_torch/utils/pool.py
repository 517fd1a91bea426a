"""Size-bucketed buffer pool (port of ``snappier_tpu/utils/pool.py``;
parity: the reference's ``ArrayPool`` usage + ``ByteArrayPoolMemoryOwner.cs``).

Host-side staging buffers (the ``*_to_memory`` results, native staging)
are recycled per size bucket to avoid re-allocating multi-megabyte numpy
arrays on every call. Buffers are NOT zeroed by default, like the
reference pool, which zeroizes only on dispose
(ByteArrayPoolMemoryOwner.cs:42): a caller reads only bytes it wrote.

:class:`StagingPool` is the same for the stream layer's transfer buffers:
flat uint8 host tensors, page-locked when they feed a CUDA device, so
that a ``non_blocking`` copy really is asynchronous.
"""

from __future__ import annotations

import threading
from collections import defaultdict

import numpy as np
import torch


class BufferPool:
    """Thread-safe pool of numpy scratch buffers keyed by (shape, dtype)."""

    def __init__(self, max_per_bucket: int = 8) -> None:
        self._buffers: dict = defaultdict(list)
        self._lock = threading.Lock()
        self._max = max_per_bucket

    def rent(self, shape, dtype=np.int32) -> np.ndarray:
        key = (tuple(np.atleast_1d(shape).tolist()), np.dtype(dtype).str)
        with self._lock:
            bucket = self._buffers[key]
            if bucket:
                return bucket.pop()
        return np.empty(shape, dtype)

    def giveback(self, buf: np.ndarray) -> None:
        key = (tuple(buf.shape), buf.dtype.str)
        with self._lock:
            bucket = self._buffers[key]
            if len(bucket) < self._max:
                bucket.append(buf)


class StagingPool:
    """Thread-safe pool of flat uint8 host tensors of power-of-two sizes
    (which bounds the bucket count), keyed by (size, page-locked). A
    buffer must come back only after every device copy that reads or
    writes it has finished."""

    def __init__(self, max_per_bucket: int = 8) -> None:
        self._buffers: dict = defaultdict(list)
        self._lock = threading.Lock()
        self._max = max_per_bucket

    def rent(self, nbytes: int, pinned: bool):
        """A buffer of at least ``nbytes`` bytes (at least 4 KiB)."""
        size = 1 << max(12, (max(nbytes, 1) - 1).bit_length())
        with self._lock:
            bucket = self._buffers[(size, pinned)]
            if bucket:
                return bucket.pop()
        return torch.empty(size, dtype=torch.uint8, pin_memory=pinned)

    def giveback(self, buf) -> None:
        with self._lock:
            bucket = self._buffers[(buf.numel(), buf.is_pinned())]
            if len(bucket) < self._max:
                bucket.append(buf)


class PooledMemory:
    """Releasable pooled result buffer — the public analog of the
    reference's ``IMemoryOwner<byte>`` returned by
    ``Snappy.CompressToMemory``/``DecompressToMemory``
    (ByteArrayPoolMemoryOwner.cs:33-55): the caller reads ``memory``
    (a writable memoryview of exactly the result bytes) and hands the
    backing buffer back to the pool with :meth:`release` (or by
    exiting the context manager). Parity details: the view is
    zeroized on release, matching the reference's clear-on-dispose
    (:42), and access after release raises, matching its disposed
    ``Memory`` getter (:37-40)."""

    __slots__ = ("_buf", "_len", "_pool")

    def __init__(self, buf: np.ndarray, length: int, pool: BufferPool):
        self._buf = buf
        self._len = length
        self._pool = pool

    @property
    def memory(self) -> memoryview:
        if self._buf is None:
            from snappier_tpu_torch.errors import InvalidOperationError

            raise InvalidOperationError("pooled memory already released")
        return memoryview(self._buf)[: self._len]

    def __len__(self) -> int:
        return self._len

    def __bytes__(self) -> bytes:
        return bytes(self.memory)

    def release(self) -> None:
        """Zeroize the result bytes and return the buffer to the pool
        (idempotent)."""
        if self._buf is not None:
            self._buf[: self._len] = 0
            self._pool.giveback(self._buf)
            self._buf = None

    def __enter__(self) -> "PooledMemory":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


#: Process-wide default pool used by the runtime staging paths.
default_pool = BufferPool()

#: Process-wide pool of the stream layer's transfer buffers.
staging_pool = StagingPool()
