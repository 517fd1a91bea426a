"""Liveness probe: a freshly compiled, salted one-line kernel.

Port of the identity kernel in ``tools/tpu_watch.sh:19-24``: ``y = x +
salt`` on an int32 ``(8, 128)`` ``arange``. Its only job is to show that
the compiler and the launch path are alive before real work starts, so it
must compile anew at every call: the salt goes into ``csrc/watch.cu`` as
``-DWATCH_SALT=<n>`` and into the library's name, past the hash cache of
:mod:`snappier_tpu_torch.ops.cuda._build`, and the library is removed
afterwards so ``build/`` does not grow.

:func:`add_salt` is the wrapper: it launches the kernel for a CUDA tensor
and runs the plain version, :func:`add_salt_plain`, for a CPU tensor.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import time

import torch

from snappier_tpu_torch.models.codec import resolve_device
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.ops.cuda._tensors import on_cuda

SHAPE = (8, 128)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]


def fresh_salt() -> int:
    return int(time.time()) % 100000


@contextlib.contextmanager
def salted_launcher(salt: int):
    """Compile ``csrc/watch.cu`` for ``salt`` into a library of its own
    name and yield its bound launcher; the library file is removed on
    exit."""
    path = _build.BUILD_DIR / f"libwatch-{salt}-{os.getpid()}-{time.monotonic_ns()}.so"
    try:
        _build.finish_nvcc(_build.start_nvcc("watch", path, (f"WATCH_SALT={salt}",)), path.name)
        yield _build.bind(path, "watch_launch", _ARGTYPES)
    finally:
        path.unlink(missing_ok=True)


def add_salt_plain(x: torch.Tensor, salt: int) -> torch.Tensor:
    """Plain version of the kernel."""
    return x + salt


def add_salt(x: torch.Tensor, salt: int, launcher=None) -> torch.Tensor:
    """``x + salt`` for an int32 tensor. A CUDA tensor goes through the
    kernel compiled for ``salt``: ``launcher`` if given (from
    :func:`salted_launcher` with the same salt), else one built for this
    call. A CPU tensor takes the plain version. With a launcher the call
    holds no state across calls: it reads the current stream at each one,
    so it may be captured in a CUDA graph."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise ValueError("x must be an int32 tensor")
    if not -(1 << 31) <= salt < 1 << 31:
        raise ValueError("salt must fit 32 bits")
    x = x.contiguous()
    if not on_cuda(x):
        return add_salt_plain(x, salt)
    y = torch.empty_like(x)
    if launcher is not None:
        _build.launch_bound(launcher, "watch", x.get_device(), x.data_ptr(), y.data_ptr(),
                            x.numel())
        return y
    with salted_launcher(salt) as fn:
        _build.launch_bound(fn, "watch", x.device, x.data_ptr(), y.data_ptr(), x.numel())
    return y


def device_alive(salt: int | None = None, device=None) -> torch.Tensor:
    """Compile the salted kernel afresh, run it once on the device and
    check ``y[0, 0] == salt`` on the host; raises ``RuntimeError``
    otherwise. Returns ``y`` (on the device). ``device="cpu"`` runs the
    plain version and compiles nothing."""
    dev = resolve_device(device)
    salt = fresh_salt() if salt is None else int(salt)
    x = torch.arange(SHAPE[0] * SHAPE[1], dtype=torch.int32, device=dev).reshape(SHAPE)
    y = add_salt(x, salt)
    got = int(y[0, 0])  # waits for the kernel
    if got != salt:
        raise RuntimeError(f"liveness kernel returned {got}, not its salt {salt}")
    return y
