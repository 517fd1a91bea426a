"""Build the CUDA sources in ``snappier_tpu_torch/csrc`` and bind them.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` run for
``sm_90a`` into a shared library with a plain C interface, which is
loaded with :mod:`ctypes` (no PyTorch headers, so a build takes seconds).
Libraries land in ``build/`` at the repository root, named by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. :func:`build_all` starts every ``nvcc`` at once.

Every wrapper counts its launches in :data:`LAUNCHES`, so a caller can
show that a run went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64

#: C signature of each source's launcher: (symbol, argtypes).
SOURCES = {
    "decode": (
        "snappy_decode_launch", [_P, _I64, _P, _I64, _I32, _P, _P, _P, _P]
    ),
    "encode": (
        "snappy_encode_launch",
        [_P, _I64, _P, _I64, _I32, _I32, _P, _I64, _P, _P],
    ),
    "crc32c": ("crc32c_launch", [_P, _I64, _P, _I64, _P, _P, _P]),
}

#: Kernel launches per wrapper since the last reset.
LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_launchers: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", CSRC / "scalar_codec.cuh"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns the
    running process (or None) and the library path."""
    path = _lib_path(name)
    if path.exists():
        return None, path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return (proc, tmp), path


def _finish_build(started, path: pathlib.Path) -> None:
    if started is None:
        return
    proc, tmp = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {path.name} ({proc.returncode}):\n"
            + out.decode(errors="replace")
        )
    os.replace(tmp, path)  # atomic: a concurrent builder sees a whole file


def _bind(name: str, path: pathlib.Path):
    symbol, argtypes = SOURCES[name]
    fn = getattr(ctypes.CDLL(str(path)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_all() -> None:
    """Build every source not yet built, all nvcc runs at once, and bind
    them."""
    with _lock:
        todo = [n for n in SOURCES if n not in _launchers]
        started = [(n, *_start_build(n)) for n in todo]
        try:
            for _, st, path in started:
                _finish_build(st, path)
        finally:
            for _, st, _ in started:
                if st is not None and st[0].poll() is None:
                    st[0].kill()
                    st[0].wait()
        for n, _, path in started:
            _launchers[n] = _bind(n, path)


def launcher(name: str):
    """The bound C launcher of ``csrc/<name>.cu``, built at first use."""
    if name not in _launchers:
        build_all()
    return _launchers[name]


def launch(name: str, device, *args) -> None:
    """Call a launcher on ``device``'s current CUDA stream and raise on a
    launch error; counts the launch under ``name``."""
    import torch

    fn = launcher(name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with cudaError {rc}")
    LAUNCHES[name] += 1
