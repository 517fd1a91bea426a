"""Build the CUDA sources in ``snappier_tpu_torch/csrc`` and bind them.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` run for
``sm_90a`` into a shared library with a plain C interface, which is
loaded with :mod:`ctypes` (no PyTorch headers, so a build takes seconds).
Libraries land in ``build/`` at the repository root, named by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. :func:`build_all` starts every ``nvcc`` at once.
``csrc/watch.cu`` is the exception: :mod:`snappier_tpu_torch.ops.cuda.watch`
compiles it anew at every call, which is its purpose. A launcher is named
after its source, except where one source has several
(:data:`SHARED_SOURCE`).

Every wrapper counts its launches in :data:`LAUNCHES`, so a caller can
show that a run went through the kernels; the greedy encoder's also by
table width in :data:`ENCODE_TABLE_BITS`.
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_U32 = ctypes.c_uint32
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64

#: C signature of each launcher: (symbol, argtypes).
SOURCES = {
    "decode": (
        "snappy_decode_launch", [_P, _I64, _P, _I64, _I32, _P, _P, _P, _P]
    ),
    "encode": (
        "snappy_encode_launch",
        [_P, _I64, _P, _I64, _I32, _I32, _P, _I64, _P, _P],
    ),
    "encode_layout": ("snappy_encode_layout", [_P, _I64, _I32, _P]),
    "crc32c": ("crc32c_launch", [_P, _I64, _P, _I64, _P, _P, _P]),
    "crc32c_layout": ("crc32c_layout", [_P]),
    "decode_layout": ("snappy_decode_layout", [_P, _I64, _I32, _P]),
    "encode_best": (
        "snappy_encode_best_launch",
        [_P, _I64, _P, _I64, _P, _I32, _P, _I64, _P, _P],
    ),
    "best_layout": ("snappy_encode_best_layout", [_P, _I64, _P]),
    "probe": ("match_probe_launch", [_P, _I64, _P, _P, _P, _I64, _P, _P]),
    "decode_variants": (
        "snappy_decode_variant_launch", [_I32, _P, _I64, _P, _I64, _I32, _P, _P, _P, _P]
    ),
    "decode_pipe": (
        "snappy_decode_pipe_launch",
        [_I32, _I32, _I32, _I32, _I32, _P, _I64, _P, _I64, _I32, _P, _P, _P, _P],
    ),
    "decode_pipe_layout": ("snappy_decode_pipe_layout", [_P, _I64, _I32, _I32, _I32, _I32, _P]),
    "decode_variant_layout": ("snappy_decode_variant_layout", [_P, _I64, _I32, _I32, _P]),
    "encode_variants": (
        "snappy_encode_variant_launch",
        [_U32, _I32, _I32, _P, _I64, _P, _I64, _P, _I64, _P, _P],
    ),
    "encode_r4": (
        "snappy_encode_r4_launch",
        [_U32, _I32, _I32, _P, _I64, _P, _I64, _P, _I64, _P, _P],
    ),
    "encode_variant_layout": ("snappy_encode_variant_layout", [_P, _I64, _U32, _I32, _I32, _P]),
    "encode_r4_layout": ("snappy_encode_r4_layout", [_P, _I64, _U32, _I32, _I32, _P]),
    "decode_hybrid": (
        "snappy_decode_hybrid_launch",
        [_I32, _I32, _P, _I64, _P, _P, _I64, _P, _I64, _I32, _P, _P, _P, _P],
    ),
    "prepass": ("snappy_prepass_launch", [_I32, _P, _I64, _I64, _P, _P, _P]),
    "decode_hybrid_layout": ("snappy_decode_hybrid_layout", [_P, _I64, _I32, _I32, _P]),
    "encode_stats": ("snappy_encode_stats_launch", [_P, _I64, _P, _I64, _P, _P]),
    "encode_stats_layout": ("snappy_encode_stats_layout", [_P, _I64, _P]),
    "chain": ("probe_chain_launch", [_I32, _P, _I32, _I32, _I32, _I32, _P, _P, _P]),
    "vcopy": ("probe_vcopy_launch", [_I32, _P, _P, _P, _P, _P]),
    "coissue": ("probe_coissue_launch", [_I32, _I32, _I32, _P, _P, _P, _P]),
    "iso": ("probe_iso_launch", [_I32, _P, _P, _P, _P, _P]),
    "bprobe": ("probe_bprobe_launch", [_I32, _I32, _P, _P, _P]),
    "cliff": ("probe_cliff_launch", [_I32, _P, _I32, _I32, _I32, _I32, _P, _P, _P]),
    "chase": ("probe_chase_launch", [_P, _I32, _I32, _I32, _I32, _P, _P]),
    "bitonic": ("probe_bitonic_launch", [_P, _P, _P, _P]),
    "best_candidates": ("best_candidates_launch", [_P, _I64, _P, _I64, _U32, _P, _P, _P]),
    "best_candidates_layout": ("best_candidates_layout", [_I64, _P]),
}
#: The source of each launcher that is not ``csrc/<launcher>.cu``.
SHARED_SOURCE = {**{k: "hybrid_probes" for k in ("chain", "vcopy", "coissue", "iso", "bprobe",
                                                 "cliff", "chase")},
                 **{k: "decode_hybrid" for k in ("prepass", "decode_hybrid_layout")},
                 "bitonic": "bitonic_probe", "encode_layout": "encode", "decode_layout": "decode",
                 "best_layout": "encode_best", "crc32c_layout": "crc32c",
                 "encode_variant_layout": "encode_variants", "encode_r4_layout": "encode_r4",
                 "encode_stats_layout": "encode_stats",
                 "best_candidates_layout": "best_candidates",
                 "decode_pipe_layout": "decode_pipe", "decode_variant_layout": "decode_variants"}

#: Kernel launches per wrapper since the last reset.
LAUNCHES: collections.Counter = collections.Counter()
#: Greedy encode kernel launches per match-table width (hash bits) since
#: the last reset: which table a codec ran.
ENCODE_TABLE_BITS: collections.Counter = collections.Counter()
#: nvcc's output (ptxas's registers, stack, spills and shared memory per
#: kernel) for each source built, by source stem; kept beside each library
#: in ``build/`` as ``<library>.log`` and read back when it is reused.
BUILD_LOG: dict = {}

_lock = threading.Lock()
_launchers: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()
    ENCODE_TABLE_BITS.clear()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def source_of(name: str) -> str:
    """The stem of the source in ``csrc/`` that holds launcher ``name``."""
    return SHARED_SOURCE.get(name, name)


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def start_nvcc(name: str, out: pathlib.Path, defines: tuple = ()):
    """Start nvcc for ``csrc/<name>.cu`` into the library ``out`` with the
    given ``-D`` definitions; returns the running process."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I", str(CSRC),
           "-o", str(out), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def finish_nvcc(proc, what: str) -> str:
    """Wait for an nvcc run, raise with its output if it failed, and
    return the output."""
    out, _ = proc.communicate()
    text = out.decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what} ({proc.returncode}):\n" + text)
    return text


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns the
    running process (or None) and the library path."""
    path = _lib_path(name)
    if path.exists():
        log = path.with_suffix(".log")
        if log.exists():
            BUILD_LOG[name] = log.read_text()
        return None, path
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    return (start_nvcc(name, tmp), tmp), path


def _finish_build(name: str, started, path: pathlib.Path) -> None:
    if started is None:
        return
    proc, tmp = started
    BUILD_LOG[name] = finish_nvcc(proc, path.name)
    log_tmp = tmp.with_suffix(".log")
    log_tmp.write_text(BUILD_LOG[name])
    os.replace(log_tmp, path.with_suffix(".log"))  # before the library, which marks it built
    os.replace(tmp, path)  # atomic: a concurrent builder sees a whole file


def bind(path: pathlib.Path, symbol: str, argtypes: list):
    """The C launcher ``symbol`` of the library at ``path``."""
    fn = getattr(ctypes.CDLL(str(path)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_all() -> None:
    """Build every source not yet built, all nvcc runs at once, and bind
    their launchers."""
    with _lock:
        todo = [n for n in SOURCES if n not in _launchers]
        started = [(s, *_start_build(s)) for s in sorted({source_of(n) for n in todo})]
        try:
            for src, st, path in started:
                _finish_build(src, st, path)
        finally:
            for _, st, _ in started:
                if st is not None and st[0].poll() is None:
                    st[0].kill()
                    st[0].wait()
        paths = {s: path for s, _, path in started}
        for n in todo:
            _launchers[n] = bind(paths[source_of(n)], *SOURCES[n])


def launcher(name: str):
    """The bound C launcher ``name``, built at first use."""
    if name not in _launchers:
        build_all()
    return _launchers[name]


def launch(name: str, device, *args, count_as: str | None = None) -> None:
    """Call the launcher ``name`` on ``device``'s current CUDA stream and
    raise on a launch error; counts the launch under ``name``, or under
    ``count_as`` where one launcher serves several wrappers."""
    launch_bound(launcher(name), count_as or name, device, *args)


def launch_bound(fn, name: str, device, *args) -> None:
    """:func:`launch` for a launcher bound by the caller; ``device`` is a
    device or a device index. On the current device it reads the current
    stream's handle (a graph capture's stream inside a capture) and calls
    at once; another device is made current for the call. The handle is
    read raw: ``torch.cuda.current_stream`` builds a Stream object at each
    call, which costs the host about as much as a small kernel's whole gap
    to ``torch.add`` (``chip_smoke.py`` phase 0 times both reads)."""
    import torch

    cur = torch.cuda.current_device()
    idx = device if isinstance(device, int) else torch.device(device).index
    idx = cur if idx is None else idx
    if idx == cur:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with cudaError {rc}")
    LAUNCHES[name] += 1
