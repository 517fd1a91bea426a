#!/usr/bin/env python3
"""Multi-process rehearsal of the port's sharded corpus path at size.

The port's twin of ``tools/rehearsal_multihost.py``: N processes of
``tools/torch_dist_worker.py``, joined by a gloo group over loopback, each
with ``devs`` shards, compress a deterministic corpus of ``n_blocks`` x 64
KiB (256 MiB by default) data-parallel through ``compress_corpus_sharded``
and decode a shared variable-length stream through
``decompress_corpus_sharded``. Each process writes only its own blocks' and
fragments' byte ranges; this parent joins them and checks:

* every process computed the same assembly maps;
* the processes' local block and fragment sets partition the batch;
* the union of the partial payloads, decoded by the port's native engine
  (the oracle where the C++ library is unavailable), is the corpus, byte for
  byte;
* the union of the partial plaintexts is the shared stream's plaintext.

Collectives travel as host tensors on the gloo group, and the payload stays
on the shards' device. On the card every process lists ``cuda:0`` ``devs``
times (one card: NCCL would refuse two ranks on it); ``--device cpu`` runs
the kernels' plain versions. The default device is the card, and without one
the tool raises. On the card the parent builds the kernels' libraries once
before the workers start, so they load them instead of each building them.

Every worker has a time limit of its own; when one fails or runs out of
time, the others are killed. A failed fan-out is retried once on a fresh
port and directory (a loopback rendezvous can fail on a loaded host); a
second failure fails the run.

Usage:
    python3 tools/torch_rehearsal_multihost.py [n_blocks] [nprocs] [devs]
        [--device cuda|cpu]

Defaults: 4,096 blocks, 4 processes, 2 shards each. It prints one JSON line;
any failed check raises. The fan-out (:func:`run_workers`), the reading of
the workers' files (:func:`read_outputs`) and their union
(:func:`join_parts`) also serve the multi-process tests and
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

WORKER = ROOT / "tools" / "torch_dist_worker.py"
WORKER_TIMEOUT = 900  # seconds a worker may take at the default size
BLOCK_MAP = ("block_lengths", "block_offsets", "local_blocks")
FRAGMENT_MAP = ("fragment_lengths", "fragment_offsets", "local_fragments")


def worker_module():
    """``tools/torch_dist_worker.py`` as a module (its ``corpus`` and
    ``stream_case``)."""
    spec = importlib.util.spec_from_file_location("torch_dist_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(n_blocks: int, nprocs: int, devs: int, device: str, td,
                timeout: float = WORKER_TIMEOUT, backend: str = "gloo") -> bool:
    """One fan-out of ``nprocs`` workers into ``td`` on ``backend``; True
    when every worker exits 0 within ``timeout`` seconds of its start. The
    first to fail or to run out of time has the others killed; its log goes
    to stderr."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = []
    for rank in range(nprocs):
        log = open(pathlib.Path(td) / f"log_{rank}.txt", "wb")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), f"tcp://localhost:{port}", str(nprocs), str(rank),
             str(td), str(n_blocks), device, str(devs), backend],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT),
        ), log, time.monotonic() + timeout))
    failed = None
    try:
        while failed is None and any(p.poll() is None for p, _, _ in procs):
            for rank, (p, _, deadline) in enumerate(procs):
                rc = p.poll()
                if rc not in (None, 0):
                    failed = (rank, f"exit code {rc}")
                elif rc is None and time.monotonic() > deadline:
                    failed = (rank, f"no exit within {timeout} s")
                if failed:
                    break
            time.sleep(0.05)
        if failed is None:
            failed = next(((r, f"exit code {p.returncode}") for r, (p, _, _) in
                           enumerate(procs) if p.returncode != 0), None)
    finally:
        for p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed is not None:
        rank, why = failed
        text = (pathlib.Path(td) / f"log_{rank}.txt").read_text(errors="replace")
        print(f"worker {rank} failed ({why}):\n{text[-3000:]}", file=sys.stderr)
        return False
    return True


def read_outputs(td, nprocs: int):
    """The workers' files in ``td``: (metas, payloads, plaintexts)."""
    td = pathlib.Path(td)
    metas = [json.loads((td / f"meta_{r}.json").read_text()) for r in range(nprocs)]
    payloads = [np.frombuffer((td / f"payload_{r}.bin").read_bytes(), np.uint8)
                for r in range(nprocs)]
    plains = [np.frombuffer((td / f"plain_{r}.bin").read_bytes(), np.uint8)
              for r in range(nprocs)]
    return metas, payloads, plains


def join_parts(metas, parts, keys) -> np.ndarray:
    """Check that the maps agree and the local sets partition the batch,
    and join the partial buffers. ``keys`` names the lengths, offsets and
    local set."""
    k_len, k_off, k_local = keys
    for m in metas[1:]:
        assert m[k_len] == metas[0][k_len] and m[k_off] == metas[0][k_off], (
            f"the workers' {k_off} maps differ")
    assert len({len(p) for p in parts}) == 1, "the workers' buffers differ in size"
    seen: set = set()
    for m in metas:
        local = set(m[k_local])
        assert local, "a process wrote nothing"
        assert seen.isdisjoint(local), f"the workers' {k_local} overlap"
        seen |= local
    assert seen == set(range(len(metas[0][k_len]))), f"the {k_local} do not cover the batch"
    combined = parts[0].copy()
    for m, p in zip(metas[1:], parts[1:]):
        for i in m[k_local]:
            o, ln = m[k_off][i], m[k_len][i]
            combined[o : o + ln] = p[o : o + ln]
    return combined


def _finish(td, n_blocks: int, nprocs: int, devs: int, device: str, t0: float) -> dict:
    """The parent's checks on the workers' files in ``td``; returns the
    result line's fields. Any failed check raises ``AssertionError``."""
    from snappier_tpu_torch.format import oracle
    from snappier_tpu_torch.runtime import native

    t_compress = time.perf_counter() - t0
    metas, payloads, plains = read_outputs(td, nprocs)
    for m in metas:
        assert m["process_count"] == nprocs and m["local_device_count"] == devs, m
        assert m["mesh_size"] == nprocs * devs and m["backend"] == "gloo", m
        assert m["device"].split(":")[0] == device, m
    stream = join_parts(metas, payloads, BLOCK_MAP).tobytes()
    worker = worker_module()
    data = worker.corpus(n_blocks)

    t1 = time.perf_counter()
    engine = "native" if native.available() else "oracle"
    out = native.decompress(stream) if engine == "native" else oracle.decompress(stream)
    assert out == data, "the joined stream does not decode to the corpus"
    plain = join_parts(metas, plains, FRAGMENT_MAP).tobytes()
    assert plain == worker.stream_case(3 * nprocs + 2)[0], "the joined plaintext differs"
    launches: dict = {}
    for m in metas:
        for k, v in m["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {
        "rehearsal": "multi-process ordered assembly",
        "nprocs": nprocs,
        "devices_per_proc": devs,
        "blocks": n_blocks,
        "uncompressed_MB": len(data) / 1e6,
        "compressed_MB": len(stream) / 1e6,
        "uncompressed_bytes": len(data),
        "compressed_bytes": len(stream),
        "compress_wall_s": t_compress,
        "verify_wall_s": time.perf_counter() - t1,
        "verify_engine": engine,
        "bit_exact": True,
        "decoded_exact": True,
        "device": metas[0]["device"],
        "backend": metas[0]["backend"],
        "launches": launches,
    }


def _prepare(device: str) -> str:
    """Resolve the device (raises without a card unless ``cpu``), and on the
    card build or load every kernel library before the fan-out. Returns the
    device string the workers take."""
    from snappier_tpu_torch.models.codec import resolve_device
    from snappier_tpu_torch.runtime import native

    dev = resolve_device(device)
    native.available()  # builds the C++ library the parent decodes with
    if dev.type == "cuda":
        from snappier_tpu_torch.ops.cuda import _build

        _build.build_all()
    return dev.type


def rehearse(n_blocks: int = 4096, nprocs: int = 4, devs: int = 2,
             device: str = "cuda") -> dict:
    """Run the rehearsal (one retry on a fresh port and directory) and
    return its result line's fields."""
    device = _prepare(device)
    t0 = time.perf_counter()
    for attempt in (1, 2):
        with tempfile.TemporaryDirectory() as td:
            if run_workers(n_blocks, nprocs, devs, device, td):
                result = _finish(td, n_blocks, nprocs, devs, device, t0)
                result["attempts"] = attempt
                return result
        if attempt == 1:
            print("worker fan-out failed; retrying once on a fresh port", file=sys.stderr)
            t0 = time.perf_counter()
    raise RuntimeError("the worker fan-out failed twice")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_blocks", nargs="?", type=int, default=4096)
    ap.add_argument("nprocs", nargs="?", type=int, default=4)
    ap.add_argument("devs", nargs="?", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    result = rehearse(args.n_blocks, args.nprocs, args.devs, args.device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
