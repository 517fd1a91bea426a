"""Multi-process run of the port's sharded corpus functions:
``tools/torch_dist_worker.py`` in 1, 2 and 4 CPU processes joined by a gloo
group over loopback, with the assertions of ``tests/test_distributed.py``:

* every process computed identical ordered-assembly maps;
* their local-block sets partition the batch;
* the union of their partial payloads is the complete stream, equal to what
  the single-process port and the reference ``compress_corpus_sharded``
  give, and it decodes exactly;
* the same for the decode twin on a shared variable-length stream.

A worker that fails or does not finish in time fails the test.
"""

from __future__ import annotations

import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from snappier_tpu.parallel import distributed as ref_dist
from snappier_tpu.parallel import mesh as ref_mesh
from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.parallel import distributed, make_mesh
from tests.torch_cases import WORKER, check_union, run_workers, worker_module


@pytest.mark.parametrize(
    "nprocs,shards,n_blocks",
    [
        (2, 4, 8),  # two hosts of four shards: one block per shard
        (4, 2, 16),  # wider fan-out, fewer shards per host
        (1, 8, 8),  # a group of one: the collectives still run
    ],
)
def test_multi_process_sharded_corpus(tmp_path, nprocs, shards, n_blocks):
    metas, payloads, plains = run_workers(tmp_path, nprocs, shards, n_blocks)
    for m in metas:
        assert m["process_count"] == nprocs and m["mesh_size"] == nprocs * shards
        assert m["backend"] == "gloo" and m["device"] == "cpu"
        assert not m["launches"]  # CPU shards: the plain versions, no kernel
    combined = check_union(metas, payloads, ("block_lengths", "block_offsets", "local_blocks"))

    worker = worker_module()
    data = worker.corpus(n_blocks)
    assert oracle.decompress(combined) == data
    # The same stream from one process on a mesh of as many CPU shards, and
    # from the reference on as many virtual devices (scalar engine both).
    single, meta = distributed.compress_corpus_sharded(
        data, mesh=make_mesh(["cpu"] * (nprocs * shards)), kernel="scalar")
    assert combined.tobytes() == single
    assert metas[0]["block_lengths"] == meta["block_lengths"].tolist()
    assert metas[0]["block_offsets"] == meta["block_offsets"].tolist()
    ref, ref_meta = ref_dist.compress_corpus_sharded(
        data, mesh=ref_mesh.make_mesh(jax.devices()[: nprocs * shards]), kernel="scalar")
    assert combined.tobytes() == ref
    assert metas[0]["block_offsets"] == np.asarray(ref_meta["block_offsets"]).tolist()

    sdata, _ = worker.stream_case(3 * nprocs + 2)
    combined_plain = check_union(
        metas, plains, ("fragment_lengths", "fragment_offsets", "local_fragments"))
    assert combined_plain.tobytes() == sdata


def test_worker_failure_is_not_swallowed(tmp_path):
    """A worker that cannot join (a world of 2 with one process started and
    a bad rank) exits non-zero, and the harness reports it."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    p = subprocess.run(
        [sys.executable, str(WORKER), f"tcp://localhost:{port}", "2", "5", str(tmp_path), "2",
         "cpu", "1"],
        capture_output=True, timeout=120,
    )
    assert p.returncode != 0
    assert not list(tmp_path.glob("payload_*.bin"))
