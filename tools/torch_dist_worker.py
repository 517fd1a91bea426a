"""Worker process of the multi-process run of the port's sharded corpus
functions.

Joins a ``torch.distributed`` group, compresses a deterministic corpus
data-parallel over the global mesh (this process's shards times the world
size), decodes a shared variable-length stream the same way, and writes its
partial payload, partial plaintext and assembly maps for the parent to
combine.

Usage:
  python tools/torch_dist_worker.py <init_method> <world> <rank> <outdir> \
      [n_blocks] [device] [shards] [backend]

``init_method`` is ``host:port`` or ``tcp://host:port``; ``device`` is
``cuda`` (default) or ``cpu``; ``shards`` is this process's number of shards
(default 2), all on that device; ``backend`` is ``gloo`` (default) or
``nccl``.
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def corpus(n_blocks: int) -> bytes:
    from snappier_tpu_torch.constants import BLOCK_SIZE

    rng = np.random.default_rng(1234)
    target = n_blocks * BLOCK_SIZE - 777
    unit = b"distributed ordered assembly over localhost "
    text = (unit * (target // len(unit) + 1))[:target]
    arr = np.frombuffer(text, np.uint8).copy()
    noise = rng.integers(0, 256, len(arr) // 7, dtype=np.uint8)
    arr[: len(noise)] = noise
    return arr.tobytes()


def stream_case(n_frags: int, frag: int = 2048) -> tuple[bytes, bytes]:
    """Deterministic variable-length block stream whose copy offsets stay
    within ``frag``-sized output lines (each chunk compressed alone, bodies
    joined under one preamble), and its plaintext. Every process builds the
    identical pair."""
    from snappier_tpu_torch.format import oracle
    from snappier_tpu_torch.format.varint import read_varint, write_varint

    rng = np.random.default_rng(4321)
    chunks = []
    for i in range(n_frags):
        text = (f"distributed decode fragment {i:05d} ".encode() * 80)[:frag]
        arr = np.frombuffer(text, np.uint8).copy()
        arr[:48] = rng.integers(0, 256, 48)
        chunks.append(arr.tobytes())
    chunks[-1] = chunks[-1][: frag // 4]  # ragged tail
    data = b"".join(chunks)
    parts = [write_varint(len(data))]
    for c in chunks:
        body = oracle.compress(np.frombuffer(c, np.uint8))
        _, off = read_varint(np.frombuffer(body, np.uint8))
        parts.append(body[off:])
    return data, b"".join(parts)


def main(init_method: str, world: int, rank: int, outdir: str, n_blocks: int = 8,
         device: str = "cuda", shards: int = 2, backend: str = "gloo") -> None:
    import torch
    import torch.distributed as dist

    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.parallel import distributed
    from snappier_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize(init_method, num_processes=world, process_id=rank, backend=backend)
    joined = dist.is_initialized()
    assert (dist.get_world_size() if joined else 1) == world
    mesh = make_mesh([device] * shards)
    data = corpus(n_blocks)
    payload, meta = distributed.compress_corpus_sharded(data, mesh=mesh)
    # Decode twin: sharded decompress of a variable-length stream every
    # process holds in full; each writes only its addressable fragments'
    # bytes (and the replicated assembly map).
    sdata, scomp = stream_case(3 * world + 2)
    plain, dmeta = distributed.decompress_corpus_sharded(scomp, mesh=mesh, fragment_size=2048)
    assert len(plain) == len(sdata)
    out = pathlib.Path(outdir)
    (out / f"payload_{rank}.bin").write_bytes(payload)
    (out / f"plain_{rank}.bin").write_bytes(plain)
    (out / f"meta_{rank}.json").write_text(
        json.dumps(
            {
                "uncompressed_length": meta["uncompressed_length"],
                "block_lengths": [int(x) for x in meta["block_lengths"]],
                "block_offsets": [int(x) for x in meta["block_offsets"]],
                "local_blocks": meta["local_blocks"],
                "fragment_lengths": [int(x) for x in dmeta["fragment_lengths"]],
                "fragment_offsets": [int(x) for x in dmeta["fragment_offsets"]],
                "local_fragments": dmeta["local_fragments"],
                "process_count": world,
                "local_device_count": shards,
                "mesh_size": mesh.size,
                "device": str(torch.device(device)),
                "backend": dist.get_backend() if joined else None,
                "launches": dict(_build.LAUNCHES),
            }
        )
    )
    if joined:
        dist.destroy_process_group()
    print(f"worker {rank} ok", flush=True)


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0], int(a[1]), int(a[2]), a[3], int(a[4]) if len(a) > 4 else 8,
         a[5] if len(a) > 5 else "cuda", int(a[6]) if len(a) > 6 else 2,
         a[7] if len(a) > 7 else "gloo")
