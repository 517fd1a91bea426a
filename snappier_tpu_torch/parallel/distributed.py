"""Multi-process runtime: the sharded codec over whole buffers (port of
``snappier_tpu/parallel/distributed.py``).

* each process runs only its own shards of the block batch;
* the codec body needs no communication (blocks are independent);
* ordered assembly needs only the per-block length vector, which is
  gathered (tiny) and prefix-summed, so every process knows every block's
  byte offset in the final stream;
* payload bytes never move between processes: each process writes its
  shards' bytes at their offsets, zeros elsewhere, and the union of the
  processes' buffers is the complete stream.

The same code runs in one process on a mesh of CPU shards
(``make_mesh(["cpu"] * 8)``), on one card listed several times, and under
``torch.distributed`` after :func:`initialize`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from snappier_tpu_torch.constants import BLOCK_SIZE
from snappier_tpu_torch.errors import InvalidDataError
from snappier_tpu_torch.format.varint import write_varint
from snappier_tpu_torch.parallel.mesh import (
    fetch_rows,
    make_mesh,
    sharded_compress,
    sharded_decompress,
)


def initialize(coordinator_address: str | None = None, num_processes: int = 1,
               process_id: int = 0, backend: str = "gloo", **kw) -> None:
    """Join the multi-process runtime (call once per process, before the
    first mesh is made). No-op for a single process without an address.
    ``coordinator_address`` is ``host:port`` or a ``torch.distributed`` init
    method (``tcp://host:port``); the lengths travel over ``backend``."""
    if coordinator_address is None and num_processes == 1:
        return
    if coordinator_address is None:
        raise ValueError("several processes need a coordinator address")
    if not 0 <= int(process_id) < int(num_processes):
        # torch.distributed would wait for the missing ranks until its timeout.
        raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=int(num_processes), rank=int(process_id), **kw)


def _scatter_rows(buf: np.ndarray, shards, lens: np.ndarray, starts: np.ndarray,
                  count: int) -> list[int]:
    """Copy the first ``lens[i]`` bytes of every addressable row ``i <
    count`` into ``buf`` at ``starts[i]``; returns those row indices."""
    local: list[int] = []
    for rows, shard in shards:
        keep = [i for i in rows if i < count]
        if not keep:
            continue
        fetched = fetch_rows(shard[: len(keep)], lens[keep[0] : keep[-1] + 1])
        for i, row in zip(keep, fetched):
            buf[int(starts[i]) : int(starts[i]) + len(row)] = row
        local.extend(keep)
    return sorted(local)


def compress_corpus_sharded(data, mesh=None, kernel: str | None = None):
    """Compress an arbitrarily large buffer data-parallel over the mesh.

    Splits into 64 KiB fragments, pads the batch to the mesh size with
    zero-length rows, compresses sharded, and returns ``(payload, meta)``:
    the block-format bytes, assembled in order from the replicated offsets,
    and the per-block lengths and offsets (``block_lengths``,
    ``block_offsets``, with ``uncompressed_length`` and ``local_blocks``).

    In a multi-process run each process fetches only its own shards: the
    returned ``payload`` holds bytes only at this process's blocks
    (``meta["local_blocks"]``, zeros elsewhere) and the union of all
    processes' payloads is the complete stream.
    """
    mesh = mesh or make_mesh()
    nd = mesh.size
    arr = np.frombuffer(bytes(data), np.uint8)
    n = len(arr)
    nfrags = max(1, -(-n // BLOCK_SIZE))
    b = -(-nfrags // nd) * nd  # pad batch to mesh multiple
    frags = np.zeros((b, BLOCK_SIZE), np.uint8)
    frags.reshape(-1)[:n] = arr
    lengths = np.zeros(b, np.int32)
    lengths[:nfrags] = BLOCK_SIZE
    lengths[nfrags - 1] = n - (nfrags - 1) * BLOCK_SIZE

    bodies, body_lens, offsets = sharded_compress(
        torch.from_numpy(frags), torch.from_numpy(lengths), mesh=mesh, kernel=kernel
    )
    # Lengths and offsets are replicated: every process holds the full
    # assembly map; payload bytes stay on the devices that made them and
    # each process writes only its addressable blocks.
    body_lens = body_lens.cpu().numpy()
    offsets = offsets.cpu().numpy()

    preamble = write_varint(n)
    base = len(preamble)
    total = int(offsets[nfrags - 1] + body_lens[nfrags - 1])
    payload = np.zeros(base + total, np.uint8)
    payload[:base] = np.frombuffer(preamble, np.uint8)
    local_blocks = _scatter_rows(payload, bodies.addressable_shards, body_lens,
                                 offsets + base, nfrags)
    meta = {
        "uncompressed_length": n,
        "block_lengths": body_lens[:nfrags],
        "block_offsets": offsets[:nfrags] + base,
        "local_blocks": local_blocks,
    }
    return payload.tobytes(), meta


def decompress_corpus_sharded(data, mesh=None, kernel: str | None = None,
                              fragment_size: int = BLOCK_SIZE):
    """Decode an arbitrarily large block-format buffer data-parallel over
    the mesh: the decode twin of :func:`compress_corpus_sharded`.

    The host prescan splits the tag stream at exact ``fragment_size``
    output boundaries, each fragment is re-wrapped as a standalone block,
    the batch is padded to the mesh multiple with valid one-byte blocks,
    decoded by ``sharded_decompress``, and assembled in order from the
    replicated output lengths, each process writing only its addressable
    fragments' byte ranges.

    Returns ``(plain, meta)``: the decoded bytes (in a multi-process run
    only at this process's fragments, zeros elsewhere; the union across
    processes is the complete output) and the assembly map
    (``fragment_lengths``, ``fragment_offsets``, ``local_fragments``,
    ``uncompressed_length``).

    A stream in which a copy reaches across an output line (legal per the
    wire format, emitted by no known encoder) is decoded by the serial host
    decoder on every process, as the single-device path does; ``meta`` then
    has ``window_crossing_fallback``."""
    from snappier_tpu_torch.runtime import block, prescan

    mesh = mesh or make_mesh()
    nd = mesh.size
    arr = np.frombuffer(bytes(data), np.uint8)
    recs = prescan.scan_fragments(arr, fragment_size)
    if recs is None:
        plain = block._host_decode(arr)
        meta = {
            "uncompressed_length": len(plain),
            "fragment_lengths": np.array([len(plain)], np.int64),
            "fragment_offsets": np.array([0], np.int64),
            "local_fragments": [0],
            "window_crossing_fallback": True,
        }
        return plain, meta
    comp, comp_lens, out_lens_exp = prescan.assemble_fragment_rows(arr, recs)
    nf = comp.shape[0]
    b = -(-nf // nd) * nd  # pad batch to mesh multiple
    if b > nf:
        # A padded row must still be a valid block: a 1-byte varint(0)
        # preamble decodes to zero bytes with no error.
        comp = np.concatenate([comp, np.zeros((b - nf, comp.shape[1]), comp.dtype)], axis=0)
        comp_lens = np.concatenate([comp_lens, np.ones(b - nf, np.int32)], axis=0)
    outs, out_lens, max_err = sharded_decompress(
        torch.from_numpy(comp), torch.from_numpy(comp_lens), out_cap=fragment_size,
        mesh=mesh, kernel=kernel,
    )
    block._raise_for_err(int(max_err))
    out_lens = out_lens.cpu().numpy()  # replicated assembly map
    if not (out_lens[:nf] == np.asarray(out_lens_exp)).all():
        raise InvalidDataError("fragment output length mismatch")
    offsets = np.concatenate([[0], np.cumsum(out_lens[:nf], dtype=np.int64)])
    total = int(offsets[nf])
    plain = np.zeros(total, np.uint8)
    local_fragments = _scatter_rows(plain, outs.addressable_shards, out_lens, offsets, nf)
    meta = {
        "uncompressed_length": total,
        "fragment_lengths": out_lens[:nf],
        "fragment_offsets": offsets[:nf],
        "local_fragments": local_fragments,
    }
    return plain.tobytes(), meta
