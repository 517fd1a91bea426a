"""Entry points for a harness: a single-device compile-and-run check and the
multi-shard sharding dry run (port of ``__graft_entry__.py``)."""

from __future__ import annotations

import numpy as np
import torch

from snappier_tpu_torch.models.codec import SnappyCodec, resolve_device


def entry(device=None):
    """``(fn, example_args)`` for one forward step of the flagship pipeline:
    batched block compression (with CRC32C) of 4 x 64 KiB fragments, on the
    card unless ``device="cpu"``."""
    codec = SnappyCodec(device=device)
    rng = np.random.default_rng(0)
    # Realistically compressible data: repeated phrases + noise.
    text = (b"the quick brown snappy block compressed on a tpu " * 6000)[
        : 4 * codec.fragment_size
    ]
    frags = np.frombuffer(text, np.uint8).reshape(4, codec.fragment_size).astype(np.int32)
    frags[:, -64:] = rng.integers(0, 256, (4, 64))
    lengths = np.full(4, codec.fragment_size, np.int32)
    return codec.compress_batch, (
        torch.from_numpy(frags).to(codec.device), torch.from_numpy(lengths).to(codec.device))


def dryrun_mesh(n_devices: int, device=None):
    """A mesh of ``n_devices`` shards for the dry run: CPU shards for
    ``device="cpu"``, else the visible cards taken in turn (one card listed
    ``n_devices`` times when it is the only one)."""
    from snappier_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    if dev.type == "cpu":
        return make_mesh(["cpu"] * n_devices)
    if dev.index is not None:
        return make_mesh([dev] * n_devices)
    count = torch.cuda.device_count()
    return make_mesh([torch.device("cuda", i % count) for i in range(n_devices)])


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Make an ``n_devices``-shard mesh and run one sharded full-codec step
    (compress, ordered-assembly offsets, decompress, verify) on tiny shapes
    with both engines, then the sharded decode of a variable-length stream.
    Fragments are the format's independence unit, so the block axis is the
    only parallel axis."""
    from snappier_tpu_torch.format import oracle
    from snappier_tpu_torch.format.varint import read_varint, write_varint
    from snappier_tpu_torch.parallel.distributed import decompress_corpus_sharded
    from snappier_tpu_torch.parallel.mesh import sharded_roundtrip_step

    mesh = dryrun_mesh(n_devices, device)

    F = 2048  # tiny fragment shape, same code path
    B = 2 * n_devices
    rng = np.random.default_rng(1234)
    text = (b"snappy blocks shard data-parallel over the mesh! " * 1024)[: B * F]
    frags = np.frombuffer(text, np.uint8).reshape(B, F).astype(np.int32)
    frags[::2, F // 2 :] = rng.integers(0, 256, (B // 2, F // 2))
    lengths = np.full(B, F, np.int32)
    lengths[-1] = F - 100  # exercise a ragged tail block

    # Both engines under the mesh: the scan engine and the scalar kernels.
    totals = {}
    for kernel in ("scan", "scalar"):
        bodies, body_lens, offsets, ok = sharded_roundtrip_step(
            frags, lengths, mesh=mesh, kernel=kernel
        )
        assert bool(ok), f"sharded round-trip mismatch (kernel={kernel})"
        off = offsets.cpu().numpy()
        bl = body_lens.cpu().numpy()
        assert (np.diff(off) == bl[:-1]).all(), (
            f"ordered-assembly offsets wrong (kernel={kernel})"
        )
        totals[kernel] = int(off[-1] + bl[-1])

    # Sharded decode of a variable-length stream: prescan at the dry-run
    # fragment line, fragment rows, sharded_decompress, ordered assembly,
    # both engines, bit-exact. Each chunk is compressed alone and the bodies
    # are joined under one preamble, so copy offsets stay within the
    # F-sized output lines.
    chunks = []
    for i in range(2 * n_devices + 3):
        chunk = (f"variable length fragment {i:04d} ".encode() * 100)[:F]
        arr2 = np.frombuffer(chunk, np.uint8).copy()
        arr2[:64] = rng.integers(0, 256, 64)
        chunks.append(arr2.tobytes())
    chunks[-1] = chunks[-1][: F // 3]  # ragged tail fragment
    stream_plain = b"".join(chunks)
    parts = [write_varint(len(stream_plain))]
    for c in chunks:
        body = oracle.compress(np.frombuffer(c, np.uint8))
        _, off = read_varint(np.frombuffer(body, np.uint8))
        parts.append(body[off:])
    stream_comp = b"".join(parts)
    for kernel in ("scan", "scalar"):
        plain, meta = decompress_corpus_sharded(
            stream_comp, mesh=mesh, kernel=kernel, fragment_size=F
        )
        assert plain == stream_plain, (
            f"sharded variable-length decode mismatch (kernel={kernel})"
        )
        assert not meta.get("window_crossing_fallback"), (
            "dry-run stream unexpectedly fell back to host decode"
        )
    print(
        f"dryrun_multichip ok: mesh={mesh.shape}, {B} blocks x {F} B -> "
        f"{totals} compressed bytes (scan+scalar kernels), bit-exact "
        f"round trips on {n_devices} devices; sharded decode of a "
        f"{len(chunks)}-fragment variable-length stream "
        f"({len(stream_comp)} -> {len(stream_plain)} B) bit-exact on "
        "both kernels"
    )


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     sys.argv[2] if len(sys.argv) > 2 else None)
