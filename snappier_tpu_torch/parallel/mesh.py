"""Block-axis sharding of the batch codec (port of
``snappier_tpu/parallel/mesh.py``).

64 KiB fragments compress independently and blocks decode independently, so
the block axis is the one data-parallel axis: a batch ``[B, ...]`` is cut
into ``mesh.size`` equal runs of rows, shard ``s`` holding rows
``[s * B / size, (s + 1) * B / size)``, and each shard runs the codec on
its own device with no communication. The only collective is the ordered
assembly: the per-shard length vectors are gathered (a concatenation inside
a process, ``torch.distributed.all_gather`` between processes) and their
exclusive prefix sum gives every block its byte offset in the assembled
stream. Lengths travel, payload stays: bodies and decoded rows remain on
the device that made them (:class:`ShardedRows`).

A :class:`Mesh` lists this process's shard devices in order. The same
device may be listed more than once: each entry is a shard with a CUDA
stream of its own, which is how one card runs a 4-way mesh. Under
``torch.distributed`` every process lists its own shards and the mesh spans
``local shards x world size`` shards, rank-major. Every process is handed
the whole batch and computes only its own shards, as the reference feeds
each host its addressable shards of a global array.

Both engines run under the mesh: ``kernel="scalar"`` (the CUDA kernels, or
their plain versions for CPU shards) and ``kernel="scan"`` (tensor code).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from snappier_tpu_torch.models.codec import (
    KERNELS,
    decode_rows,
    default_kernel,
    encode_rows,
    pack_rows,
    roundtrip_rows,
)

BLOCK_AXIS = "blocks"


class Mesh:
    """A 1-D mesh over the block axis: this process's shard devices in
    order and, when the process has joined ``torch.distributed``, the
    process group (``None``: the default group) that joins it to the other
    processes' shards. ``joined`` says that the collectives run; it differs
    from ``world > 1`` only for a group of one process, and ``make_mesh``
    alone sets it."""

    def __init__(self, devices, group=None, rank: int = 0, world: int = 1,
                 joined: bool = False):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard device")
        for d in self.devices:
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported shard device {d}")
        self.group = group
        self.rank = int(rank)
        self.world = int(world)
        self.joined = bool(joined)  # collectives run, even in a world of one
        self._streams = None

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        return self.local_size * self.world

    @property
    def shape(self) -> dict:
        return {BLOCK_AXIS: self.size}

    @property
    def home(self) -> torch.device:
        """The device that holds the replicated lengths and offsets."""
        return self.devices[0]

    def streams(self):
        """One CUDA stream per CUDA shard (``None`` for a CPU shard), made
        at first use."""
        if self._streams is None:
            self._streams = [
                torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in self.devices
            ]
        return self._streams

    def local_rows(self, batch: int) -> list[range]:
        """The global row range of each local shard of a batch of ``batch``
        rows, which must be a multiple of the mesh size."""
        if batch % self.size:
            raise ValueError(
                f"batch of {batch} rows is not a multiple of the mesh size {self.size}"
            )
        per = batch // self.size
        first = self.rank * self.local_size
        return [range((first + j) * per, (first + j + 1) * per) for j in range(self.local_size)]

    def __repr__(self) -> str:
        return (f"Mesh({BLOCK_AXIS}={self.size}: {[str(d) for d in self.devices]}"
                f", rank {self.rank} of {self.world})")


def make_mesh(devices=None, n_devices: int | None = None, group=None) -> Mesh:
    """1-D mesh over the block (data-parallel) axis.

    ``devices`` lists this process's shard devices; the default is every
    visible CUDA device (the first ``n_devices`` of them), and without a
    card that raises: a CPU mesh is made only by naming CPU shards, as in
    ``make_mesh(["cpu"] * 8)``. When ``torch.distributed`` is initialised
    the mesh spans every process of ``group`` (default: the world)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; name CPU shards (make_mesh(['cpu'] * n)) to run "
                "the plain versions of the kernels"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"shard device {d} named, but no CUDA device is available")
    if dist.is_available() and dist.is_initialized():
        return Mesh(devices, group, dist.get_rank(group), dist.get_world_size(group), joined=True)
    return Mesh(devices)


class ShardedRows:
    """Rows ``[B, W]`` cut along the block axis, each shard on the device
    that made it. ``addressable_shards`` lists this process's shards as
    ``(row range, tensor)``; in a single process they cover the batch."""

    def __init__(self, mesh: Mesh, batch: int, shards: list):
        self.mesh = mesh
        self.addressable_shards = shards
        self.shape = (batch, shards[0][1].shape[1])
        self.dtype = shards[0][1].dtype

    def gather(self, device=None) -> torch.Tensor:
        """The whole batch as one tensor on ``device`` (default: the mesh's
        first device). Single process only: another process's shards are
        not addressable."""
        if self.mesh.world != 1:
            raise RuntimeError("gather() needs every shard: the mesh spans several processes")
        device = self.mesh.home if device is None else torch.device(device)
        return torch.cat([t.to(device) for _, t in self.addressable_shards])


def _as_rows(x, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(x)
    return t if dtype is None else t.to(dtype)


def _run_shards(mesh: Mesh, batch: int, inputs, fn):
    """Run ``fn(*rows of each input)`` once per local shard on the shard's
    device, CUDA shards each on their own stream, and join the streams
    before returning. Returns ``[(row range, fn's result), ...]``."""
    results = []
    streams = mesh.streams()
    for dev, stream, rows in zip(mesh.devices, streams, mesh.local_rows(batch)):
        sl = slice(rows.start, rows.stop)
        if stream is None:
            results.append((rows, fn(*(x[sl].to(dev) for x in inputs))))
            continue
        with torch.cuda.device(dev):
            caller = torch.cuda.current_stream(dev)
            stream.wait_stream(caller)  # inputs made on the caller's stream
            with torch.cuda.stream(stream):
                args = [x[sl].to(dev, non_blocking=True) for x in inputs]
                out = fn(*args)
            for t in (*args, *out):
                if isinstance(t, torch.Tensor):
                    t.record_stream(caller)
                    t.record_stream(stream)
            results.append((rows, out))
    for dev, stream in zip(mesh.devices, streams):
        if stream is not None:
            torch.cuda.current_stream(dev).wait_stream(stream)
    return results


def all_gather_vector(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """The shards' vectors of every process, concatenated in mesh order, on
    ``local``'s device. Between processes the vector travels as a host
    tensor unless the group's backend is NCCL."""
    if not mesh.joined:
        return local
    on_card = dist.get_backend(mesh.group) == "nccl"
    buf = local.contiguous() if on_card else local.cpu().contiguous()
    parts = [torch.empty_like(buf) for _ in range(mesh.world)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat(parts).to(local.device)


def _all_reduce_scalar(mesh: Mesh, local: torch.Tensor, op) -> torch.Tensor:
    if not mesh.joined:
        return local
    on_card = dist.get_backend(mesh.group) == "nccl"
    buf = local.clone() if on_card else local.cpu().clone()
    dist.all_reduce(buf, op=op, group=mesh.group)
    return buf.to(local.device)


def _replicated_lengths(mesh: Mesh, parts) -> torch.Tensor:
    """Per-shard length vectors -> the whole batch's vector on the mesh's
    first device: the one collective of the sharded codec."""
    return all_gather_vector(mesh, torch.cat([p.to(mesh.home) for p in parts]))


def _offsets(body_lens: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of the lengths, in int64 (the reference sums in
    int32, which agrees below 2 GiB of bodies)."""
    return torch.cumsum(body_lens, 0, dtype=torch.int64) - body_lens


def _check_kernel(kernel: str | None) -> str:
    kernel = kernel or default_kernel(sharded=True)
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    return kernel


def sharded_compress(frags, lengths, mesh: Mesh | None = None, kernel: str | None = None):
    """Compress a [B, F] batch of fragments across the mesh.

    B must be a multiple of the mesh size. Returns ``(bodies, body_lens
    [B], offsets [B])``: bodies as :class:`ShardedRows` of uint8
    ``[B, F + 2048]`` that stay where they were made, the lengths (int32)
    and their exclusive prefix sum (int64) replicated on the mesh's first
    device: the ordered-assembly map every process holds. ``kernel``:
    ``'scalar'`` or ``'scan'``."""
    mesh = mesh or make_mesh()
    kernel = _check_kernel(kernel)
    frags, lengths = _as_rows(frags), _as_rows(lengths, torch.int32)
    W = frags.shape[1] + 2048

    def encode(f, n):
        bodies, body_lens = encode_rows(f, n, kernel)
        return bodies[:, :W], body_lens

    res = _run_shards(mesh, frags.shape[0], (frags, lengths), encode)
    body_lens = _replicated_lengths(mesh, [r[1] for _, r in res])
    return (ShardedRows(mesh, frags.shape[0], [(rows, r[0]) for rows, r in res]),
            body_lens, _offsets(body_lens))


def sharded_decompress(comp, comp_lens, out_cap: int, mesh: Mesh | None = None,
                       kernel: str | None = None):
    """Decode a [B, C] batch of blocks across the mesh. Returns ``(outs,
    out_lens [B], max_err)``: outs as :class:`ShardedRows` of uint8
    ``[B, out_cap]``, the output lengths replicated, and the largest error
    word over every shard and process (0 when every block decoded)."""
    mesh = mesh or make_mesh()
    kernel = _check_kernel(kernel)
    comp, comp_lens = _as_rows(comp), _as_rows(comp_lens, torch.int32)
    res = _run_shards(mesh, comp.shape[0], (comp, comp_lens),
                      lambda c, n: decode_rows(c, n, int(out_cap), kernel))
    out_lens = _replicated_lengths(mesh, [r[1] for _, r in res])
    max_err = torch.stack([r[2].max().to(mesh.home) if r[2].numel() else
                           torch.zeros((), dtype=torch.int32, device=mesh.home)
                           for _, r in res]).max()
    max_err = _all_reduce_scalar(mesh, max_err, dist.ReduceOp.MAX)
    return (ShardedRows(mesh, comp.shape[0], [(rows, r[0]) for rows, r in res]),
            out_lens, max_err)


def sharded_roundtrip_step(frags, lengths, mesh: Mesh | None = None,
                           kernel: str | None = None):
    """Full codec step, sharded over the mesh: compress, ordered-assembly
    offsets, re-wrap each body as a block with a 3-byte preamble, decode at
    ``out_cap = F``, and check the round trip. Returns ``(bodies, body_lens,
    offsets, ok)`` with ``ok`` a bool tensor that is true when, on every
    shard and process, the bytes below each length came back, no block gave
    an error and every output length equals its input length."""
    mesh = mesh or make_mesh()
    kernel = _check_kernel(kernel)
    frags, lengths = _as_rows(frags), _as_rows(lengths, torch.int32)
    res = _run_shards(mesh, frags.shape[0], (frags, lengths),
                      lambda f, n: roundtrip_rows(f, n, kernel))
    body_lens = _replicated_lengths(mesh, [r[1] for _, r in res])
    ok = torch.stack([r[2].to(mesh.home) for _, r in res]).all().to(torch.int32)
    ok = _all_reduce_scalar(mesh, ok, dist.ReduceOp.MIN).bool()
    return (ShardedRows(mesh, frags.shape[0], [(rows, r[0]) for rows, r in res]),
            body_lens, _offsets(body_lens), ok)


def fetch_rows(shard: torch.Tensor, lens: np.ndarray) -> list[np.ndarray]:
    """The first ``lens[j]`` bytes of each uint8 row of a shard as host
    arrays, in one device-to-host copy: of the rows' exact size (compacted
    on the shard's device first) where the width is a whole number of
    words, else of the whole shard."""
    from snappier_tpu_torch.runtime.block import _fetch_ragged_packed

    if shard.shape[1] % 4 == 0:
        return _fetch_ragged_packed(pack_rows(shard), np.asarray(lens))
    host = shard.cpu().numpy()
    return [host[j, : int(n)] for j, n in enumerate(lens)]
