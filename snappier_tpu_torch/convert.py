"""Carry a reference codec's state across to the port.

The codec has no weights: its state is its configuration (the constant
tables are rebuilt from the format law in :mod:`snappier_tpu_torch.format`).
:func:`codec_from_reference` takes the configuration of a
``snappier_tpu.models.codec.SnappyCodec`` as plain values,
:func:`mesh_from_reference` the axis and device count of a reference mesh, and
:func:`stream_from_reference` reads the state of a reference stream object
taken mid-stream by attribute, so the port never imports the reference.
"""

from __future__ import annotations

from collections.abc import Mapping

from snappier_tpu_torch.models.codec import SnappyCodec, resolve_device
from snappier_tpu_torch.parallel.mesh import BLOCK_AXIS, Mesh, make_mesh
from snappier_tpu_torch.runtime.incremental import BlockDecompressor
from snappier_tpu_torch.runtime.stream import StreamCompressor, StreamDecompressor

#: The reference codec's attributes that define its output.
CONFIG_KEYS = ("fragment_size", "with_crc", "hash_bits", "skip_base")


def codec_from_reference(cfg: Mapping, device=None) -> SnappyCodec:
    """The port codec equivalent to a reference codec whose
    ``fragment_size``, ``with_crc``, ``hash_bits`` and ``skip_base`` are
    given in ``cfg``; its ``kernel`` (``"scalar"`` or ``"scan"``) is carried
    across when ``cfg`` has it, else the port's default engine is taken.
    ``device`` as for :class:`SnappyCodec`."""
    missing = [k for k in CONFIG_KEYS if k not in cfg]
    if missing:
        raise KeyError(f"reference config lacks {missing}")
    return SnappyCodec(
        fragment_size=int(cfg["fragment_size"]),
        with_crc=bool(cfg["with_crc"]),
        hash_bits=int(cfg["hash_bits"]),
        skip_base=int(cfg["skip_base"]),
        kernel=cfg.get("kernel"),
        device=device,
    )


def mesh_from_reference(mesh, device=None) -> Mesh:
    """The port's mesh of as many shards as a reference mesh has devices.
    ``mesh`` is a ``jax.sharding.Mesh`` taken as a plain object (its
    ``axis_names`` must be the block axis alone, its ``devices`` give the
    count); every shard lies on ``device`` (default: the card)."""
    if tuple(mesh.axis_names) != (BLOCK_AXIS,):
        raise ValueError(f"the reference mesh's axes are {tuple(mesh.axis_names)}, "
                         f"not ({BLOCK_AXIS!r},)")
    return make_mesh([resolve_device(device)] * int(mesh.devices.size))


def _port_engine(engine: str) -> str:
    """The reference's device engine is ``"tpu"``; the port's is ``"cuda"``."""
    return "cuda" if engine == "tpu" else engine


def stream_from_reference(obj, engine: str | None = None, device=None):
    """The port's twin of a reference ``StreamCompressor``,
    ``StreamDecompressor`` or ``BlockDecompressor`` taken mid-stream, with
    the same pending bytes, header flag, scratch, remaining literal and
    produced output, so that the rest of the stream fed to the twin gives
    the bytes and the verdict the reference object would have given.

    ``engine`` defaults to the reference object's own (``"tpu"`` becomes
    ``"cuda"``); ``device`` as for the stream classes. The state is copied:
    the reference object is left as it was."""
    kind = type(obj).__name__
    if kind == "StreamCompressor":
        twin = StreamCompressor(engine=engine or _port_engine(obj._engine), device=device)
        twin._buf = bytearray(obj._buf)
        twin._header_written = bool(obj._header_written)
        return twin
    if kind == "StreamDecompressor":
        twin = StreamDecompressor(engine=engine or _port_engine(obj._engine), device=device)
        twin._pending = bytearray(obj._pending)
        twin._seen_header = bool(obj._seen_header)
        return twin
    if kind == "BlockDecompressor":
        twin = BlockDecompressor()
        twin._pre = bytearray(obj._pre)
        twin._expected = None if obj._expected is None else int(obj._expected)
        twin._out = bytearray(obj._out)
        twin._base = int(obj._base)
        twin._tail = bytes(obj._tail)
        twin._remaining_literal = int(obj._remaining_literal)
        twin._read_pos = int(obj._read_pos)
        twin._extracted = bool(obj._extracted)
        return twin
    raise TypeError(f"no port twin for a {kind}")
