"""Carry a reference codec's state across to the port.

The codec has no weights: its state is its configuration (the constant
tables are rebuilt from the format law in :mod:`snappier_tpu_torch.format`).
:func:`codec_from_reference` takes the configuration of a
``snappier_tpu.models.codec.SnappyCodec`` as plain values, so the port
never imports the reference.
"""

from __future__ import annotations

from collections.abc import Mapping

from snappier_tpu_torch.models.codec import SnappyCodec

#: The reference codec's attributes that define its output.
CONFIG_KEYS = ("fragment_size", "with_crc", "hash_bits", "skip_base")


def codec_from_reference(cfg: Mapping, device=None) -> SnappyCodec:
    """The port codec equivalent to a reference codec whose
    ``fragment_size``, ``with_crc``, ``hash_bits`` and ``skip_base`` are
    given in ``cfg``; ``device`` as for :class:`SnappyCodec`."""
    missing = [k for k in CONFIG_KEYS if k not in cfg]
    if missing:
        raise KeyError(f"reference config lacks {missing}")
    return SnappyCodec(
        fragment_size=int(cfg["fragment_size"]),
        with_crc=bool(cfg["with_crc"]),
        hash_bits=int(cfg["hash_bits"]),
        skip_base=int(cfg["skip_base"]),
        device=device,
    )
