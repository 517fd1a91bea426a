"""LEB128 varint32 encoding of the uncompressed-length preamble.

Parity: ``Snappier/Internal/VarIntEncoding.{Write,WriteFast,Read}.cs``.
The format is standard little-endian base-128: 7 payload bits per byte,
high bit set on all but the last byte, max 5 bytes for a u32.

These run host-side (a block preamble is 1-5 bytes; there is nothing to
vectorize). The device-side batch runtime passes lengths as an int32
tensor instead and only materializes varints during host assembly.
"""

from __future__ import annotations

from snappier_tpu_torch.errors import InvalidDataError

MAX_VARINT_LEN = 5
MAX_U32 = 0xFFFFFFFF


def varint_len(value: int) -> int:
    """Number of bytes ``write_varint`` emits for ``value``."""
    if value < 0 or value > MAX_U32:
        raise ValueError(f"varint32 out of range: {value}")
    n = 1
    while value >= 0x80:
        value >>= 7
        n += 1
    return n


def write_varint(value: int) -> bytes:
    """Encode ``value`` as a LEB128 varint32.

    Parity: VarIntEncoding.Write.cs:5-79 (slow path semantics)."""
    if value < 0 or value > MAX_U32:
        raise ValueError(f"varint32 out of range: {value}")
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_varint(data, pos: int = 0) -> tuple[int, int]:
    """Decode a varint32 starting at ``data[pos]``.

    Returns ``(value, bytes_consumed)``. Raises :class:`InvalidDataError`
    on truncation, on a varint longer than 5 bytes, or on u32 overflow.
    Parity: VarIntEncoding.Read.cs:26-91.
    """
    value = 0
    shift = 0
    n = len(data)
    for i in range(MAX_VARINT_LEN):
        if pos + i >= n:
            raise InvalidDataError("truncated varint length preamble")
        b = int(data[pos + i])  # int(): numpy uint8 would wrap on <<
        value |= (b & 0x7F) << shift
        if not (b & 0x80):
            if value > MAX_U32:
                raise InvalidDataError("varint32 overflow")
            return value, i + 1
        shift += 7
    raise InvalidDataError("varint32 longer than 5 bytes")
