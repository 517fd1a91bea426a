"""Vectorized CRC32C: the parallel-scan engine's checksum (port of
``snappier_tpu/ops/crc32c.py``).

It uses the GF(2) linearization of :mod:`snappier_tpu_torch.format.crc32c`:
the CRC of a chunk is an AND/XOR contraction of the message bits against a
per-distance contribution table, plus an affine constant that depends only
on the length. Byte i of an n-byte message sits at distance n - 1 - i from
the end, and the table rows are gathered with that index, so callers pass
left-aligned zero-padded rows and a length.

This is tensor code, the same on the CPU and on the card. PyTorch has no
XOR reduction, so the contraction folds halves of a power-of-two width;
and it takes the eight bit planes one after the other, which keeps the
intermediate at [rows, width] int32 where the reference's [width, 8]
gather times the batch would be 2 MiB a row.
"""

from __future__ import annotations

import functools

import torch

from snappier_tpu_torch.constants import BLOCK_SIZE
from snappier_tpu_torch.format.crc32c import lbit_table, zero_crc_table
from snappier_tpu_torch.ops.decode import SLAB_ROWS


@functools.cache
def _tables(device: torch.device):
    """(LBIT as int32 [8, BLOCK_SIZE], one row per bit plane; Z as int32
    [BLOCK_SIZE + 1]) on ``device``."""
    lbit = torch.from_numpy(lbit_table(BLOCK_SIZE).view("int32").T.copy())
    z = torch.from_numpy(zero_crc_table(BLOCK_SIZE).view("int32").copy())
    return lbit.to(device), z.to(device)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR of each row of an int32 [B, W] tensor."""
    w = x.shape[1]
    p = 1 << max(0, (w - 1).bit_length())
    if p != w:
        x = torch.nn.functional.pad(x, (0, p - w))
    while p > 1:
        p //= 2
        x = x[:, :p] ^ x[:, p : 2 * p]
    return x[:, 0]


def _crc_slab(data: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """:func:`crc32c_blocks_scan` on int32 rows [B, cap] and int32 lengths [B]."""
    cap = data.shape[1]
    lbit, z = _tables(data.device)
    pos = torch.arange(cap, dtype=torch.int32, device=data.device)[None, :]
    ln = length[:, None]
    dist = (ln - 1 - pos).clamp(0, BLOCK_SIZE - 1).long()
    valid = pos < ln
    acc = torch.zeros_like(data)
    for k in range(8):
        on = (((data >> k) & 1) > 0) & valid
        acc ^= torch.where(on, lbit[k][dist], 0)
    return _xor_reduce(acc) ^ z[length.clamp(0, BLOCK_SIZE).long()]


def crc32c_blocks_scan(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """CRC32C of ``data[b, :lengths[b]]`` for each row.

    Args:
      data: [B, cap] int32 or uint8 byte values on any device, cap <=
        BLOCK_SIZE.
      lengths: [B] actual lengths.

    Returns int32 [B]: each CRC's bit pattern (view as uint32 on the host).
    """
    if data.dim() != 2 or lengths.shape != (data.shape[0],):
        raise ValueError("data must be [B, cap] and lengths [B]")
    if data.shape[1] > BLOCK_SIZE:
        raise ValueError(f"row width must be at most {BLOCK_SIZE}, got {data.shape[1]}")
    lens = lengths.to(device=data.device, dtype=torch.int32)
    parts = [
        _crc_slab(data[lo : lo + SLAB_ROWS].to(torch.int32), lens[lo : lo + SLAB_ROWS])
        for lo in range(0, data.shape[0], SLAB_ROWS)
    ]
    if not parts:
        return torch.zeros(0, dtype=torch.int32, device=data.device)
    return torch.cat(parts)


def crc32c_block(data: torch.Tensor, length) -> torch.Tensor:
    """CRC32C of ``data[:length]`` for one row (int32 or uint8 [cap], cap <=
    BLOCK_SIZE): the uint32 CRC as a 0-d int32 tensor (bit pattern)."""
    n = torch.as_tensor(length, device=data.device).reshape(1)
    return crc32c_blocks_scan(data[None, :], n)[0]
