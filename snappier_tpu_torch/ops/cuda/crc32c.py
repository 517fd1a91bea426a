"""CRC32C of each row's first ``lengths[b]`` bytes, a CUDA block per row.

Port of ``snappier_tpu/ops/pallas/crc32c.py::crc32c_blocks``: the same
arguments and the same int32 bit patterns. The kernel (``csrc/crc32c.cu``
over ``csrc/crc32c.cuh``) takes its byte table and its shift tables from
:func:`kernel_tables`, built from :mod:`snappier_tpu_torch.format.crc32c`;
on the CPU the wrapper runs the plain version, :func:`crc32c_blocks_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from snappier_tpu_torch.format.crc32c import byte_table, crc32c, shift_matrices
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.ops.cuda._tensors import byte_rows, lengths_vector, on_cuda

#: The kernel's shapes (``csrc/crc32c.cuh``): lanes a warp, warps a block,
#: bytes a lane loads at once, and the distance of a lane's fold.
LANES, WARPS, CHUNK = 32, 8, 16
FOLD = WARPS * LANES * CHUNK


def shift_columns(nbytes: int) -> np.ndarray:
    """uint32[32]: column ``i`` is state bit ``i`` (a raw CRC state) shifted
    past ``nbytes`` zero bytes: the 32 x 32 GF(2) matrix of that shift,
    composed from ``shift_matrices`` (one a set bit of ``nbytes``)."""
    cols = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    for k, mat in enumerate(shift_matrices(32)):
        if (nbytes >> k) & 1:
            bits = (cols[:, None] >> np.arange(32, dtype=np.uint32)) & 1
            cols = np.bitwise_xor.reduce(np.where(bits == 1, mat[None, :], 0), axis=1)
    return cols.astype(np.uint32)


def shift_table(nbytes: int) -> np.ndarray:
    """uint32[4, 256]: entry ``[j, v]`` is the raw CRC state ``v << 8 j``
    shifted past ``nbytes`` zero bytes, so a state's shift is the XOR of four
    entries, one a byte."""
    cols = shift_columns(nbytes)
    bits = (np.arange(256, dtype=np.uint32)[:, None] >> np.arange(8, dtype=np.uint32)) & 1
    return np.stack([
        np.bitwise_xor.reduce(np.where(bits == 1, cols[8 * j : 8 * j + 8], 0), axis=1)
        for j in range(4)
    ]).astype(np.uint32)


@functools.cache
def kernel_tables() -> np.ndarray:
    """uint32[3584], the kernel's tables in its order: the byte table; the
    4-byte step and the fold as :func:`shift_table`; the lanes' matrices
    (word ``32 i + l``: bit ``i`` shifted past the ``31 - l`` chunks after
    lane ``l``'s); the warps' (word ``32 w + i``: bit ``i`` shifted past the
    ``WARPS - 1 - w`` lines after warp ``w``'s)."""
    lanes = np.stack([shift_columns((LANES - 1 - l) * CHUNK) for l in range(LANES)], axis=1)
    warps = np.stack([shift_columns((WARPS - 1 - w) * LANES * CHUNK) for w in range(WARPS)])
    return np.concatenate([byte_table(), shift_table(4).reshape(-1),
                           shift_table(FOLD).reshape(-1), lanes.reshape(-1), warps.reshape(-1)])


@functools.cache
def _device_tables(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(kernel_tables().view(np.int32)).to(device)


def crc32c_blocks_plain(frags: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain version on CPU uint8 rows: the host CRC32C of each row."""
    rows = frags.numpy()
    F = rows.shape[1]
    out = [crc32c(rows[b, : min(max(n, 0), F)]) for b, n in enumerate(lengths.tolist())]
    return torch.from_numpy(np.array(out, np.uint32).view(np.int32))


def crc32c_blocks(frags, lengths) -> torch.Tensor:
    """CRC32C of each row's first ``lengths[b]`` bytes.

    Args:
      frags: [B, F] int32 or uint8 byte rows; bytes past ``lengths[b]``
        may hold anything (they are not read).
      lengths: [B] (clamped to [0, F]).

    Returns: int32[B] CRC bit patterns.
    """
    frags = byte_rows(frags, "frags")
    B, F = frags.shape
    lengths = lengths_vector(lengths, B, "lengths")
    if not on_cuda(frags, lengths):
        return crc32c_blocks_plain(frags, lengths)
    out = torch.empty(B, dtype=torch.int32, device=frags.device)
    tables = _device_tables(frags.device)
    _build.launch(
        "crc32c", frags.device, frags.data_ptr(), F, lengths.data_ptr(), B,
        tables.data_ptr(), out.data_ptr(),
    )
    return out


def crc32c_layout(device) -> dict:
    """The kernel's layout on a CUDA device: blocks per SM under the
    attributes a launch sets, shared bytes and threads per block, and the
    persistent blocks of a launch (one an SM)."""
    out = (ctypes.c_int32 * 4)()
    with torch.cuda.device(device):
        rc = _build.launcher("crc32c_layout")(out)
    if rc != 0:
        raise RuntimeError(f"crc32c_layout failed with cudaError {rc}")
    return {"blocks_per_sm": out[0], "smem_bytes": out[1], "threads": out[2],
            "persistent_blocks": out[3]}
