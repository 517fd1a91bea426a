"""CRC32C of each row's first ``lengths[b]`` bytes, one CUDA block per row.

Port of ``snappier_tpu/ops/pallas/crc32c.py::crc32c_blocks``: the same
arguments and the same int32 bit patterns. The kernel (``csrc/crc32c.cu``)
takes its byte table and zero-shift matrices from
:mod:`snappier_tpu_torch.format.crc32c`; on the CPU the wrapper runs the
plain version, :func:`crc32c_blocks_plain`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from snappier_tpu_torch.format.crc32c import byte_table, crc32c, shift_matrices
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.ops.cuda._tensors import byte_rows, lengths_vector, on_cuda


@functools.cache
def kernel_tables() -> np.ndarray:
    """uint32[256 + 32 * 32]: the byte table, then the 32 matrices that
    shift a raw CRC state by 2**k zero bytes."""
    return np.concatenate([byte_table(), shift_matrices(32).reshape(-1)])


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
