"""Compute ops: the parallel-scan engine (tensor code, the same on the CPU
and on the card: :mod:`~snappier_tpu_torch.ops.decode`,
:mod:`~snappier_tpu_torch.ops.encode`, :mod:`~snappier_tpu_torch.ops.crc32c`),
the candidate search of ``level="best"``
(:mod:`~snappier_tpu_torch.ops.best_match`) and the CUDA kernels
(:mod:`snappier_tpu_torch.ops.cuda`)."""

from snappier_tpu_torch.ops.crc32c import crc32c_block  # noqa: F401
from snappier_tpu_torch.ops.decode import decode_block  # noqa: F401
from snappier_tpu_torch.ops.encode import encode_block  # noqa: F401
