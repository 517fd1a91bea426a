"""Utility layer: buffer pooling and per-call metrics."""

from snappier_tpu_torch.utils.pool import BufferPool, default_pool  # noqa: F401
