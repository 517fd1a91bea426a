"""snappier_tpu_torch: the Snappy codec of ``snappier_tpu`` on PyTorch, with
hand-written CUDA kernels for Hopper (H100).

The port stands alone: it imports neither JAX nor ``snappier_tpu``. Its
entry points run on the card unless the caller asks for the CPU, where
each kernel's plain version runs instead.
"""

from snappier_tpu_torch.models.codec import SnappyCodec  # noqa: F401
