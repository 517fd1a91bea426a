"""snappier_tpu_torch: the Snappy codec of ``snappier_tpu`` on PyTorch, with
hand-written CUDA kernels for Hopper (H100).

The port stands alone: it imports neither JAX nor ``snappier_tpu``. Its
entry points run on the card unless the caller asks for the CPU, where
each kernel's plain version runs instead.

Public facade (parity with the reference's ``Snappy`` class, Snappy.cs):

>>> import snappier_tpu_torch as st
>>> comp = st.compress(b"hello hello hello hello hello", device="cpu")
>>> st.decompress(comp, device="cpu")
b'hello hello hello hello hello'

and the framing format with its stream classes (SnappyStream.cs):

>>> framed = st.stream_compress(b"hello hello hello hello hello", device="cpu")
>>> st.stream_decompress(framed, device="cpu")
b'hello hello hello hello hello'
"""

from snappier_tpu_torch.errors import (  # noqa: F401
    BufferTooSmallError,
    InvalidDataError,
    InvalidOperationError,
    SnappyError,
)
from snappier_tpu_torch import parallel  # noqa: F401
from snappier_tpu_torch.models.codec import SnappyCodec  # noqa: F401
from snappier_tpu_torch.runtime.block import (  # noqa: F401
    compress,
    compress_into,
    compress_to_memory,
    decompress,
    decompress_into,
    decompress_to_memory,
    get_max_compressed_length,
    get_uncompressed_length,
    try_compress,
    try_decompress,
)
from snappier_tpu_torch.runtime.stream import (  # noqa: F401
    AsyncSnappyReader,
    AsyncSnappyWriter,
    SnappyReader,
    SnappyStream,
    SnappyWriter,
    stream_compress,
    stream_decompress,
)
from snappier_tpu_torch.utils.pool import PooledMemory  # noqa: F401
