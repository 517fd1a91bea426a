"""Parallel layer: device meshes and sharded batch codecs."""

from snappier_tpu_torch.parallel.mesh import (  # noqa: F401
    BLOCK_AXIS,
    Mesh,
    ShardedRows,
    make_mesh,
    sharded_compress,
    sharded_decompress,
    sharded_roundtrip_step,
)
