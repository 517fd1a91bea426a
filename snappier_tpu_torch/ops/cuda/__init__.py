"""Hand-written CUDA kernels for Hopper, each with a plain version beside
it: block decode and greedy encode (:mod:`.scalar_codec`) and CRC32C
(:mod:`.crc32c`). Sources are in ``snappier_tpu_torch/csrc``."""
