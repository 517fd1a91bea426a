"""Hand-written CUDA kernels for Hopper, each with a plain version beside
it: block decode, greedy and best-mode encode and the match-extension probe
(:mod:`.scalar_codec`), CRC32C (:mod:`.crc32c`), the liveness kernel
(:mod:`.watch`) and the decode-walk ablation variants
(:mod:`.decode_variants`). Sources are in ``snappier_tpu_torch/csrc``."""
