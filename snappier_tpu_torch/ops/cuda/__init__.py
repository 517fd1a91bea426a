"""Hand-written CUDA kernels for Hopper, each with a plain version beside
it: block decode, greedy and best-mode encode and the match-extension probe
(:mod:`.scalar_codec`), CRC32C (:mod:`.crc32c`), the liveness kernel
(:mod:`.watch`), the decode-walk ablation variants
(:mod:`.decode_variants`, :mod:`.encode_variants`, whose
``encode_stats`` counts the encoder's budget), the descriptor-driven decode
(:mod:`.decode_hybrid`) and its micro-probes (:mod:`.hybrid_probes`).
Sources are in ``snappier_tpu_torch/csrc``."""
