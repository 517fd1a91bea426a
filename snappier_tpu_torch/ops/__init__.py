"""Compute ops: the CUDA kernels (:mod:`snappier_tpu_torch.ops.cuda`) and
the decoder's error words (:mod:`snappier_tpu_torch.ops.decode`)."""
