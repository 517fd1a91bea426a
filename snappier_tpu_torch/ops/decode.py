"""Error words of the block decoder (parity: ``snappier_tpu/ops/decode.py``).

The decode kernel (:mod:`snappier_tpu_torch.ops.cuda.scalar_codec`)
reports a bad preamble as ``ERR_BAD_PREAMBLE``, a clean walk whose output
length differs from the preamble as ``ERR_LENGTH_MISMATCH``, and every other
mid-stream failure as ``ERR_MALFORMED``, the OR of the first three words.
"""

from __future__ import annotations

ERR_TRUNCATED_TAG = 1  # a tag (or its literal payload) overruns the input
ERR_BAD_OFFSET = 2  # copy offset of zero or beyond produced output
ERR_LENGTH_MISMATCH = 4  # tag stream output != varint preamble claim
ERR_BAD_PREAMBLE = 8  # malformed/oversized varint preamble

#: The combined word of a failed tag walk.
ERR_MALFORMED = ERR_TRUNCATED_TAG | ERR_BAD_OFFSET | ERR_LENGTH_MISMATCH
