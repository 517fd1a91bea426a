"""Snappy wire-format constants.

These pin down the bit-level contract of the two Snappy wire formats
implemented by this framework:

* **Block format** — varint-prefixed LZ77 tag stream
  (parity: ``Snappier/Internal/Constants.cs:18-27`` in the reference).
* **Framing format** — chunked stream with masked CRC32C checksums
  (parity: ``Snappier/Internal/Constants.cs:5-16``,
  ``Snappier/Internal/SnappyStreamCompressor.cs:18-21``).

Everything here is *format law*, identical across implementations. The
CUDA tag walk that decodes these constants lives in
``snappier_tpu_torch/csrc/scalar_codec.cuh``.
"""

from __future__ import annotations

# --- Tag types (low 2 bits of every tag byte) -------------------------------
# Parity: Constants.cs:18-21
TAG_LITERAL = 0b00
TAG_COPY1 = 0b01  # 1-byte offset payload, 11-bit offset, length 4..11
TAG_COPY2 = 0b10  # 2-byte LE offset payload, length 1..64
TAG_COPY4 = 0b11  # 4-byte LE offset payload, length 1..64 (decode-only)

#: A tag byte plus its longest possible payload of extra descriptor bytes
#: (4 length bytes for a >16MiB literal, or a 4-byte copy offset).
#: Parity: Constants.cs:23
MAX_TAG_LENGTH = 5

# --- Block geometry ---------------------------------------------------------
# Parity: Constants.cs:25-27
BLOCK_LOG = 16
BLOCK_SIZE = 1 << BLOCK_LOG  # 65536: max LZ window & fragment size
INPUT_MARGIN_BYTES = 15

#: Longest match the encoder will emit in a single copy tag.
MAX_COPY_LENGTH = 64
#: Shortest usable match (a copy tag costs >= 2 bytes).
MIN_MATCH_LENGTH = 4
#: Longest literal run encodable without extra length bytes.
MAX_SHORT_LITERAL = 60
#: Max offset expressible by a copy-1 tag (11 bits).
MAX_COPY1_OFFSET = 1 << 11
#: Max length expressible by a copy-1 tag.
MAX_COPY1_LENGTH = 11
#: Max offset expressible by a copy-2 tag (16 bits).
MAX_COPY2_OFFSET = 1 << 16

# --- Framing format ---------------------------------------------------------
# Chunk type bytes. Parity: Constants.cs:5-16
CHUNK_COMPRESSED_DATA = 0x00
CHUNK_UNCOMPRESSED_DATA = 0x01
# 0x02..0x7f: reserved unskippable (decoder must reject)
CHUNK_SKIPPABLE_FIRST = 0x80  # 0x80..0xfd: reserved skippable
CHUNK_PADDING = 0xFE
CHUNK_STREAM_IDENTIFIER = 0xFF

#: The mandatory 10-byte stream header: a stream-identifier chunk whose
#: 6-byte payload is the ASCII bytes "sNaPpY".
#: Parity: SnappyStreamCompressor.cs:18-21
STREAM_HEADER = bytes(
    [0xFF, 0x06, 0x00, 0x00, 0x73, 0x4E, 0x61, 0x50, 0x70, 0x59]
)

#: Max *uncompressed* payload carried by one data chunk.
#: Parity: SnappyStreamCompressor.cs:170-189
MAX_CHUNK_UNCOMPRESSED = BLOCK_SIZE

#: CRC32C mask constant applied to framing checksums.
#: Parity: Crc32CAlgorithm.cs:156-158
CRC_MASK_DELTA = 0xA282EAD8


def max_block_compressed_length(n: int) -> int:
    """Worst-case size of the compressed *body* (tag stream, no varint
    preamble) for ``n`` input bytes.

    Derivation (parity: ``Helpers.cs:17-46``): the encoder never emits a
    literal longer than needed, and in the worst case (incompressible
    input) each 60-byte-ish literal costs one tag byte, giving
    ``32 + n + n/6``. The ``+1`` headroom mirrors the reference constant.
    """
    return 32 + n + n // 6 + 1


def max_compressed_length(n: int) -> int:
    """Worst-case size of a full compressed block (varint preamble +
    body) for ``n`` input bytes. Parity: ``Snappy.cs:20-24`` (adds
    ``VarIntEncoding.MaxLength``-1 slack to the body bound)."""
    from snappier_tpu_torch.format.varint import varint_len

    return varint_len(n) + max_block_compressed_length(n)


def greedy_emit_bound(n: int) -> int:
    """Provable upper bound on the tag-stream bytes THIS framework's
    greedy encoders emit for an ``n``-byte fragment (tighter than
    :func:`max_block_compressed_length`, which bounds *any* conforming
    encoder and is what the decoder must tolerate).

    Derivation: copies cover >= 4 bytes with <= 3 emitted bytes, so
    they never expand. A literal run of length L costs L + 1 + e bytes
    with e extra length bytes (e = 0 for L <= 60, 1 for L <= 256, else
    2 since L <= 65536). The worst sustained expansion alternates
    61..256-byte literal runs (e = 1, net +1 after the copy's -1) with
    4-byte copy-2 matches: +1 per 65 input bytes. One final unpaired
    run adds <= 3. Hence ``n + n // 65 + 8`` (slack for the final run
    and empty-input edge) bounds emission for every input."""
    return n + n // 65 + 8


def min_compressed_length(n: int) -> int:
    """Provable lower bound on ANY valid compressed block for ``n``
    input bytes — the fail-fast test for Try*/into destinations
    (``Snappy.TryCompress`` fails before compressing when the output
    span cannot possibly fit, Snappy.cs:55 / SnappyCompressor.cs:24).

    Derivation: every tag covers at most ``2 * ceil(cover / 64)`` times
    fewer bytes than it costs — a copy covers <= 64 bytes for >= 2
    emitted bytes (copy-1; copy-2/4 cost more), and a literal of
    length L costs >= L + 1 >= 2 * ceil(L / 64). Summing over tags,
    body >= 2 * ceil(n / 64); add the varint preamble."""
    from snappier_tpu_torch.format.varint import varint_len

    return varint_len(n) + (0 if n == 0 else 2 * (-(-n // 64)))


def plausible_uncompressed_bound(comp_len: int) -> int:
    """Largest uncompressed length any valid ``comp_len``-byte block
    stream could claim. A 3-byte copy-2 tag yields at most 64 output
    bytes (~21.4x per compressed byte); 32x + slack is a safe upper
    bound used to reject oversized length preambles before allocating
    (SnappyTests.cs:244-331 behavior). One definition shared by every
    decode front-end."""
    return 32 * comp_len + 64
