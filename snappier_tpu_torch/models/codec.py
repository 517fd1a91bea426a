"""The batched Snappy block codec on PyTorch (port of
``snappier_tpu/models/codec.py``).

``SnappyCodec`` bundles the three kernels (encode, decode, CRC32C) into
the shapes the framework ships: batch-of-blocks compress, batch decode,
the framing data-chunk pipeline, and a round trip with on-device
verification. Arguments and results keep the JAX codec's shapes and
dtypes. The codec runs on the card unless it is built with
``device="cpu"``, which runs each kernel's plain version.

Two engines compute the same wire format: ``kernel="scalar"``, the
hand-written CUDA kernels (one serial tag walk per block), and
``kernel="scan"``, the parallel-scan engine of
:mod:`snappier_tpu_torch.ops` (sorts, gathers and scans over whole blocks;
tensor code, the same on either device). Either engine decodes what the
other encodes. :func:`default_kernel` picks one when the caller does not.
"""

from __future__ import annotations

import functools
import logging
import os

import torch

from snappier_tpu_torch.constants import BLOCK_SIZE, CRC_MASK_DELTA
from snappier_tpu_torch.ops.crc32c import crc32c_blocks_scan
from snappier_tpu_torch.ops.cuda.crc32c import crc32c_blocks
from snappier_tpu_torch.ops.cuda.scalar_codec import (
    body_width,
    decode_blocks_bytes,
    encode_blocks_bytes,
)
from snappier_tpu_torch.ops.decode import decode_blocks_scan
from snappier_tpu_torch.ops.encode import encode_blocks_scan
from snappier_tpu_torch.utils.profiling import span

KERNELS = ("scalar", "scan")


@functools.cache
def default_kernel(sharded: bool = False) -> str:
    """The engine a codec, the facade and the stream layers use when the
    caller names none: the ``SNAPPIER_KERNEL`` environment override
    (``scalar`` or ``scan``; anything else is ignored with a warning), else
    ``"scalar"``, the CUDA kernels (and their plain versions on the CPU).
    The choice is read once per process and logged on logger
    ``snappier_tpu_torch``. ``sharded`` is the reference's second question
    (a sharded caller); both get the same answer here."""
    log = logging.getLogger("snappier_tpu_torch")
    k = os.environ.get("SNAPPIER_KERNEL")
    if k is not None and k not in KERNELS:
        log.warning(
            "SNAPPIER_KERNEL=%r is not 'scalar' or 'scan'; ignoring the override", k
        )
        k = None
    choice, why = (k, "SNAPPIER_KERNEL override") if k else ("scalar", "the CUDA kernels")
    log.info("kernel=%s sharded=%s (%s)", choice, sharded, why)
    return choice


def encode_rows(frags: torch.Tensor, lengths: torch.Tensor, kernel: str, hash_bits: int = 15,
                skip_base: int = 32):
    """Greedy-encode byte rows [B, F] (uint8 or int32) on their device with the
    given engine: (bodies uint8 [B, W], body_lens int32 [B]) with
    W = body_width(F) >= F + 2048. The scan engine finds exact matches, so
    the match-table tunables do not apply to it."""
    if kernel == "scalar":
        return encode_blocks_bytes(frags, lengths, hash_bits, skip_base)
    if kernel == "scan":
        bodies, body_lens = encode_blocks_scan(frags, lengths)
        pad = body_width(frags.shape[1]) - bodies.shape[1]
        return torch.nn.functional.pad(bodies.to(torch.uint8), (0, pad)), body_lens
    raise ValueError(f"unknown kernel {kernel!r}")


def decode_rows(comp: torch.Tensor, comp_lens: torch.Tensor, out_cap: int, kernel: str):
    """Decode block rows [B, CC] on their device with the given engine:
    (out uint8 [B, out_cap], out_lens int32 [B], errs int32 [B])."""
    if kernel == "scalar":
        return decode_blocks_bytes(comp, comp_lens, out_cap)
    if kernel == "scan":
        out, out_lens, errs = decode_blocks_scan(comp, comp_lens, out_cap)
        return out.to(torch.uint8), out_lens, errs
    raise ValueError(f"unknown kernel {kernel!r}")


def crc_rows(rows: torch.Tensor, lengths: torch.Tensor, kernel: str) -> torch.Tensor:
    """CRC32C bit patterns (int32 [B]) of byte rows with the given engine.
    The scan engine takes its own CRC whatever the width, as the reference
    does whenever its kernel is scan."""
    if kernel == "scalar":
        return crc32c_blocks(rows, lengths)
    if kernel == "scan":
        return crc32c_blocks_scan(rows, lengths)
    raise ValueError(f"unknown kernel {kernel!r}")


def resolve_device(device=None) -> torch.device:
    """The device a codec runs on: CUDA unless the caller asks for the CPU.
    A CUDA request without a usable card raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def pack_rows(rows: torch.Tensor) -> torch.Tensor:
    """Byte rows (B, W) with W % 4 == 0 -> int32 words (B, W // 4), 4
    little-endian bytes per word."""
    return rows.to(torch.uint8).contiguous().view(torch.int32)


def compact_words(words: torch.Tensor, wlens: torch.Tensor, cap_words: int) -> torch.Tensor:
    """Ragged compaction: concatenate the first ``wlens[i]`` words of every
    row into one flat buffer of ``cap_words`` (>= sum(wlens)) words; the
    caller keeps ``[:total]``."""
    wlens = wlens.to(torch.int32)
    ends = torch.cumsum(wlens, 0, dtype=torch.int32)
    starts = ends - wlens
    j = torch.arange(cap_words, dtype=torch.int32, device=words.device)
    row = torch.searchsorted(ends, j, right=True).to(torch.int32)
    rowc = row.clamp(0, words.shape[0] - 1).long()
    col = (j - starts[rowc]).clamp(0, words.shape[1] - 1).long()
    return words[rowc, col]


def _preamble3(lengths: torch.Tensor) -> torch.Tensor:
    """3-byte varint preambles (B, 3) for lengths < 2**21."""
    return torch.stack(
        [(lengths & 0x7F) | 0x80, ((lengths >> 7) & 0x7F) | 0x80, (lengths >> 14) & 0x7F],
        dim=1,
    )


def roundtrip_rows(frags: torch.Tensor, lengths: torch.Tensor, kernel: str,
                   hash_bits: int = 15, skip_base: int = 32):
    """Encode byte rows [B, F], re-wrap each body as a block with a 3-byte
    preamble, decode at ``out_cap = F`` and compare, all on the rows' device
    with the given engine: ``(bodies uint8 [B, F + 2048], body_lens, ok)``
    with ``ok`` a bool tensor: the bytes below each length came back, no
    block gave an error and every output length equals its input length."""
    F = frags.shape[1]
    raw, body_lens = encode_rows(frags, lengths, kernel, hash_bits, skip_base)
    raw = raw[:, : F + 2048]
    blocks = torch.cat([_preamble3(lengths).to(torch.uint8), raw], dim=1)
    outs, out_lens, errs = decode_rows(blocks, body_lens + 3, F, kernel)
    pos = torch.arange(F, device=frags.device)[None, :]
    ok = (
        torch.where(pos < lengths[:, None], outs == frags.to(torch.uint8), True).all()
        & (errs == 0).all()
        & (out_lens == lengths).all()
    )
    return raw, body_lens, ok


class SnappyCodec:
    """Batched block codec with a fixed fragment size.

    Args:
      fragment_size: per-block size (64 KiB in production; the format's LZ
        window).
      with_crc: also compute the framing format's per-block CRC32C during
        compression.
      kernel: 'scalar' | 'scan' | None (:func:`default_kernel`).
      hash_bits: scalar-encoder match-table size log2.
      skip_base: scalar-encoder skip-heuristic start constant.
      device: 'cuda' (default) or 'cpu'; inputs are moved there.
    """

    def __init__(
        self,
        fragment_size: int = BLOCK_SIZE,
        with_crc: bool = True,
        kernel: str | None = None,
        hash_bits: int = 15,
        skip_base: int = 32,
        device=None,
    ):
        if not 0 < fragment_size <= BLOCK_SIZE:
            raise ValueError(f"fragment_size must be in (0, {BLOCK_SIZE}]")
        kernel = kernel or default_kernel()
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}")
        self.fragment_size = fragment_size
        self.with_crc = with_crc
        self.kernel = kernel
        self.hash_bits = hash_bits
        self.skip_base = skip_base
        self.device = resolve_device(device)

    def _in(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _compress_bytes(self, frags, lengths):
        """(bodies uint8 [B, W], body_lens, crcs) with W >= F + 2048."""
        frags = self._in(frags)
        lengths = self._in(lengths).to(torch.int32)
        with span("codec.encode", frags.nbytes):
            bodies, body_lens = encode_rows(
                frags, lengths, self.kernel, self.hash_bits, self.skip_base
            )
            if self.with_crc:
                crcs = crc_rows(frags, lengths, self.kernel)
            else:
                crcs = torch.zeros_like(lengths)
        return bodies, body_lens, crcs

    def compress_batch(self, frags, lengths):
        """[B, F], [B] -> (bodies int32 [B, F+2048], body_lens [B], crcs [B])"""
        with span("codec.compress"):
            bodies, body_lens, crcs = self._compress_bytes(frags, lengths)
            W = self._in(frags).shape[1] + 2048
            return bodies[:, :W].to(torch.int32), body_lens, crcs

    def compress_batch_packed(self, frags, lengths):
        """compress_batch with word-packed bodies (int32, 4 LE bytes per
        word); lengths and CRCs unchanged."""
        with span("codec.compress"):
            bodies, body_lens, crcs = self._compress_bytes(frags, lengths)
            W = self._in(frags).shape[1] + 2048
            W += (-W) % 4
            with span("codec.pack", bodies.shape[0] * W, device=self.device):
                return pack_rows(bodies[:, :W]), body_lens, crcs

    def decompress_batch_fn(self, out_cap: int, packed: bool = False):
        """The decode function for one output capacity:
        (comp [B, C], comp_lens [B]) -> (outs, out_lens, errs)."""
        out_cap = int(out_cap)

        if packed and out_cap % 4:
            raise ValueError("packed output needs out_cap % 4 == 0")

        def fn(comp, comp_lens):
            with span("codec.decompress"):
                out, out_lens, errs = decode_rows(
                    self._in(comp), self._in(comp_lens), out_cap, self.kernel
                )
                return (out.view(torch.int32) if packed else out.to(torch.int32)), out_lens, errs

        return fn

    def decompress_batch(self, comp, comp_lens, out_cap: int | None = None,
                         packed: bool = False):
        """[B, C], [B] -> (outs [B, out_cap], out_lens [B], errs [B]);
        with ``packed``, outs is int32 [B, out_cap // 4] word-packed."""
        return self.decompress_batch_fn(out_cap or self.fragment_size, packed)(
            comp, comp_lens
        )

    def frame_batch(self, frags, lengths):
        """[B, F], [B] -> (framed uint8 [B, 8 + 3 + F + 2048], framed_lens
        [B]): the framing data-chunk pipeline (encode, masked CRC32C, varint
        preamble, chunk header, uncompressed fallback), leaving the host only
        the ragged concatenation of rows. Rows with length 0 get
        framed_len 0."""
        with span("codec.compress"):
            F = self.fragment_size
            PC = 3 + F + 2048  # varint (<= 3 bytes for F <= 64 KiB) + emission bound
            frags = self._in(frags).to(torch.uint8)
            lengths = self._in(lengths).to(torch.int32)
            B = frags.shape[0]
            bodies, body_lens, crcs = self._compress_bytes(frags, lengths)
            bodies = bodies[:, : F + 2048]

            # Masked CRC32C (Crc32CAlgorithm.cs:157) in uint32 space.
            c = crcs.to(torch.int64) & 0xFFFFFFFF
            masked = ((((c >> 15) | (c << 17)) & 0xFFFFFFFF) + CRC_MASK_DELTA) & 0xFFFFFFFF

            pre_len = torch.where(lengths < 128, 1, torch.where(lengths < 16384, 2, 3))
            b0 = torch.where(pre_len == 1, lengths & 0x7F, (lengths & 0x7F) | 0x80)
            b1 = torch.where(pre_len == 2, (lengths >> 7) & 0x7F, ((lengths >> 7) & 0x7F) | 0x80)
            b2 = (lengths >> 14) & 0x7F

            def shifted(k):  # bodies shifted right by k preamble bytes
                pre = torch.stack([b0, b1, b2][:k], dim=1).to(torch.uint8)
                pad = bodies.new_zeros((B, PC - k - bodies.shape[1]))
                return torch.cat([pre, bodies, pad], dim=1)

            comp_img = torch.where(
                (pre_len == 1)[:, None],
                shifted(1),
                torch.where((pre_len == 2)[:, None], shifted(2), shifted(3)),
            )
            comp_len = pre_len + body_lens

            # Incompressibility fallback (SnappyStreamCompressor.cs:213-229).
            fallback = comp_len >= lengths
            raw_img = torch.cat([frags, frags.new_zeros((B, PC - frags.shape[1]))], dim=1)
            payload = torch.where(fallback[:, None], raw_img, comp_img)
            payload_len = torch.where(fallback, lengths, comp_len)

            # Chunk header: type byte + 3-byte LE length (of CRC + payload).
            ctype = fallback.to(torch.int32)
            clen = payload_len + 4
            hdr = torch.stack(
                [ctype, clen & 0xFF, (clen >> 8) & 0xFF, (clen >> 16) & 0xFF], dim=1
            )
            crc_bytes = torch.stack([(masked >> (8 * i)) & 0xFF for i in range(4)], dim=1)
            framed = torch.cat([hdr.to(torch.uint8), crc_bytes.to(torch.uint8), payload], dim=1)
            framed_len = torch.where(lengths > 0, 8 + payload_len, 0).to(torch.int32)
            return framed, framed_len

    def frame_batch_packed(self, frags, lengths):
        """frame_batch with word-packed rows; pair with compact_words so a
        ragged framed batch ships to the host at its true size."""
        framed, flens = self.frame_batch(frags, lengths)
        B, PC = framed.shape
        pad = (-PC) % 4
        if pad:
            framed = torch.cat([framed, framed.new_zeros((B, pad))], dim=1)
        return pack_rows(framed), flens

    def roundtrip_step(self, frags, lengths):
        """Compress + decompress + bit-exact check: (bodies, body_lens,
        crcs, ok) with ``ok`` a bool tensor on the codec's device."""
        frags = self._in(frags)
        lengths = self._in(lengths).to(torch.int32)
        raw, body_lens, ok = roundtrip_rows(
            frags, lengths, self.kernel, self.hash_bits, self.skip_base
        )
        if self.with_crc:
            crcs = crc_rows(frags, lengths, self.kernel)
        else:
            crcs = torch.zeros_like(lengths)
        return raw.to(torch.int32), body_lens, crcs, ok
