"""Parity of the port's framing-format oracle
(``snappier_tpu_torch/format/framing.py``) with
``snappier_tpu.format.framing``: the same seeded inputs through both,
bytes and exception classes equal (tolerance: none)."""

from __future__ import annotations

import numpy as np
import pytest

import snappier_tpu.errors as ref_errors
import snappier_tpu.format.framing as ref
import snappier_tpu_torch.errors as port_errors
import snappier_tpu_torch.format.framing as port
from snappier_tpu_torch.constants import STREAM_HEADER
from tests.torch_cases import html_like, stream_inputs

INPUTS = stream_inputs()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_frame_compress_matches_reference(name):
    data = INPUTS[name]
    framed = port.frame_compress(data)
    assert framed == ref.frame_compress(data)
    assert framed.startswith(STREAM_HEADER)
    assert port.frame_decompress(framed) == data == ref.frame_decompress(framed)
    assert list(port.iter_chunks(framed)) == list(ref.iter_chunks(framed))


def test_frame_compress_takes_another_block_codec():
    def store(block: bytes) -> bytes:  # never shrinks: every chunk falls back
        return b"\x00" + block

    data = INPUTS["three_chunks"]
    framed = port.frame_compress(data, store)
    assert framed == ref.frame_compress(data, store)
    assert {t for t, _, _ in port.iter_chunks(framed)} == {0xFF, 0x01}
    assert port.frame_decompress(framed) == data


def test_compress_chunk_fallback_rule():
    block = html_like(500, 3).tobytes()
    for comp_len, want_type in ((499, 0x00), (500, 0x01), (501, 0x01)):
        fn = lambda b, n=comp_len: bytes(n)  # noqa: E731
        chunk = port.compress_chunk(block, fn)
        assert chunk == ref.compress_chunk(block, fn)
        assert chunk[0] == want_type
    with pytest.raises(ValueError):
        port.compress_chunk(bytes(65537), bytes)


def test_write_chunk_header_matches_reference():
    for ctype, n in ((0, 0), (1, 4), (0xFE, 65540), (0xFF, 6), (0x80, (1 << 24) - 1)):
        assert port.write_chunk_header(ctype, n) == ref.write_chunk_header(ctype, n)
    for mod in (port, ref):
        with pytest.raises(ValueError):
            mod.write_chunk_header(0, 1 << 24)


def _corrupt_streams() -> dict[str, bytes]:
    data = html_like(3000, 4).tobytes()
    framed = port.frame_compress(data)
    raw = port.frame_compress(np.random.default_rng(5).integers(0, 256, 300, np.uint8).tobytes())
    flip = lambda s, i: s[:i] + bytes([s[i] ^ 0xFF]) + s[i + 1 :]  # noqa: E731
    return {
        "crc_byte": flip(framed, 14),
        "payload_byte": flip(framed, len(framed) - 1),
        "raw_payload_byte": flip(raw, len(raw) - 1),
        "truncated_payload": framed[:-3],
        "truncated_header": framed[:12],
        "headerless": framed[10:],
        "bad_identifier": framed[:4] + b"sNaPpX" + framed[10:],
        "unskippable_type": framed[:10] + bytes([0x40, 1, 0, 0, 0]) + framed[10:],
        "chunk_shorter_than_crc": framed[:10] + bytes([0x00, 2, 0, 0, 1, 2]),
        "bad_block": framed[:10] + bytes([0x00, 7, 0, 0, 0, 0, 0, 0, 0x05, 0x01, 0x00]),
    }


CORRUPT = _corrupt_streams()


@pytest.mark.parametrize("name", sorted(CORRUPT))
def test_corrupt_streams_raise_like_reference(name):
    with pytest.raises(ref_errors.InvalidDataError) as r:
        ref.frame_decompress(CORRUPT[name])
    with pytest.raises(port_errors.InvalidDataError) as p:
        port.frame_decompress(CORRUPT[name])
    assert str(p.value) == str(r.value)


def test_skippable_and_padding_chunks_are_skipped():
    data = b"skippable chunk test " * 300
    framed = port.frame_compress(data)
    extra = port.write_chunk_header(0x85, 3) + b"xyz" + port.write_chunk_header(0xFE, 5) + bytes(5)
    framed = framed[:10] + extra + framed[10:] + STREAM_HEADER
    assert port.frame_decompress(framed) == data == ref.frame_decompress(framed)
