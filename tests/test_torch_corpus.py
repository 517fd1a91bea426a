"""The port's parallel-scan engine on the corpus, cross-engine.

The twin of ``tests/test_ops.py::test_corpus_cross_engine`` for every name
of ``CORPUS_FILES``: 2 x 64 KiB of a stand-in built from a fixed function
of the name (``zlib.crc32``, stable across processes). The port's
``ops.encode.encode_block`` gives the JAX package's bytes fragment by
fragment, no longer than the oracle's stream, which the oracle decodes
back; ``ops.decode.decode_block`` decodes the stream from a bucket sized
to it (at least its length + 8 bytes). Every comparison is exact.
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappier_tpu.ops.encode import encode_block as jax_encode_block
from snappier_tpu_torch.constants import BLOCK_SIZE
from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.format.varint import write_varint
from snappier_tpu_torch.ops.decode import decode_block
from snappier_tpu_torch.ops.encode import encode_block
from tests.conftest import CORPUS_FILES

SIZE = 2 * BLOCK_SIZE
WORDS = [b"the", b"quick", b"brown", b"snappy", b"tpu", b"block", b"compress", b"format",
         b"stream", b"<html><body>"]


def standin(name: str, size: int = SIZE) -> bytes:
    """Random bytes for the compressed formats (jpeg, pdf), else a word mix,
    seeded by the name's CRC-32."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name.endswith((".jpeg", ".pdf")):
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    parts = rng.integers(0, len(WORDS), size // 3)
    return b" ".join(WORDS[i] for i in parts)[:size]


@pytest.mark.parametrize("name", CORPUS_FILES)
def test_port_scan_engine_corpus_cross_engine(name):
    data = standin(name)
    assert len(data) == SIZE
    comp = bytearray(write_varint(len(data)))
    for start in range(0, len(data), BLOCK_SIZE):
        buf = np.zeros(BLOCK_SIZE, np.int32)
        frag = np.frombuffer(data[start : start + BLOCK_SIZE], np.uint8)
        buf[: len(frag)] = frag
        out, out_len = encode_block(torch.from_numpy(buf), len(frag))
        j_out, j_len = jax_encode_block(jnp.asarray(buf), jnp.int32(len(frag)))
        n = int(out_len)
        assert n == int(j_len)
        assert (out[:n].numpy() == np.asarray(j_out)[:n]).all()
        comp += out[:n].numpy().astype(np.uint8).tobytes()
    comp = bytes(comp)
    assert oracle.decompress(comp) == data
    assert len(comp) <= len(oracle.compress(data))

    cap = -(-(len(comp) + 8) // 1024) * 1024
    row = np.zeros(cap, np.uint8)
    row[: len(comp)] = np.frombuffer(comp, np.uint8)
    out, out_len, err = decode_block(torch.from_numpy(row), len(comp), len(data))
    assert int(err) == 0 and int(out_len) == len(data)
    assert out[: len(data)].numpy().astype(np.uint8).tobytes() == data
