"""The port's parallel-scan engine on the corpus, cross-engine.

The twin of ``tests/test_ops.py::test_corpus_cross_engine`` for every name
of ``CORPUS_FILES``: 2 x 64 KiB of the ratio table's stand-in
(``tools/torch_ratio_table.py::standin``, seeded by the name's CRC-32).
The port's ``ops.encode.encode_block`` gives the JAX package's bytes
fragment by fragment, no longer than the oracle's stream, which the oracle
decodes back; ``ops.decode.decode_block`` decodes the stream from a bucket
sized to it (at least its length + 8 bytes). Every comparison is exact.
"""

from __future__ import annotations

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
from tools.torch_ratio_table import standin

SIZE = 2 * BLOCK_SIZE


@pytest.mark.parametrize("name", CORPUS_FILES)
def test_port_scan_engine_corpus_cross_engine(name):
    data = standin(name, SIZE)
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
