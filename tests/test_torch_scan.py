"""The port's parallel-scan engine (``snappier_tpu_torch/ops/{decode,encode,
crc32c}.py``) against the JAX package's (``snappier_tpu/ops``) on the CPU.

The same inputs, made with numpy from fixed seeds, go through both. Every
comparison is exact: the engine is integer code, so bodies, lengths, decoded
rows, error words and CRC bit patterns have no tolerance. The JAX functions
take one row at a time (each new shape compiles once); the port's batched
forms take the rows together and are also held against their own one-row
forms.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from snappier_tpu.format import oracle
from snappier_tpu.format.crc32c import crc32c as crc_host
from snappier_tpu.ops.crc32c import crc32c_block as jax_crc32c_block
from snappier_tpu.ops.decode import decode_block as jax_decode_block
from snappier_tpu.ops.encode import encode_block as jax_encode_block
from snappier_tpu_torch.ops import crc32c_block, decode_block, encode_block
from snappier_tpu_torch.ops.crc32c import crc32c_blocks_scan
from snappier_tpu_torch.ops.decode import decode_blocks_scan
from snappier_tpu_torch.ops.encode import FRAGMENT_SLACK, encode_blocks_scan
from tests.test_ops import SMALL_CASES
from tests.torch_cases import (
    block_stream,
    corrupt_streams,
    encode_rows,
    html_like,
    pack_streams,
    walk_streams,
)

CAP = 4096  # one compressed-row width and
OUT = 2048  # one output capacity for the decode tests: one JAX compile each


def _zero_tail(frags, lens):
    """The scan encoder's contract: rows zero-padded past their length."""
    return np.where(np.arange(frags.shape[1])[None, :] < lens[:, None], frags, 0).astype(np.int32)


def _jax_decode(row, n, out_cap=OUT):
    out, out_len, err = jax_decode_block(jnp.asarray(row), jnp.int32(n), out_cap)
    return np.asarray(out), int(out_len), int(err)


def _decode_both(streams, cap=CAP, out_cap=OUT, garbage_seed=None):
    """Decode ``streams`` with the port (one batch) and the JAX function
    (row by row) and hold every result equal; returns the port's."""
    comp, lens = pack_streams(streams, cap, garbage_seed=garbage_seed)
    out, out_len, err = decode_blocks_scan(torch.from_numpy(comp), torch.from_numpy(lens), out_cap)
    assert out.dtype == torch.int32 and out.shape == (len(streams), out_cap)
    for i in range(len(streams)):
        j_out, j_len, j_err = _jax_decode(comp[i], lens[i], out_cap)
        assert int(err[i]) == j_err, (i, int(err[i]), j_err)
        assert int(out_len[i]) == j_len, i
        assert (out[i].numpy() == j_out).all(), i
    return out.numpy(), out_len.numpy(), err.numpy()


@pytest.mark.parametrize("F", [1024, 4096])
def test_encode_matches_jax(F):
    frags, lens = encode_rows(F)
    frags = _zero_tail(frags, lens)
    out, out_len = encode_blocks_scan(torch.from_numpy(frags), torch.from_numpy(lens))
    assert out.shape == (len(lens), F + FRAGMENT_SLACK) and out.dtype == torch.int32
    for i, n in enumerate(lens):
        j_out, j_len = jax_encode_block(jnp.asarray(frags[i]), jnp.int32(n))
        assert int(out_len[i]) == int(j_len), i
        assert (out[i].numpy() == np.asarray(j_out)).all(), i
        blk = block_stream(n, out[i, : out_len[i]].numpy())
        assert oracle.decompress(blk) == frags[i, :n].astype(np.uint8).tobytes()
        assert len(blk) <= len(oracle.compress(frags[i, :n].astype(np.uint8)))


@pytest.mark.parametrize("data", SMALL_CASES, ids=range(len(SMALL_CASES)))
def test_small_cases_match_jax(data):
    """The small cases of tests/test_ops.py: encode, decode of the port's
    and of the oracle's stream, CRC, each equal to the JAX function's."""
    F = 1024
    row = np.zeros(F, np.int32)
    row[: len(data)] = np.frombuffer(data, np.uint8)
    out, out_len = encode_block(torch.from_numpy(row), len(data))
    j_out, j_len = jax_encode_block(jnp.asarray(row), jnp.int32(len(data)))
    assert int(out_len) == int(j_len) and (out.numpy() == np.asarray(j_out)).all()
    mine = block_stream(len(data), out[: int(out_len)].numpy())
    got, got_len, err = _decode_both([mine, oracle.compress(np.frombuffer(data, np.uint8))])
    assert (err == 0).all() and (got_len == len(data)).all()
    assert got[0, : len(data)].astype(np.uint8).tobytes() == data
    assert got[1, : len(data)].astype(np.uint8).tobytes() == data
    crc = crc32c_block(torch.from_numpy(row), len(data))
    assert int(crc) == int(jax_crc32c_block(jnp.asarray(row), jnp.int32(len(data))))
    assert int(crc) & 0xFFFFFFFF == crc_host(data)


def test_decode_corrupt_and_edge_streams_match_jax():
    """Corrupt and edge blocks (those of tests/test_ops.py:73-82 among them):
    the same separate error bits as the JAX decoder, with zeros and with
    garbage past each length."""
    streams = corrupt_streams()
    _, _, err = _decode_both(streams)
    for bad in (1, 3, 4, 5, 6):  # varint, literal overrun, early copy, short, long
        assert err[bad] != 0, bad
    assert set(err.tolist()) >= {0, 2, 4, 8}  # separate bits, not one combined word
    _decode_both(streams, garbage_seed=5)


def test_decode_copy4_short_copy2_and_patterns_match_jax():
    """tests/test_ops.py:85-102: a 4-byte-offset copy, a 1-byte copy-2, and
    overlapping copies at every offset 1..17."""
    lit = bytes([(4 - 1) << 2])
    streams = [
        bytes([8]) + lit + b"abcd" + bytes([3 | (3 << 2), 4, 0, 0, 0]),
        bytes([5]) + lit + b"wxyz" + bytes([2 | (1 - 1) << 2, 2, 0]),
    ] + walk_streams()
    out, out_len, err = _decode_both(streams)
    assert (err == 0).all()
    assert out[0, :8].astype(np.uint8).tobytes() == b"abcdabcd"
    assert out[1, :5].astype(np.uint8).tobytes() == b"wxyzy"
    for i, s in enumerate(streams):
        assert out[i, : out_len[i]].astype(np.uint8).tobytes() == oracle.decompress(s), i


def test_full_block_matches_jax():
    """One 64 KiB row each through encode, decode and CRC."""
    F = 65536
    row = html_like(F, 9).astype(np.int32)
    row[40000:41000] = np.random.default_rng(2).integers(0, 256, 1000)
    out, out_len = encode_block(torch.from_numpy(row), F)
    j_out, j_len = jax_encode_block(jnp.asarray(row), jnp.int32(F))
    assert int(out_len) == int(j_len) and (out.numpy() == np.asarray(j_out)).all()
    blk = block_stream(F, out[: int(out_len)].numpy())
    cap = F + 3072
    comp, lens = pack_streams([blk], cap, garbage_seed=None)
    d_out, d_len, d_err = decode_block(torch.from_numpy(comp[0]), int(lens[0]), F)
    j = _jax_decode(comp[0], lens[0], F)
    assert (int(d_len), int(d_err)) == (j[1], j[2]) == (F, 0)
    assert (d_out.numpy() == j[0]).all() and (d_out.numpy() == row).all()
    crc = crc32c_block(torch.from_numpy(row), F)
    assert int(crc) == int(jax_crc32c_block(jnp.asarray(row), jnp.int32(F)))
    assert int(crc) & 0xFFFFFFFF == crc_host(row.astype(np.uint8).tobytes())


@pytest.mark.parametrize("n", [0, 1, 100, 1023, 1024])
def test_crc_matches_jax_and_host(n):
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 256, (3, 1024)).astype(np.int32)  # garbage past n too
    got = crc32c_blocks_scan(torch.from_numpy(rows), torch.full((3,), n, dtype=torch.int32))
    for i in range(3):
        assert int(got[i]) == int(jax_crc32c_block(jnp.asarray(rows[i]), jnp.int32(n)))
        assert int(got[i]) & 0xFFFFFFFF == crc_host(rows[i, :n].astype(np.uint8).tobytes())


def test_batched_forms_equal_one_row_forms_across_slabs(monkeypatch):
    """The batch axis runs in slabs; a slab boundary changes nothing."""
    from snappier_tpu_torch.ops import crc32c as crc_mod
    from snappier_tpu_torch.ops import decode as dec_mod
    from snappier_tpu_torch.ops import encode as enc_mod

    for mod in (crc_mod, dec_mod, enc_mod):
        monkeypatch.setattr(mod, "SLAB_ROWS", 3)
    F = 1024
    frags, lens = encode_rows(F, seed=4)
    frags = _zero_tail(frags, lens)
    f_t, l_t = torch.from_numpy(frags), torch.from_numpy(lens)
    out, out_len = encode_blocks_scan(f_t, l_t)
    crcs = crc32c_blocks_scan(f_t, l_t)
    streams = [block_stream(n, out[i, : out_len[i]].numpy()) for i, n in enumerate(lens)]
    comp, clens = pack_streams(streams + corrupt_streams(), CAP, garbage_seed=None)
    d_out, d_len, d_err = decode_blocks_scan(torch.from_numpy(comp), torch.from_numpy(clens), OUT)
    for i in range(len(lens)):
        o1, n1 = encode_block(f_t[i], int(lens[i]))
        assert int(n1) == int(out_len[i]) and (o1 == out[i]).all()
        assert int(crc32c_block(f_t[i], int(lens[i]))) == int(crcs[i])
    for i in range(len(clens)):
        o1, n1, e1 = decode_block(torch.from_numpy(comp[i]), int(clens[i]), OUT)
        assert (int(n1), int(e1)) == (int(d_len[i]), int(d_err[i])) and (o1 == d_out[i]).all()
    empty = decode_blocks_scan(torch.zeros((0, 64), dtype=torch.int32),
                               torch.zeros(0, dtype=torch.int32), 32)
    assert empty[0].shape == (0, 32) and empty[1].shape == (0,)
    assert encode_blocks_scan(torch.zeros((0, 64), dtype=torch.int32),
                              torch.zeros(0, dtype=torch.int32))[0].shape == (0, 64 + FRAGMENT_SLACK)


def test_uint8_rows_give_the_int32_rows_results():
    F = 1024
    frags, lens = encode_rows(F, seed=6)
    frags = _zero_tail(frags, lens)
    f32, f8, l_t = torch.from_numpy(frags), torch.from_numpy(frags.astype(np.uint8)), \
        torch.from_numpy(lens)
    for a, b in zip(encode_blocks_scan(f32, l_t), encode_blocks_scan(f8, l_t)):
        assert (a == b).all()
    assert (crc32c_blocks_scan(f32, l_t) == crc32c_blocks_scan(f8, l_t)).all()


_BASE = [oracle.compress(np.frombuffer(d, np.uint8)) for d in (
    b"the quick brown snappy fox " * 12, bytes(range(1, 6)) * 60, b"a" * 300,
    html_like(600, 8).tobytes(),
)]


@settings(max_examples=40, deadline=None)
@given(
    base=hst.integers(0, len(_BASE) - 1),
    edits=hst.lists(hst.tuples(hst.integers(0, 399), hst.integers(0, 255)), min_size=1, max_size=4),
    cut=hst.integers(0, 40),
)
def test_mutated_blocks_give_jax_error_words(base, edits, cut):
    """Valid blocks with a few bytes overwritten and the tail cut: error
    words, claimed lengths and, where both accept, the decoded bytes equal
    the JAX decoder's, whatever int32 wrap the corruption provokes."""
    s = bytearray(_BASE[base])
    for at, val in edits:
        s[at % len(s)] = val
    s = bytes(s[: len(s) - cut])
    comp, lens = pack_streams([s], 1024, garbage_seed=None)
    out, out_len, err = decode_block(torch.from_numpy(comp[0]), int(lens[0]), 1024)
    j_out, j_len, j_err = _jax_decode(comp[0], lens[0], 1024)
    assert (int(err), int(out_len)) == (j_err, j_len)
    assert (out.numpy() == j_out).all()
