"""Parity of the port's kernel wrappers (``snappier_tpu_torch.ops.cuda``) with
the JAX scalar kernels in Pallas interpret mode.

On the CPU each wrapper runs its kernel's plain version; the CUDA kernels
are held against the plain versions in ``tests/test_torch_cuda.py``. Tolerance is exact equality throughout: nothing here is floating
point. Compared are the decoder's ``out[:out_len]``, ``out_len`` and error
word, the encoder's ``bodies[:len]`` and ``len``, and the CRC bits; bytes
past a length are unspecified on both sides.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappier_tpu.format import oracle
from snappier_tpu.ops.pallas.crc32c import crc32c_blocks as jax_crc32c_blocks
from snappier_tpu.ops.pallas.scalar_codec import (
    decode_blocks_scalar as jax_decode,
    encode_blocks_scalar as jax_encode,
)
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.ops.cuda.crc32c import crc32c_blocks
from snappier_tpu_torch.ops.cuda.scalar_codec import (
    decode_blocks_bytes,
    decode_blocks_scalar,
    encode_blocks_bytes,
    encode_blocks_scalar,
)
from snappier_tpu_torch.ops.decode import ERR_BAD_PREAMBLE
from tests.torch_cases import (
    block_stream,
    corrupt_streams,
    encode_rows,
    html_like,
    pack_streams,
    tag_sweep_sample,
)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_decode_equal(got, ref):
    out, out_lens, errs = (np.asarray(x) for x in got)
    r_out, r_lens, r_errs = (np.asarray(x) for x in ref)
    assert (errs == r_errs).all(), (errs, r_errs)
    assert (out_lens == r_lens).all(), (out_lens, r_lens)
    for i in range(len(out_lens)):
        assert (out[i, : out_lens[i]] == r_out[i, : r_lens[i]]).all(), i


def _decode_both(streams, cc, out_cap, packed=False):
    comp, lens = pack_streams(streams, cc)
    ref = jax_decode(jnp.asarray(comp), jnp.asarray(lens), out_cap=out_cap,
                     interpret=True, packed=packed)
    got = decode_blocks_scalar(_t(comp), _t(lens), out_cap=out_cap, packed=packed)
    return got, ref


def test_decode_matches_jax_on_oracle_streams():
    datas = [html_like(65536, 3).tobytes(), html_like(40000, 4).tobytes(), b"",
             b"a", bytes(65536), bytes(range(1, 6)) * 9000,
             np.random.default_rng(2).integers(0, 256, 3000, np.uint8).tobytes()]
    streams = [oracle.compress(np.frombuffer(d, np.uint8)) for d in datas]
    got, ref = _decode_both(streams, 68608, 65536)
    _assert_decode_equal(got, ref)
    assert (got[1].numpy() == [len(d) for d in datas]).all()
    assert (got[2].numpy() == 0).all()


def test_decode_matches_jax_on_corrupt_streams():
    got, ref = _decode_both(corrupt_streams(), 2048, 1024)
    _assert_decode_equal(got, ref)
    errs = got[2].numpy()
    assert errs[0] == ERR_BAD_PREAMBLE  # the empty row
    assert {0, 4, 7, 8} <= set(errs.tolist())


def test_decode_matches_jax_on_tag_sweep():
    """A sample of the exhaustive tag-byte sweep: every tag class and
    extra-field pattern, accepted and rejected."""
    got, ref = _decode_both(tag_sweep_sample(), 1024, 2048)
    _assert_decode_equal(got, ref)
    assert (got[2].numpy() == 0).sum() >= 10


def test_decode_packed_matches_jax():
    streams = [oracle.compress(np.frombuffer(d, np.uint8)) for d in (
        b"packed words " * 70, b"xyz", bytes(1024))]
    got, ref = _decode_both(streams, 2048, 1024, packed=True)
    assert got[0].dtype == torch.int32 and got[0].shape == (3, 256)
    out = got[0].numpy().view(np.uint8)
    r_out = np.asarray(ref[0]).view(np.uint8)
    for i, n in enumerate(np.asarray(ref[1])):
        assert (out[i, :n] == r_out[i, :n]).all(), i
    assert (got[1].numpy() == np.asarray(ref[1])).all()


@pytest.mark.parametrize("F", [1024, 8192, 65536])
def test_encode_matches_jax(F):
    frags, lens = encode_rows(F)
    ref_b, ref_l = (np.asarray(x) for x in jax_encode(
        jnp.asarray(frags), jnp.asarray(lens), interpret=True))
    bodies, body_lens = encode_blocks_scalar(_t(frags), _t(lens))
    assert bodies.dtype == torch.int32 and bodies.shape == ref_b.shape
    bodies, body_lens = bodies.numpy(), body_lens.numpy()
    assert (body_lens == ref_l).all(), (body_lens, ref_l)
    for i in range(len(lens)):
        assert (bodies[i, : body_lens[i]] == ref_b[i, : ref_l[i]]).all(), i
    if F >= 8192:
        # Copy-2 offsets >= 2048 are reached (tag byte 2 | (len-1) << 2).
        body = bodies[0, : body_lens[0]].astype(np.uint8)
        assert oracle.decompress(block_stream(lens[0], body)) == frags[0].astype(
            np.uint8).tobytes()


def test_encode_packed_shape_matches_jax():
    frags, lens = encode_rows(1024)
    ref_p, ref_l = jax_encode(jnp.asarray(frags), jnp.asarray(lens), interpret=True,
                              packed=True)
    got_p, got_l = encode_blocks_scalar(_t(frags), _t(lens), packed=True)
    assert got_p.shape == ref_p.shape and got_p.dtype == torch.int32
    gb = got_p.numpy().view(np.uint8)
    rb = np.asarray(ref_p).view(np.uint8)
    for i, n in enumerate(np.asarray(ref_l)):
        assert (gb[i, :n] == rb[i, :n]).all(), i


@pytest.mark.parametrize("hash_bits,skip_base", [(12, 32), (16, 64)])
def test_encode_options_match_jax(hash_bits, skip_base):
    frags, lens = encode_rows(8192, seed=9)
    ref_b, ref_l = (np.asarray(x) for x in jax_encode(
        jnp.asarray(frags), jnp.asarray(lens), interpret=True, hash_bits=hash_bits,
        skip_base=skip_base))
    bodies, body_lens = encode_blocks_scalar(_t(frags), _t(lens), hash_bits=hash_bits,
                                             skip_base=skip_base)
    assert (body_lens.numpy() == ref_l).all()
    for i, n in enumerate(ref_l):
        assert (bodies.numpy()[i, :n] == ref_b[i, :n]).all(), i


def test_crc_matches_jax_with_garbage_tails():
    rng = np.random.default_rng(7)
    lens = np.array([0, 1, 15, 16, 17, 4095, 57344, 65533, 65536], np.int32)
    frags = rng.integers(0, 256, (len(lens), 65536)).astype(np.int32)
    ref = np.asarray(jax_crc32c_blocks(jnp.asarray(frags), jnp.asarray(lens),
                                       interpret=True))
    got = crc32c_blocks(_t(frags), _t(lens))
    assert got.dtype == torch.int32
    assert (got.numpy() == ref).all(), (got, ref)


def test_wrappers_take_uint8_and_int32_rows():
    frags, lens = encode_rows(1024)
    a = encode_blocks_bytes(_t(frags), _t(lens))
    b = encode_blocks_bytes(_t(frags.astype(np.uint8)), _t(lens.astype(np.int64)))
    assert (a[1] == b[1]).all()
    for i, n in enumerate(a[1].tolist()):
        assert (a[0][i, :n] == b[0][i, :n]).all()
    c1 = crc32c_blocks(_t(frags), _t(lens))
    c2 = crc32c_blocks(_t(frags.astype(np.uint8)), _t(lens))
    assert (c1 == c2).all()


def test_wrappers_reject_bad_arguments():
    rows = torch.zeros((2, 1024), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        encode_blocks_bytes(rows.float(), lens)
    with pytest.raises(ValueError):
        encode_blocks_bytes(rows, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        encode_blocks_bytes(torch.zeros((2, 65537), dtype=torch.uint8), lens)
    with pytest.raises(ValueError):
        encode_blocks_bytes(rows, lens, hash_bits=17)
    with pytest.raises(ValueError):
        decode_blocks_bytes(rows, lens, out_cap=1 << 20)
    with pytest.raises(ValueError):
        decode_blocks_scalar(rows, lens, out_cap=1022, packed=True)
    with pytest.raises(ValueError):
        crc32c_blocks(rows[0], lens)


def test_cpu_path_launches_no_kernel():
    _build.reset_launches()
    frags, lens = encode_rows(1024)
    encode_blocks_bytes(_t(frags), _t(lens))
    crc32c_blocks(_t(frags), _t(lens))
    assert sum(_build.LAUNCHES.values()) == 0


def test_build_names_every_source():
    assert set(_build.SOURCES) == {"decode", "encode", "crc32c"}
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        assert _build._lib_path(name).name.startswith(f"lib{name}-")
