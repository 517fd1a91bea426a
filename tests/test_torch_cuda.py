"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
module imports nothing of JAX, so on a machine with a card and no JAX it
runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance is exact equality: the kernels compute bytes and CRC bits.
Bytes past a row's length are unspecified and never compared.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from snappier_tpu_torch import SnappyCodec
from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.ops.cuda.crc32c import crc32c_blocks, crc32c_blocks_plain
from snappier_tpu_torch.ops.cuda.scalar_codec import (
    decode_blocks_bytes,
    decode_blocks_plain,
    encode_blocks_bytes,
    encode_blocks_plain,
)
# Imported by its own name (pytest puts this directory on sys.path): a
# package named ``tests`` elsewhere on the path may shadow ``tests.``.
from torch_cases import block_stream, corrupt_streams, encode_rows, pack_streams

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows_equal(a, b, lens):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert a.shape == b.shape
    for i, n in enumerate(lens.tolist()):
        assert (a[i, :n] == b[i, :n]).all(), i


@pytest.mark.parametrize("F", [1024, 8192, 65536])
def test_cuda_kernels_match_plain(cuda_device, F):
    frags, lens = encode_rows(F)
    f_c, l_c = _t(frags).to(cuda_device), _t(lens).to(cuda_device)
    _build.reset_launches()
    bodies, body_lens = encode_blocks_bytes(f_c, l_c)
    crcs = crc32c_blocks(f_c, l_c)
    torch.cuda.synchronize()
    p_bodies, p_lens = encode_blocks_plain(_t(frags.astype(np.uint8)), _t(lens), 15, 32)
    assert (body_lens.cpu() == p_lens).all()
    _rows_equal(bodies, p_bodies, p_lens)
    assert (crcs.cpu() == crc32c_blocks_plain(_t(frags.astype(np.uint8)), _t(lens))).all()

    streams = corrupt_streams() + [
        block_stream(n, p_bodies[i, : p_lens[i]].numpy()) for i, n in enumerate(lens)]
    comp, clens = pack_streams(streams, F + 4096)
    got = decode_blocks_bytes(_t(comp).to(cuda_device), _t(clens).to(cuda_device), F)
    torch.cuda.synchronize()
    ref = decode_blocks_plain(_t(comp.astype(np.uint8)), _t(clens), F)
    assert (got[2].cpu() == ref[2]).all() and (got[1].cpu() == ref[1]).all()
    _rows_equal(got[0], ref[0], ref[1])
    assert dict(_build.LAUNCHES) == {"encode": 1, "crc32c": 1, "decode": 1}


@pytest.mark.parametrize("hash_bits,skip_base", [(12, 32), (16, 64)])
def test_cuda_encode_options_match_plain(cuda_device, hash_bits, skip_base):
    frags, lens = encode_rows(8192, seed=9)
    bodies, body_lens = encode_blocks_bytes(_t(frags).to(cuda_device), _t(lens).to(cuda_device),
                                            hash_bits=hash_bits, skip_base=skip_base)
    p_bodies, p_lens = encode_blocks_plain(_t(frags.astype(np.uint8)), _t(lens), hash_bits,
                                           skip_base)
    assert (body_lens.cpu() == p_lens).all()
    _rows_equal(bodies, p_bodies, p_lens)


def test_cuda_codec_matches_cpu_codec(cuda_device):
    F = 4096
    frags, lens = encode_rows(F, seed=3)
    lens[-1] = 0
    gpu = SnappyCodec(fragment_size=F)
    cpu = SnappyCodec(fragment_size=F, device="cpu")
    gb, gl, gc = gpu.compress_batch(frags, lens)
    cb, cl, cc = cpu.compress_batch(frags, lens)
    assert gb.device.type == "cuda" and gb.shape == cb.shape
    assert (gl.cpu() == cl).all() and (gc.cpu() == cc).all()
    _rows_equal(gb, cb, cl)

    gf, gfl = gpu.frame_batch(frags, lens)
    cf, cfl = cpu.frame_batch(frags, lens)
    assert (gfl.cpu() == cfl).all()
    _rows_equal(gf, cf, cfl)

    *_, ok = gpu.roundtrip_step(frags, lens)
    assert bool(ok)
    for i, n in enumerate(lens.tolist()):
        blk = block_stream(n, cb[i, : cl[i]].numpy())
        assert oracle.decompress(blk) == frags[i, :n].astype(np.uint8).tobytes(), i
