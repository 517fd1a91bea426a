"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
module imports nothing of JAX, so on a machine with a card and no JAX it
runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance is exact equality: the kernels compute bytes and CRC bits, the
pre-passes integer descriptors.
Bytes past a row's length are unspecified and never compared.
"""

from __future__ import annotations

import asyncio
import collections
import io

import numpy as np
import pytest
import torch

import snappier_tpu_torch as st
import snappier_tpu_torch.runtime.stream as S
from snappier_tpu_torch import SnappyCodec
from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.ops.best_match import (
    DEFAULT_WIDTHS,
    candidates_layout,
    exact_candidates,
    exact_candidates_plain,
)
from snappier_tpu_torch.ops.cuda import _build, watch
from snappier_tpu_torch.ops.cuda import decode_hybrid as dh
from snappier_tpu_torch.ops.cuda import decode_variants as dv
from snappier_tpu_torch.ops.cuda import encode_variants as ev
from snappier_tpu_torch.ops.cuda import hybrid_probes as hp
from snappier_tpu_torch.ops.cuda import scalar_codec as sc
from snappier_tpu_torch.ops.cuda.crc32c import crc32c_blocks, crc32c_blocks_plain, crc32c_layout
from snappier_tpu_torch.ops.cuda.scalar_codec import (
    _encode_best,
    decode_blocks_bytes,
    decode_blocks_plain,
    encode_best_plain,
    encode_blocks_bytes,
    encode_blocks_plain,
    match_extension_probe,
)
# Imported by their own names (pytest puts this directory on sys.path): a
# package named ``tests`` elsewhere on the path may shadow ``tests.``.
from test_match_length import VECTORS, _layout
from torch_cases import (
    BATCH_EDGE_COUNTS,
    CRC_LENGTHS,
    PIPE_CASES,
    batch_streams,
    best_rows,
    block_stream,
    corrupt_streams,
    count_records,
    crc_rows,
    empty_literal_streams,
    encode_rows,
    html_like,
    invalid_collision_row,
    long_walk_rows,
    pack_streams,
    planted_matches,
    probe_blocks,
    step_back_streams,
    vcopy_edges,
    walk_streams,
)

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


def test_cuda_rocksdb_blocks_at_the_codec_table(cuda_device):
    """16,384 rows of 4 KiB (one 64 MiB SST file of RocksDB's default data
    blocks) through ``SnappyCodec()`` on the card: one encode launch at 13
    table bits, whose bodies equal the plain version's at 13 bits byte for
    byte, and a round trip through the decode kernel that gives every row
    back. The plain version walks 1,024 distinct rows; row i of the batch is
    distinct row i % 1,024. Every other markup row has one byte in eight
    replaced by a random one: thousands of distinct keys a row, so a walk
    at another table width gives other bytes (the markup alone does not)."""
    F, B, D = 4096, 16384, 1024
    rng = np.random.default_rng(27)
    base, base_lens = encode_rows(F, seed=27)
    distinct = rng.integers(0, 256, (D, F)).astype(np.uint8)
    lens = rng.integers(1, F + 1, D).astype(np.int32)
    lens[: D // 2] = F
    distinct[: len(base)], lens[: len(base)] = base, base_lens
    for i in range(len(base), D):
        distinct[i, : lens[i]] = html_like(int(lens[i]), i)
        if i % 2:
            noise = rng.random(lens[i]) < 1 / 8
            distinct[i, : lens[i]][noise] = rng.integers(0, 256, int(noise.sum()))
    idx = np.arange(B) % D
    f_c, l_c = _t(distinct[idx]).to(cuda_device), _t(lens[idx]).to(cuda_device)
    codec = SnappyCodec(fragment_size=F, with_crc=False)
    assert codec.hash_bits == 13
    _build.reset_launches()
    bodies, body_lens, _ = codec.compress_batch(f_c, l_c)
    torch.cuda.synchronize()
    assert dict(_build.ENCODE_TABLE_BITS) == {13: 1}
    p_bodies, p_lens = encode_blocks_plain(_t(distinct), _t(lens), 13, 32)
    assert (body_lens.cpu() == p_lens[idx]).all()
    W = bodies.shape[1]
    got = bodies.cpu().to(torch.uint8)
    want = p_bodies[:, :W][idx]
    col = torch.arange(W)[None, :]
    assert bool(torch.where(col < p_lens[idx][:, None], got == want, True).all())
    _, _, _, ok = codec.roundtrip_step(f_c, l_c)
    torch.cuda.synchronize()
    assert bool(ok) and _build.LAUNCHES["decode"] == 1


@pytest.mark.parametrize("F,bits", [(4096, 13), (65536, 15)])
def test_cuda_codec_launches_its_table_width(cuda_device, F, bits):
    """The codec's default table by its fragment, counted by the encode
    wrapper at each launch."""
    frags, lens = encode_rows(F)
    codec = SnappyCodec(fragment_size=F, with_crc=False)
    _build.reset_launches()
    codec.compress_batch_packed(_t(frags).to(cuda_device), _t(lens).to(cuda_device))
    torch.cuda.synchronize()
    assert codec.hash_bits == bits and dict(_build.ENCODE_TABLE_BITS) == {bits: 1}


def test_cuda_encode_layout_at_13_and_15_bits(cuda_device):
    """A 13-bit table (16 KiB of shared memory) holds more than three times
    the walks an SM of the 15-bit one (64 KiB)."""
    frags = torch.zeros((16, 4096), dtype=torch.uint8, device=cuda_device)
    l13, l15 = sc.encode_layout(frags, 13), sc.encode_layout(frags, 15)
    assert l13["smem_bytes"] == 16384 and l15["smem_bytes"] == 65536
    assert l15["blocks_per_sm"] >= 3
    assert l13["blocks_per_sm"] > 3 * l15["blocks_per_sm"], (l13, l15)


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


@pytest.mark.parametrize("F", [4096, 65536])
def test_cuda_best_kernel_matches_plain(cuda_device, F):
    frags, lens = best_rows(F, lens=(F, F - 7, 3000, 17, 1, 0))
    f_c, l_c = _t(frags).to(cuda_device), _t(lens).to(cuda_device)
    cands = exact_candidates(f_c, l_c)
    assert (cands.cpu() == exact_candidates(_t(frags), _t(lens))).all()
    _build.reset_launches()
    bodies, body_lens = _encode_best(f_c, l_c, cands)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"encode_best": 1}
    p_bodies, p_lens = encode_best_plain(_t(frags.astype(np.uint8)), _t(lens), cands.cpu(), 32)
    assert (body_lens.cpu() == p_lens).all()
    _rows_equal(bodies, p_bodies, p_lens)
    for i, n in enumerate(lens.tolist()):
        assert oracle.decompress(block_stream(n, p_bodies[i, : p_lens[i]].numpy())) == (
            frags[i, :n].astype(np.uint8).tobytes()), i


@pytest.mark.parametrize("widths", [DEFAULT_WIDTHS, (4,), (4, 8, 16, 32, 64, 128, 256)],
                         ids=["default", "w4", "to256"])
@pytest.mark.parametrize("F", [4096, 65536])
def test_cuda_best_candidates_match_plain(cuda_device, F, widths):
    """The candidate-search kernel against its plain version, bit for bit:
    every kind of torch_cases.best_rows (markup, periods 1-7, random and
    zeros: width-4 keys all alike and none alike) at lengths F, F - 7, 3000,
    17, 1 and 0, the rows 0, 1 and 3 bytes into their buffer; one launch a
    call."""
    frags, lens = best_rows(F, lens=(F, F - 7, 3000, 17, 1, 0))
    want = exact_candidates_plain(_t(frags), _t(lens), widths)
    l_c = _t(lens).to(cuda_device)
    for offset in (0, 1, 3):
        rows = _offset_rows(frags, offset, cuda_device)
        _build.reset_launches()
        got = exact_candidates(rows, l_c, widths)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {"best_candidates": 1}
        assert got.dtype == torch.int32 and got.device == rows.device
        assert (got.cpu() == want).all(), offset


def test_cuda_best_candidates_pair_a_left_out_position(cuda_device):
    """A width-8 key equal to a left-out position's (0x7F000000 + p, p), and
    a width-4 key whose hi is a left-out position's: the plain version's
    pairs, no more."""
    row, n, at, p, q = invalid_collision_row()
    frags, lens = _t(row[None]), torch.tensor([n], dtype=torch.int32)
    for widths in (DEFAULT_WIDTHS, (4,)):
        want = exact_candidates_plain(frags, lens, widths)
        got = exact_candidates(frags.to(cuda_device), lens.to(cuda_device), widths).cpu()
        assert (got == want).all() and int(got[0, q]) == -1
        assert int(got[0, p]) == (at if 8 in widths else -1)


def test_cuda_best_candidates_long_walks_sort_whole(cuda_device):
    """The worst case of the bucket walk (torch_cases.long_walk_rows: 48
    keys of one bucket, the first repeated): each row sorts that width by
    its whole key, counted once a row, and the candidates stay the plain
    version's; the ordinary rows of best_rows count none."""
    from snappier_tpu_torch.ops.best_match import launch_candidates

    rows, lens = long_walk_rows()
    fallbacks = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = launch_candidates(_t(rows).to(cuda_device), _t(lens).to(cuda_device),
                            DEFAULT_WIDTHS, fallbacks)
    assert (got.cpu() == exact_candidates_plain(_t(rows), _t(lens))).all()
    assert int(fallbacks) == 2
    frags, blens = best_rows(65536, lens=(65536, 3000))
    fallbacks.zero_()
    got = launch_candidates(_t(frags.astype(np.uint8)).to(cuda_device),
                            _t(blens).to(cuda_device), DEFAULT_WIDTHS, fallbacks)
    assert (got.cpu() == exact_candidates_plain(_t(frags), _t(blens))).all()
    assert int(fallbacks) == 0


def test_cuda_best_candidates_layout(cuda_device):
    """A cluster of 8 CTAs a row of 65,536 positions (one of 4,096), 1,024
    threads and 225,296 shared bytes a CTA, and some clusters at once."""
    for F, ctas in ((65536, 8), (4096, 1), (20000, 3)):
        lay = candidates_layout(F, cuda_device)
        assert lay["ctas"] == ctas and lay["threads"] == 1024, lay
        assert lay["smem_bytes"] == 225296 and lay["clusters"] >= 1, lay


FACADE_TRACE = r"""
import json, pathlib, sys
root = pathlib.Path.cwd()
sys.path[:0] = [str(root), str(root / "tests")]
import torch
import snappier_tpu_torch as st
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.utils.profiling import device_trace
from torch_cases import html_like

data = b"".join(html_like(65536, seed).tobytes() for seed in range(5))[:300000]
st.compress(data, level="best")  # built and warm
_build.reset_launches()
with device_trace(sys.argv[1]):
    comp = st.compress(data, level="best")
(path,) = pathlib.Path(sys.argv[1]).glob("trace-*.json")
names = sorted({e["name"] for e in json.loads(path.read_text())["traceEvents"]
                if e.get("cat") == "kernel"})
print(json.dumps({"launches": dict(_build.LAUNCHES), "kernels": names,
                  "round_trip": st.decompress(comp) == data}))
"""


def test_cuda_facade_best_sorts_on_chip(cuda_device, tmp_path):
    """compress(level="best") on the card: one launch of the candidate
    search and one of the best encode walk, and no library sort or scatter
    in its trace (``device_trace``, in a process of its own: a second
    profiler session in one process has seen no kernel events)."""
    import json
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", FACADE_TRACE, str(tmp_path)], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    launches, names = got["launches"], got["kernels"]
    assert launches.get("best_candidates") == 1 and launches.get("encode_best") == 1, launches
    assert any("best_candidates_kernel" in n for n in names), names
    assert not any("RadixSort" in n or "scatter" in n.lower() for n in names), names
    assert got["round_trip"]


def _offset_rows(rows: np.ndarray, offset: int, dev) -> torch.Tensor:
    """The rows on ``dev``, ``offset`` bytes into a buffer that ends where
    the last row ends."""
    buf = torch.zeros(rows.size + offset, dtype=torch.uint8, device=dev)
    view = buf[offset:].view(rows.shape)
    view.copy_(_t(rows.astype(np.uint8)).to(dev))
    return view


def _decode_rows(tight: bool):
    """Corrupt blocks, the batch walk's edges and encoded rows of 64 KiB, at
    the codec's width (68,608 bytes) or, ``tight``, at the longest block's
    length; the longest block last, so that at the tight width it ends where
    the buffer ends."""
    frags, lens = encode_rows(65536, seed=6)
    p_bodies, p_lens = encode_blocks_plain(_t(frags.astype(np.uint8)), _t(lens), 15, 32)
    streams = corrupt_streams() + batch_streams(programs=8) + [
        block_stream(n, p_bodies[i, : p_lens[i]].numpy()) for i, n in enumerate(lens)]
    streams.sort(key=len)
    return pack_streams(streams, len(streams[-1]) if tight else 68608)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("out_cap", [65536, 65530])
@pytest.mark.parametrize("tight", [False, True], ids=["codec_width", "tight_width"])
def test_cuda_decode_matches_plain(cuda_device, tight, out_cap, offset):
    """K1 at the codec's width (cc 68,608) and at the longest block's, at
    out_cap 65,536 and at one that is not a multiple of 16, the rows 0 or 1
    bytes into a buffer that ends at the last row's end (the ring and the
    byte loader), against the plain version, corrupt rows included; the
    layout holds three blocks of two warps an SM at 65,536."""
    comp, clens = _decode_rows(tight)
    rows = _offset_rows(comp, offset, cuda_device)
    layout = sc.decode_layout(rows, out_cap)
    assert layout["loader"] == ("ring" if offset == 0 and comp.shape[1] % 4 == 0 else "bytes")
    assert layout["threads"] == 64
    if out_cap == 65536:
        assert layout["blocks_per_sm"] >= 3, layout
    _build.reset_launches()
    got = decode_blocks_bytes(rows, _t(clens).to(cuda_device), out_cap)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"decode": 1}
    ref = decode_blocks_plain(_t(comp.astype(np.uint8)), _t(clens), out_cap)
    assert (got[2].cpu() == ref[2]).all() and (got[1].cpu() == ref[1]).all()
    _rows_equal(got[0], ref[0], ref[1])
    assert (ref[2] != 0).sum() >= 10 and (ref[2] == 0).sum() >= 50


def test_cuda_decode_caps_in_any_order_and_from_two_threads(cuda_device):
    """K1's shared-memory attributes follow the out_cap of each launch in
    any order: three blocks an SM at 65,536 after a smaller cap, more at the
    smaller cap after 65,536; and two host threads decoding at 65,536 and at
    8,192 at once both succeed (the allowed dynamic size never shrinks)."""
    import concurrent.futures

    comp, clens = _decode_rows(tight=True)
    rows, lens = _t(comp).to(cuda_device), _t(clens).to(cuda_device)
    caps = (65536, 8192)
    want = {c: decode_blocks_plain(_t(comp.astype(np.uint8)), _t(clens), c) for c in caps}
    for cap in (8192, 65536, 8192, 65536):
        nb = sc.decode_layout(rows, cap)["blocks_per_sm"]
        assert nb >= 3 if cap == 65536 else nb > 3, (cap, nb)

    def decode_at(cap):
        with torch.cuda.device(cuda_device):
            for _ in range(20):
                got = decode_blocks_bytes(rows, lens, cap)
                torch.cuda.synchronize()
                assert (got[2].cpu() == want[cap][2]).all(), cap
                _rows_equal(got[0], want[cap][0], want[cap][1])

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(decode_at, c) for c in caps]:
            f.result()


def test_cuda_attributes_and_launches_under_one_lock(cuda_device):
    """Four host threads at once, 20 calls each: K1 at out_cap 65,536 and
    8,192 and K2 at 15 and 12 hash bits, every launch's bytes against the
    plain versions (each kernel's carveout is set and its launch enqueued
    under one lock, so no launch runs under another thread's carveout);
    then K1 still holds three blocks an SM at 65,536 and K2 three at 15
    bits."""
    import concurrent.futures

    comp, clens = _decode_rows(tight=True)
    rows, lens = _t(comp).to(cuda_device), _t(clens).to(cuda_device)
    frags, flens = encode_rows(65536, seed=12)
    f_c, fl_c = _t(frags.astype(np.uint8)).to(cuda_device), _t(flens).to(cuda_device)
    want_dec = {c: decode_blocks_plain(_t(comp.astype(np.uint8)), _t(clens), c)
                for c in (65536, 8192)}
    want_enc = {hb: encode_blocks_plain(_t(frags.astype(np.uint8)), _t(flens), hb, 32)
                for hb in (15, 12)}

    def decode_at(cap):
        with torch.cuda.device(cuda_device):
            for _ in range(20):
                got = decode_blocks_bytes(rows, lens, cap)
                torch.cuda.current_stream().synchronize()
                assert (got[2].cpu() == want_dec[cap][2]).all(), cap
                assert (got[1].cpu() == want_dec[cap][1]).all(), cap
                _rows_equal(got[0], want_dec[cap][0], want_dec[cap][1])

    def encode_at(hb):
        with torch.cuda.device(cuda_device):
            for _ in range(20):
                got_b, got_l = encode_blocks_bytes(f_c, fl_c, hash_bits=hb)
                torch.cuda.current_stream().synchronize()
                assert (got_l.cpu() == want_enc[hb][1]).all(), hb
                _rows_equal(got_b, want_enc[hb][0], want_enc[hb][1])

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(decode_at, c) for c in (65536, 8192)]
        jobs += [pool.submit(encode_at, hb) for hb in (15, 12)]
        for f in jobs:
            f.result()
    assert sc.decode_layout(rows, 65536)["blocks_per_sm"] >= 3
    assert sc.encode_layout(f_c, 15)["blocks_per_sm"] >= 3


@pytest.mark.parametrize("F,offset,B", [(65536, 0, 1), (65536, 0, 3), (65536, 1, 19),
                                        (65536, 0, 512), (65536, 3, 2048), (65535, 0, 19),
                                        (4097, 0, 19), (1024, 5, 40), (100_000, 0, 19),
                                        (512, 0, 9240)])
def test_cuda_crc32c_matches_plain(cuda_device, F, offset, B):
    """K3 against its plain version: the edge lengths of its split
    (``torch_cases.CRC_LENGTHS``) and rows of markup and zeros, garbage past
    each length, repeated to B rows (more than the persistent blocks at
    2,048, more than 64 rows a block at 9,240); rows of 64 KiB, of odd widths (each row starts at another
    offset from a 16-byte boundary) and of a width past 64 KiB, 0, 1, 3 or
    5 bytes into a buffer that ends at the last row's end."""
    rows, lens = crc_rows(F)
    reps = -(-B // len(lens))
    rows, lens = np.tile(rows, (reps, 1))[:B], np.tile(lens, reps)[:B]
    rng = np.random.default_rng(B)
    rows[len(CRC_LENGTHS) + 2 :] ^= rng.integers(0, 256, rows[len(CRC_LENGTHS) + 2 :].shape,
                                                 dtype=np.uint8)
    view = _offset_rows(rows, offset, cuda_device)
    _build.reset_launches()
    got = crc32c_blocks(view, _t(lens).to(cuda_device))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"crc32c": 1}
    assert (got.cpu() == crc32c_blocks_plain(_t(rows), _t(lens))).all()


def test_cuda_crc32c_of_decoded_rows_and_in_a_graph(cuda_device):
    """K3 on K1's output rows (int32, garbage past each length) against the
    plain version on the same rows; then 8 launches captured in a CUDA
    graph, replayed twice, each output equal to the plain version; and its
    layout (one persistent block an SM of 256 threads, 204,032 shared bytes:
    69 KiB of tables and row lengths, 2 KiB of sums, 128 KiB of rings)."""
    comp, clens = _decode_rows(tight=False)
    out, out_lens, _ = decode_blocks_bytes(_t(comp).to(cuda_device), _t(clens).to(cuda_device),
                                           65536)
    want = crc32c_blocks_plain(out.cpu(), out_lens.cpu())
    assert (crc32c_blocks(out, out_lens).cpu() == want).all()

    rows, lens = crc_rows(65536, seed=21)
    r_c, l_c = _t(rows).to(cuda_device), _t(lens).to(cuda_device)
    want = crc32c_blocks_plain(_t(rows), _t(lens))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        crc32c_blocks(r_c, l_c)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [crc32c_blocks(r_c, l_c) for _ in range(8)]
    for _ in range(2):
        for o in outs:
            o.fill_(0)
        g.replay()
        torch.cuda.synchronize()
        for o in outs:
            assert (o.cpu() == want).all()
    layout = crc32c_layout(cuda_device)
    assert layout["smem_bytes"] == 204032 and layout["threads"] == 256, layout
    assert layout["blocks_per_sm"] >= 1
    assert layout["persistent_blocks"] == torch.cuda.get_device_properties(
        cuda_device).multi_processor_count


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_cuda_best_kernel_unaligned_matches_plain(cuda_device, offset):
    """K4 on rows of 65,536 bytes 0, 1 or 3 bytes into a buffer that ends at
    the last row's end, against the plain version; it runs one thread a
    block and no dynamic shared memory."""
    F = 65536
    frags, lens = best_rows(F, seed=offset, lens=(F, F - 5, 30000, 17, 0))
    rows = _offset_rows(frags, offset, cuda_device)
    l_c = _t(lens).to(cuda_device)
    cands = exact_candidates(rows, l_c)
    want_b, want_l = encode_best_plain(_t(frags.astype(np.uint8)), _t(lens), cands.cpu(), 32)
    layout = sc.best_layout(rows)
    assert layout["loader"] == ("bytes" if offset else "words") and layout["smem_bytes"] == 0
    assert layout["threads"] == 1 and layout["blocks_per_sm"] >= 4, layout
    _build.reset_launches()
    got_b, got_l = _encode_best(rows, l_c, cands)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"encode_best": 1}
    assert (got_l.cpu() == want_l).all()
    _rows_equal(got_b, want_b, want_l)


def test_cuda_decode_and_best_on_each_card_match_plain(cuda_device):
    """K1 and K4 on cuda:0 and then on each other card in one process, each
    loader: their shared-memory attributes hold only on the device they were
    set on, so each card sets its own."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    comp, clens = _decode_rows(tight=True)
    want = decode_blocks_plain(_t(comp.astype(np.uint8)), _t(clens), 65536)
    F = 65536
    frags, lens = best_rows(F, seed=4, lens=(F, 20000, 17))
    cands = exact_candidates(_t(frags), _t(lens))
    want_b, want_l = encode_best_plain(_t(frags.astype(np.uint8)), _t(lens), cands, 32)
    for offset in (0, 1):
        for d in range(torch.cuda.device_count()):
            dev = torch.device("cuda", d)
            assert sc.decode_layout(_offset_rows(comp, offset, dev))["blocks_per_sm"] >= 3
            got = decode_blocks_bytes(_offset_rows(comp, offset, dev), _t(clens).to(dev), 65536)
            assert got[0].device == dev
            assert (got[2].cpu() == want[2]).all() and (got[1].cpu() == want[1]).all(), d
            _rows_equal(got[0], want[0], want[1])
            got_b, got_l = _encode_best(_offset_rows(frags, offset, dev), _t(lens).to(dev),
                                        cands.to(dev))
            assert (got_l.cpu() == want_l).all(), (d, offset)
            _rows_equal(got_b, want_b, want_l)


def test_cuda_probe_matches_plain(cuda_device):
    golden = [(e, *_layout(s1, s2, ln)) for e, s1, s2, ln in VECTORS if e >= 4]
    g_bufs = np.zeros((len(golden), 65536), np.uint8)
    for i, (_, buf, _, _) in enumerate(golden):
        g_bufs[i, : len(buf)] = np.frombuffer(buf, np.uint8)
    bufs, ats, cands, ns, planted = planted_matches(64, 65536)
    bufs = np.concatenate([g_bufs, bufs])
    ats = np.concatenate([[g[2] for g in golden], ats]).astype(np.int32)
    cands = np.concatenate([np.zeros(len(golden)), cands]).astype(np.int32)
    ns = np.concatenate([[g[3] for g in golden], ns]).astype(np.int32)
    args = [_t(x) for x in (bufs, ats, cands, ns)]
    _build.reset_launches()
    got = match_extension_probe(*(a.to(cuda_device) for a in args))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"probe": 1}
    want = match_extension_probe(*args)
    assert (got.cpu() == want).all()
    assert got.cpu().tolist() == [g[0] for g in golden] + planted.tolist()
    clamped = [torch.tensor([4, -5, 8]), torch.tensor([0, 0, 99]), torch.tensor([1 << 30, 16, 12])]
    narrow = torch.zeros((3, 16), dtype=torch.uint8)
    assert match_extension_probe(narrow.to(cuda_device),
                                 *(c.to(cuda_device) for c in clamped)).tolist() == [12, 16, 4]
    got = sc.launch_probe(*(a.to(cuda_device) for a in args))  # the kernel alone
    assert got.cpu().tolist() == want.tolist()


def test_cuda_probe_call_is_one_device_operation(cuda_device):
    """On uint8 rows and int32 arguments a probe call is one kernel launch
    and no other device operation (the clamps are the kernel's): the aten
    operations it dispatches are the output's allocation alone. The kernel
    alone (launch_probe) on arguments outside the clamps, rows 1-3 bytes
    into a buffer (unaligned words) and widths that are no multiple of 4
    gives the plain version's lengths on the clamped arguments."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(3)
    for width in (65536, 1003, 1018, 16):
        B = 64
        buf = torch.from_numpy(rng.integers(0, 4, B * width + 3, dtype=np.uint8))
        at = rng.integers(-50, width + 50, B).astype(np.int32)
        cand = rng.integers(-50, width + 50, B).astype(np.int32)
        n = rng.integers(-10, width + 100, B).astype(np.int32)
        for off in (0, 1, 3):
            rows = buf[off : off + B * width].view(B, width)
            args = [_t(x) for x in (at, cand, n)]
            want = match_extension_probe(rows, *args)
            dev = [rows.to(cuda_device)[0:B]] + [a.to(cuda_device) for a in args]
            torch.cuda.synchronize()
            _build.reset_launches()
            with Ops() as ops:
                got = match_extension_probe(*dev)
            torch.cuda.synchronize()
            assert dict(_build.LAUNCHES) == {"probe": 1}
            assert ops.seen == ["aten.empty.memory_format"], ops.seen
            assert got.cpu().tolist() == want.tolist(), (width, off)
            dev_off = buf.to(cuda_device)[off : off + B * width].view(B, width)
            assert sc.launch_probe(dev_off, *dev[1:]).cpu().tolist() == want.tolist()


def test_cuda_facade_matches_cpu(cuda_device):
    rng = np.random.default_rng(5)
    datas = [b"", b"abc", html_like(20000, 1).tobytes(),
             html_like(150_000, 2).tobytes() + rng.integers(0, 256, 9000, np.uint8).tobytes()]
    for data in datas:
        for level in ("fast", "best"):
            _build.reset_launches()
            comp = st.compress(data, level=level)
            assert _build.LAUNCHES["encode_best" if level == "best" else "encode"] == 1
            assert comp == st.compress(data, level=level, device="cpu")
            _build.reset_launches()
            assert st.decompress(comp) == data
            assert _build.LAUNCHES["decode"] == 1
    data = datas[-1]
    comp = st.compress(data)
    out = bytearray(len(data))
    assert st.decompress_into(comp, out) == len(data) and bytes(out) == data
    with st.compress_to_memory(data) as m:
        assert bytes(m) == comp
    with pytest.raises(st.InvalidDataError):
        st.decompress(comp[:-4])


def test_cuda_device_alive_compiles_afresh(cuda_device):
    x = torch.arange(1024, dtype=torch.int32).reshape(watch.SHAPE)
    _build.reset_launches()
    y = watch.device_alive(4242)
    assert y.device.type == "cuda" and dict(_build.LAUNCHES) == {"watch": 1}
    assert (y.cpu() == watch.add_salt_plain(x, 4242)).all()
    assert watch.device_alive()[0, 0].item() >= 0  # a salt of its own, from the clock
    assert (watch.device_alive(5, device="cpu") == watch.add_salt_plain(x, 5)).all()
    assert not list(_build.BUILD_DIR.glob("libwatch-*"))  # salted libraries are removed
    with watch.salted_launcher(7) as fn:  # the salt is compiled in, not passed
        assert watch.add_salt(x.to(cuda_device), 7, fn)[0, :2].tolist() == [7, 8]
        assert watch.add_salt(x.to(cuda_device), 9, fn)[0, 0].item() == 7
    with pytest.raises(ValueError):
        watch.add_salt(x.to(cuda_device).long(), 1)


@pytest.mark.parametrize("n", [1, 1023, 1024, 4099, 4194311, 8388608])
@pytest.mark.parametrize("where", ["aligned", "misaligned_y", "misaligned_x"])
def test_cuda_watch_sizes_match_plain(cuda_device, n, where):
    """T21's 16-byte path (n a multiple of 4, both pointers aligned), its
    word path (any other n or a pointer 4 bytes off), and the grid-stride
    loop past 1,024 blocks of 256 threads."""
    x_buf = torch.arange(n + 1, dtype=torch.int32, device=cuda_device) * 3 - 7
    y_buf = torch.full((n + 1,), -1, dtype=torch.int32, device=cuda_device)
    x = x_buf[1:] if where == "misaligned_x" else x_buf[:n]
    y = y_buf[1:] if where == "misaligned_y" else y_buf[:n]
    with watch.salted_launcher(11) as fn:
        _build.reset_launches()
        _build.launch_bound(fn, "watch", cuda_device, x.data_ptr(), y.data_ptr(), n)
        got = watch.add_salt(x, 11, fn)
        torch.cuda.synchronize()
    want = watch.add_salt_plain(x.cpu(), 11)
    assert (y.cpu() == want).all() and (got.cpu() == want).all()
    assert dict(_build.LAUNCHES) == {"watch": 2}
    if where == "misaligned_y":
        assert y_buf[0].item() == -1  # nothing stored before y
    else:
        assert y_buf[n].item() == -1  # nothing stored past y


@pytest.mark.parametrize("hash_bits", [8, 12, 15, 16])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_cuda_encode_unaligned_rows_match_plain(cuda_device, offset, hash_bits):
    """K2 on a frags view 1-3 bytes into a larger buffer, at widths 65,535
    and 65,536, the last row full and ending at the buffer's end (the byte
    loader), then on the aligned rows (the word loader)."""
    for F in (65535, 65536):
        frags, lens = encode_rows(F, seed=offset)
        frags = np.concatenate([frags, np.tile(np.arange(5), F)[None, :F]]).astype(np.uint8)
        lens = np.concatenate([lens, [F]]).astype(np.int32)
        buf = torch.zeros(frags.size + offset, dtype=torch.uint8, device=cuda_device)
        view = buf[offset:].view(frags.shape)
        view.copy_(_t(frags).to(cuda_device))
        assert sc.encode_layout(view, hash_bits)["loader"] == "bytes"
        want_b, want_l = encode_blocks_plain(_t(frags), _t(lens), hash_bits, 32)
        for rows in (view, _t(frags).to(cuda_device)):
            got_b, got_l = encode_blocks_bytes(rows, _t(lens).to(cuda_device),
                                               hash_bits=hash_bits)
            assert (got_l.cpu() == want_l).all()
            _rows_equal(got_b, want_b, want_l)
    layout = sc.encode_layout(_t(frags).to(cuda_device), hash_bits)
    assert layout["loader"] == "words" and layout["smem_bytes"] == 2 << hash_bits
    assert layout["blocks_per_sm"] >= (3 if hash_bits <= 15 else 1)


def test_cuda_encode_on_each_card_matches_plain(cuda_device):
    """K2 on cuda:0 and then on cuda:1 in one process, each loader: the
    kernel's shared-memory attributes hold only on the device they were
    set on, so each card sets its own. Then the sharded compress over every
    card (``make_mesh()``'s default)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    F = 65536
    frags, lens = encode_rows(F, seed=4)
    frags = frags.astype(np.uint8)
    want_b, want_l = encode_blocks_plain(_t(frags), _t(lens), 15, 32)
    for offset in (0, 1):
        for d in range(torch.cuda.device_count()):
            dev = torch.device("cuda", d)
            buf = torch.zeros(frags.size + offset, dtype=torch.uint8, device=dev)
            rows = buf[offset:].view(frags.shape)
            rows.copy_(_t(frags).to(dev))
            layout = sc.encode_layout(rows)
            assert layout["loader"] == ("bytes" if offset else "words")
            assert layout["blocks_per_sm"] >= 3
            got_b, got_l = encode_blocks_bytes(rows, _t(lens).to(dev))
            assert got_b.device == dev
            assert (got_l.cpu() == want_l).all(), (d, offset)
            _rows_equal(got_b, want_b, want_l)
    from snappier_tpu_torch import parallel

    mesh = parallel.make_mesh()
    n = len(mesh.devices)
    B = -(-len(lens) // n) * n
    f_all = np.zeros((B, F), np.uint8)
    f_all[: len(lens)] = frags
    l_all = np.zeros(B, np.int32)
    l_all[: len(lens)] = lens
    bodies, body_lens, _ = parallel.sharded_compress(_t(f_all), _t(l_all), mesh)
    want_b, want_l = encode_blocks_plain(_t(f_all), _t(l_all), 15, 32)
    got_b = bodies.gather()
    w = min(got_b.shape[1], want_b.shape[1])
    assert (body_lens.cpu() == want_l).all()
    _rows_equal(got_b[:, :w], want_b[:, :w], want_l)


def test_cuda_stream_matches_cpu(cuda_device, monkeypatch):
    monkeypatch.setattr(S, "_SUB_BATCH", 4)
    rng = np.random.default_rng(8)
    data = (html_like(500_000, 3).tobytes() + rng.integers(0, 256, 70_000, np.uint8).tobytes()
            + b"x" * 100_000)  # 11 chunks: sub-batches of 4, 4 and 3
    _build.reset_launches()
    framed = st.stream_compress(data)
    assert dict(_build.LAUNCHES) == {"encode": 3, "crc32c": 3}
    assert framed == st.stream_compress(data, device="cpu")
    _build.reset_launches()
    assert st.stream_decompress(framed) == data
    assert _build.LAUNCHES["decode"] == _build.LAUNCHES["crc32c"] == 3
    assert st.stream_decompress(framed, engine="oracle") == data
    assert st.stream_decompress(st.stream_compress(data, engine="oracle")) == data
    stage = S._Stage(3, 65536, cuda_device)
    assert stage.buf.is_pinned() and stage.buf[:64].is_pinned()
    stage.buf.fill_(0xAB)  # the next short chunks are staged over a dirty buffer
    stage.release()
    short = [data[:300], data[500_000:500_300], b"q" * 5000]
    assert S._compress_chunks_batched(short) == S._compress_chunks_batched(short, device="cpu")

    for cut in (14, len(framed) // 2, len(framed) - 1):
        bad = framed[:cut] + bytes([framed[cut] ^ 0xFF]) + framed[cut + 1 :]
        with pytest.raises(st.InvalidDataError):
            st.stream_decompress(bad)
    with pytest.raises(st.InvalidDataError):
        st.stream_decompress(framed[:-3])
    assert st.stream_decompress(framed) == data  # the pipeline is sound after the errors


def test_cuda_stream_adapters(cuda_device):
    data = html_like(200_000, 5).tobytes() + bytes(range(256)) * 40
    sink = io.BytesIO()
    with st.SnappyWriter(sink, leave_open=True) as w:
        for i in range(0, len(data), 30_000):
            w.write(data[i : i + 30_000])
    assert sink.getvalue() == st.stream_compress(data, device="cpu")
    for transfer in (7, 8192):
        _build.reset_launches()
        with st.SnappyReader(io.BytesIO(sink.getvalue()), transfer_size=transfer) as r:
            assert r.read() == data
        # A chunk a batch, but for chunks that end within one transfer.
        assert _build.LAUNCHES["decode"] == _build.LAUNCHES["crc32c"]
        assert _build.LAUNCHES["decode"] == 4 if transfer == 7 else 2 <= _build.LAUNCHES["decode"] <= 4

    async def twins():
        out = io.BytesIO()
        async with st.AsyncSnappyWriter(out, leave_open=True) as w:
            await asyncio.gather(*(w.write(data[i : i + 50_000])
                                   for i in range(0, len(data), 50_000)))
        async with st.AsyncSnappyReader(io.BytesIO(out.getvalue())) as r:
            return out.getvalue(), await r.read()

    framed, back = asyncio.run(twins())
    assert framed == sink.getvalue() and back == data


@pytest.mark.parametrize("variant", sorted(dv.VARIANTS))
@pytest.mark.parametrize("cc,out_cap,big", [(2048, 1024, 0), (2051, 1022, 0), (68608, 65536, 65536)])
def test_cuda_decode_variants_match_plain(cuda_device, variant, cc, out_cap, big):
    """Each ablation form against the plain walk, on valid blocks (short
    offsets, overlapping copies, long literals, a 4-byte offset, batch-edge
    blocks) and corrupt ones (blocks holding a literal of no bytes among
    them), with garbage past each length; word rows through the ring, and the
    same rows 1 byte into a buffer through the byte loader; the unchecked
    form on the valid blocks only, the walk-only form on lengths and error
    words only."""
    valid = walk_streams(big) + [s for s in batch_streams(programs=4) if len(s) <= cc]
    more = corrupt_streams() + [s for s in empty_literal_streams(tags=60 if cc < 4096 else 200)
                                if len(s) <= cc]
    streams = valid + ([] if variant == "v1nock" else more)
    comp, lens = pack_streams(streams, cc)
    c_h, l_h = _t(comp.astype(np.uint8)), _t(lens)
    c_d, l_d = c_h.to(cuda_device), l_h.to(cuda_device)
    buf = torch.zeros(c_d.numel() + 1, dtype=torch.uint8, device=cuda_device)
    buf[1:].copy_(c_d.reshape(-1))
    wrapper = {"v2": dv.decode_v2, "v4": dv.decode_v4, "v3": dv.decode_v3}.get(variant)
    want = dv.decode_variant_plain(c_h, l_h, out_cap, variant)
    assert int((want[2][: len(walk_streams(big))] != 0).sum()) == 0
    for rows in (c_d, buf[1:].view(c_d.shape)):
        _build.reset_launches()
        if wrapper:
            got = wrapper(rows, l_d, out_cap)
        else:
            got = dv.decode_variant(rows, l_d, out_cap, variant)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {dv.VARIANTS[variant][1]: 1}
        assert (got[2].cpu() == want[2]).all(), (got[2].tolist(), want[2].tolist())
        assert (got[1].cpu() == want[1]).all()
        if variant != "v1nocp":
            _rows_equal(got[0], want[0], want[1])
    if variant != "v1nocp":
        k1 = decode_blocks_bytes(c_d, l_d, out_cap)
        _rows_equal(got[0], k1[0], want[1])
        assert ((k1[2] == 0) == (got[2] == 0)).all()


def test_cuda_decode_variants_reject_what_does_not_fit(cuda_device):
    """Only an out_cap whose image and slack pass a block's shared memory is
    refused; a row of any width decodes (the row is not staged)."""
    comp = torch.zeros((1, 200000), dtype=torch.uint8, device=cuda_device)
    comp[0, :7] = torch.tensor(list(bytes([5, 4 << 2]) + b"hello"), dtype=torch.uint8)
    lens = torch.tensor([7], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        dv.decode_v2(comp, lens, 240000)
    for name in sorted(dv.VARIANTS):
        got = (dv.decode_variant(comp, lens, 65536, name) if name.startswith("v1")
               else getattr(dv, f"decode_{name}")(comp, lens, 65536))
        want = dv.decode_variant_plain(comp.cpu(), lens.cpu(), 65536, name)
        assert got[1].tolist() == want[1].tolist() == [5] and got[2].tolist() == [0], name
        if name != "v1nocp":
            assert bytes(got[0][0, :5].tolist()) == b"hello", name


def test_cuda_decode_variant_nock_on_corrupt_rows(cuda_device):
    """``v1nock`` keeps the checks that keep its accesses inside the image and
    the row: on corrupt blocks (claims past out_cap, overrunning literals and
    copies, offsets of 0 and past the output, literals of no bytes) beside
    valid ones, in one launch, it finishes without a fault, and the valid
    rows are the checked form's."""
    valid = walk_streams(65536)
    bad = corrupt_streams() + empty_literal_streams()
    streams = [s for pair in zip(valid, bad) for s in pair] + valid[len(bad):] + bad[len(valid):]
    comp, lens = pack_streams(streams, 68608)
    c_d, l_d = _t(comp.astype(np.uint8)).to(cuda_device), _t(lens).to(cuda_device)
    got = dv.decode_variant(c_d, l_d, 65536, "v1nock")
    torch.cuda.synchronize()
    checked = dv.decode_variant(c_d, l_d, 65536, "v1")
    ok = (checked[2] == 0).cpu()
    assert int(ok.sum()) >= len(valid)
    assert (got[2].cpu()[ok] == 0).all() and (got[1].cpu()[ok] == checked[1].cpu()[ok]).all()
    _rows_equal(got[0][ok.to(cuda_device)], checked[0][ok.to(cuda_device)], checked[1].cpu()[ok])
    # A stopped walk gives 4, a bad preamble 8; out_len is 0 on any error.
    assert set(got[2].tolist()) <= {0, 4, 8} and not got[1][got[2] != 0].any()


def test_cuda_decode_variant_layout(cuda_device):
    """The ablation kernel holds K1's layout: three blocks of two warps an SM
    at out_cap 65,536 in every form whatever the row's width, its shared
    bytes those ``_smem_bytes`` counts (the slack of each form included);
    word rows through the ring, others the byte loader; every instantiation
    (8: four forms of the walk, each loader) without a stack frame or
    spills."""
    import chip_smoke

    for cc in (68608, 17408, 200000):
        rows = torch.zeros((2, cc), dtype=torch.uint8, device=cuda_device)
        for name, (number, _) in dv.VARIANTS.items():
            lay = dv.decode_variant_layout(rows, 65536, name)
            assert lay == {"blocks_per_sm": 3, "smem_bytes": dv._smem_bytes(number, 65536),
                           "threads": 64, "loader": "ring"}, (name, lay)
    odd = torch.zeros(2 * 68611 + 1, dtype=torch.uint8, device=cuda_device)[1:].view(2, 68611)
    lay = dv.decode_variant_layout(odd, 65536, "v1")
    assert lay["loader"] == "bytes" and lay["blocks_per_sm"] == 3, lay
    figs = chip_smoke.ptxas_figures(_build.BUILD_LOG["decode_variants"], "decode_variant_kernel")
    assert len(figs) == 8, figs
    for fig in figs:
        assert all(fig.get(k) == 0 for k in ("stack", "spill_stores", "spill_loads")), fig


def test_cuda_scan_codec_matches_cpu(cuda_device):
    """The scan engine is tensor code: the card and the CPU give the same
    bodies, lengths, CRCs, decoded rows and error words, and launch none of
    the CUDA kernels."""
    F = 4096
    frags, lens = encode_rows(F)
    frags = np.where(np.arange(F)[None, :] < lens[:, None], frags, 0).astype(np.int32)
    on_card = SnappyCodec(fragment_size=F, kernel="scan")
    on_cpu = SnappyCodec(fragment_size=F, kernel="scan", device="cpu")
    _build.reset_launches()
    a, b = on_card.compress_batch(frags, lens), on_cpu.compress_batch(frags, lens)
    for x, y in zip(a, b):
        assert (x.cpu() == y).all()
    streams = corrupt_streams() + [block_stream(n, b[0][i, : b[1][i]].numpy())
                                   for i, n in enumerate(lens)]
    comp, clens = pack_streams(streams, F + 3072, garbage_seed=None)
    da, db = on_card.decompress_batch(comp, clens), on_cpu.decompress_batch(comp, clens)
    for x, y in zip(da, db):
        assert (x.cpu() == y).all()
    fa, fb = on_card.frame_batch(frags, lens), on_cpu.frame_batch(frags, lens)
    for x, y in zip(fa, fb):
        assert (x.cpu() == y).all()
    assert bool(on_card.roundtrip_step(frags, lens)[3])
    assert not _build.LAUNCHES, dict(_build.LAUNCHES)
    # Cross-engine: the scalar kernels decode the scan bodies and the reverse.
    scalar = SnappyCodec(fragment_size=F, kernel="scalar")
    ok = slice(len(corrupt_streams()), None)
    ds = scalar.decompress_batch(comp[ok], clens[ok])
    assert (ds[2] == 0).all() and (ds[1].cpu() == db[1][ok]).all()
    _rows_equal(ds[0], db[0][ok], db[1][ok])
    sb, sl, _ = scalar.compress_batch(frags, lens)
    comp2, clens2 = pack_streams([block_stream(n, sb[i, : sl[i]].cpu().numpy())
                                  for i, n in enumerate(lens)], F + 3072, garbage_seed=None)
    d2 = on_card.decompress_batch(comp2, clens2)
    assert (d2[2] == 0).all() and (d2[0].cpu() == db[0][ok]).all()  # both zero past the length


def _pipe_call(name, kw):
    """A pipelined form of PIPE_CASES as (comp, lens, out_cap) -> triple."""
    if name == "pipe":
        return dv.decode_pipe
    return lambda c, n, o: dv.decode_pipe2(c, n, o, **kw)


@pytest.mark.parametrize("case", PIPE_CASES, ids=[c[0] for c in PIPE_CASES])
@pytest.mark.parametrize("cc,out_cap,big", [(2048, 1024, 0), (2051, 1022, 0), (68608, 65536, 65536)])
def test_cuda_decode_pipe_matches_plain(cuda_device, case, cc, out_cap, big):
    """The pipelined kernels against their plain version on valid and corrupt
    blocks, blocks with literals of no bytes and batch-edge blocks, with
    garbage past each length, at capacities that are and are not a multiple
    of 16 (the bulk drain needs one that is); word rows through the ring, and
    the same rows 1 byte into a buffer through the byte loader. decode_pipe
    gives the decode kernel's triple on every row, decode_pipe2 its rows on
    the valid blocks."""
    name, kw = case
    valid = walk_streams(big)
    more = empty_literal_streams(tags=60 if cc < 4096 else 200) + batch_streams(programs=4)
    streams = valid + corrupt_streams() + [s for s in more if len(s) <= cc]
    comp, lens = pack_streams(streams, cc)
    c_h, l_h = _t(comp.astype(np.uint8)), _t(lens)
    c_d, l_d = c_h.to(cuda_device), l_h.to(cuda_device)
    buf = torch.zeros(c_d.numel() + 1, dtype=torch.uint8, device=cuda_device)
    buf[1:].copy_(c_d.reshape(-1))
    fn = _pipe_call(name, kw)
    want = dv.decode_pipe_plain(c_h, l_h, out_cap, name != "pipe", kw.get("emit", True))
    assert not want[2][: len(valid)].any()
    for rows in (c_d, buf[1:].view(c_d.shape)):
        _build.reset_launches()
        got = fn(rows, l_d, out_cap)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {"decode_pipe" if name == "pipe" else "decode_pipe2": 1}
        assert (got[2].cpu() == want[2]).all(), (got[2].tolist(), want[2].tolist())
        assert (got[1].cpu() == want[1]).all()
        if kw.get("emit", True):
            _rows_equal(got[0], want[0], want[1])
    k1 = decode_blocks_bytes(c_d, l_d, out_cap)
    if name == "pipe":
        assert (got[2].cpu() == k1[2].cpu()).all() and (got[1].cpu() == k1[1].cpu()).all()
    if kw.get("emit", True):
        _rows_equal(got[0][: len(valid)], k1[0][: len(valid)], want[1][: len(valid)])


def test_cuda_decode_pipe_layout(cuda_device):
    """The pipelined kernel holds K1's layout: three blocks of two warps an SM
    at out_cap 65,536 in every form whatever the row's width, its shared
    bytes those ``_pipe_smem_bytes`` counts (the slack of ``unc`` included);
    word rows through the ring, others the byte loader; every instantiation
    (26: decode_pipe and twelve decode_pipe2 forms, each loader) without a
    stack frame or spills."""
    import chip_smoke

    forms = [dict(fold=False)] + [dict(kw) for name, kw in PIPE_CASES if name != "pipe"]
    for cc in (68608, 17408, 200000):
        rows = torch.zeros((2, cc), dtype=torch.uint8, device=cuda_device)
        for kw in forms:
            lay = dv.decode_pipe_layout(rows, 65536, **kw)
            want = dv._pipe_smem_bytes(65536, kw.get("unc", 0))
            assert lay == {"blocks_per_sm": 3, "smem_bytes": want, "threads": 64,
                           "loader": "ring"}, (kw, lay)
    odd = torch.zeros(2 * 4096 + 1, dtype=torch.uint8, device=cuda_device)[1:].view(2, 4096)
    assert dv.decode_pipe_layout(odd, 65536, unroll=3, unc=2)["loader"] == "bytes"
    figs = chip_smoke.ptxas_figures(_build.BUILD_LOG["decode_pipe"], "decode_pipe_kernel")
    assert len(figs) == 26, figs
    for fig in figs:
        assert all(fig.get(k) == 0 for k in ("stack", "spill_stores", "spill_loads")), fig


def _encode_cases():
    cases = [("variant", name, flags) for name, flags in ev.VARIANT_FLAGS.items()]
    cases += [("variant", "none", ()), ("variant", "probe8-st1-hb9", ("probe8", "st1", "hb9"))]
    return cases + [("r4", name, name) for name in ev.R4_VARIANTS]


@pytest.mark.parametrize("case", _encode_cases(), ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("F", [1024, 65536])
def test_cuda_encode_variants_match_plain(cuda_device, case, F):
    """Every named walk of the encode ablation, and two tuples no name has
    (they run the kernel whose mask is a run-time value), against the plain
    version; every emitting variant is decoded back by the decode kernel."""
    family, name, arg = case
    frags, lens = encode_rows(F)
    if F == 65536:
        frags, lens = frags[[0, 1, 2, 5, 12]], lens[[0, 1, 2, 5, 12]]
    f_h, l_h = _t(frags.astype(np.uint8)), _t(lens)
    fn, plain, counter = ((ev.encode_variant, ev.encode_variant_plain, "encode_variant")
                          if family == "variant" else
                          (ev.encode_r4, ev.encode_r4_plain, "encode_r4"))
    _build.reset_launches()
    bodies, body_lens = fn(f_h.to(cuda_device), l_h.to(cuda_device), arg)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {counter: 1}
    p_bodies, p_lens = plain(f_h, l_h, arg)
    assert (body_lens.cpu() == p_lens).all(), (body_lens.tolist(), p_lens.tolist())
    if (family == "variant" and "noemit" in arg) or name in ev.R4_NO_BYTES:
        return
    _rows_equal(bodies, p_bodies, p_lens)
    streams = [block_stream(n, p_bodies[i, : p_lens[i]].numpy()) for i, n in enumerate(lens)]
    comp, clens = pack_streams(streams, F + 4096)
    out, out_lens, errs = decode_blocks_bytes(_t(comp).to(cuda_device), _t(clens).to(cuda_device), F)
    assert not errs.any() and (out_lens.cpu() == l_h).all()
    _rows_equal(out, f_h, l_h)
    if name in ev.R4_PRODUCTION_BYTES:
        k2_b, k2_l = encode_blocks_bytes(f_h.to(cuda_device), l_h.to(cuda_device))
        assert (k2_l == body_lens).all()
        _rows_equal(bodies, k2_b[:, : F + 2048], p_lens)


@pytest.mark.parametrize("case", _encode_cases(), ids=lambda c: f"{c[0]}-{c[1]}")
def test_cuda_encode_variants_unaligned_rows_match_plain(cuda_device, case):
    """Every walk of the encode ablation on rows 1 byte into a larger buffer
    at width 4,097, the last row ending at the buffer's end (the byte
    loader), against the plain version."""
    family, name, arg = case
    frags, lens = encode_rows(4097)
    frags = frags.astype(np.uint8)
    buf = torch.zeros(frags.size + 1, dtype=torch.uint8, device=cuda_device)
    view = buf[1:].view(frags.shape)
    view.copy_(_t(frags).to(cuda_device))
    fn, plain, layout = ((ev.encode_variant, ev.encode_variant_plain, ev.encode_variant_layout)
                         if family == "variant" else
                         (ev.encode_r4, ev.encode_r4_plain, ev.encode_r4_layout))
    assert layout(view, arg)["loader"] == "bytes"
    bodies, body_lens = fn(view, _t(lens).to(cuda_device), arg)
    p_bodies, p_lens = plain(_t(frags), _t(lens), arg)
    assert (body_lens.cpu() == p_lens).all(), (body_lens.tolist(), p_lens.tolist())
    if not ((family == "variant" and "noemit" in arg) or name in ev.R4_NO_BYTES):
        _rows_equal(bodies, p_bodies, p_lens)


def test_cuda_encode_variant_layouts(cuda_device):
    """The encode ablation runs in K2's layout: the match table alone in
    shared memory, one warp a fragment; T8 at 15 hash bits at least three
    blocks an SM, T5 at 14 at least four (six expected), 1 KiB at hb9; the
    word loader on aligned rows, the byte loader on an unaligned view."""
    rows = torch.zeros((4, 65536), dtype=torch.uint8, device=cuda_device)
    odd = torch.zeros(4 * 4097 + 1, dtype=torch.uint8, device=cuda_device)[1:].view(4, 4097)
    r4 = ev.encode_r4_layout(rows, "encpre")
    assert r4 == {"blocks_per_sm": r4["blocks_per_sm"], "smem_bytes": 2 << 15, "threads": 32,
                  "loader": "words"} and r4["blocks_per_sm"] >= 3
    e3 = ev.encode_variant_layout(rows, ev.VARIANT_FLAGS["e3"])
    assert e3["smem_bytes"] == 2 << 14 and e3["loader"] == "words" and e3["blocks_per_sm"] >= 4
    assert ev.encode_variant_layout(rows, ("probe8", "st1", "hb9"))["smem_bytes"] == 2 << 9
    assert ev.encode_r4_layout(odd, "encext8u")["loader"] == "bytes"
    assert ev.encode_variant_layout(odd, ())["loader"] == "bytes"


def test_cuda_encode_variants_under_one_lock(cuda_device):
    """Four host threads at once, 20 calls each: the run-time walk at 9 and
    14 hash bits, ``encode_r4`` at 15 and ``e3`` at 14, every launch's bytes
    against the plain versions (each kernel's carveout is set and its launch
    enqueued under one lock); then T8 still holds three blocks an SM at 15
    bits and T5 four at 14."""
    import concurrent.futures

    frags, lens = encode_rows(8192, seed=12)
    f_h, l_h = _t(frags.astype(np.uint8)), _t(lens)
    f_c, l_c = f_h.to(cuda_device), l_h.to(cuda_device)
    calls = [(ev.encode_variant, ev.encode_variant_plain, ("probe8", "st1", "hb9")),
             (ev.encode_variant, ev.encode_variant_plain, ("probe8", "st1")),
             (ev.encode_r4, ev.encode_r4_plain, "encpre"),
             (ev.encode_variant, ev.encode_variant_plain, ev.VARIANT_FLAGS["e3"])]
    want = [plain(f_h, l_h, arg) for _, plain, arg in calls]

    def run(i):
        fn, _, arg = calls[i]
        with torch.cuda.device(cuda_device):
            for _ in range(20):
                got_b, got_l = fn(f_c, l_c, arg)
                torch.cuda.current_stream().synchronize()
                assert (got_l.cpu() == want[i][1]).all(), arg
                _rows_equal(got_b, want[i][0], want[i][1])

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for f in [pool.submit(run, i) for i in range(len(calls))]:
            f.result()
    assert ev.encode_r4_layout(f_c, "encpre")["blocks_per_sm"] >= 3
    assert ev.encode_variant_layout(f_c, ("probe8", "st1"))["blocks_per_sm"] >= 4


@pytest.mark.parametrize("kernel", ["scalar", "scan"])
def test_cuda_sharded_roundtrip_step_on_two_shards(cuda_device, kernel):
    """One card listed twice: two shards, a stream each, the bodies and
    lengths of the unsharded codec."""
    from snappier_tpu_torch.parallel import make_mesh, sharded_roundtrip_step

    F = 4096
    frags, lens = encode_rows(F)
    frags = np.where(np.arange(F)[None, :] < lens[:, None], frags, 0).astype(np.int32)
    mesh = make_mesh([cuda_device, cuda_device])
    _build.reset_launches()
    bodies, body_lens, offsets, ok = sharded_roundtrip_step(frags, lens, mesh=mesh, kernel=kernel)
    torch.cuda.synchronize()
    assert bool(ok)
    want = {"encode": 2, "decode": 2} if kernel == "scalar" else {}
    assert dict(_build.LAUNCHES) == want
    codec = SnappyCodec(fragment_size=F, kernel=kernel, with_crc=False)
    b1, l1, _ = codec.compress_batch(frags, lens)
    assert (body_lens == l1).all()
    assert (offsets.cpu() == torch.cumsum(l1.cpu().long(), 0) - l1.cpu()).all()
    _rows_equal(bodies.gather(), b1.to(torch.uint8), l1)
    assert [r for r, _ in bodies.addressable_shards] == [range(0, 8), range(8, 16)]


@pytest.mark.parametrize("form", ["v5", "v6", "v7", "v7u"])
@pytest.mark.parametrize("cc,out_cap,big", [(2048, 1024, 0), (2051, 1022, 0), (68608, 65536, 65536)])
def test_cuda_decode_hybrid_matches_plain(cuda_device, form, cc, out_cap, big):
    """The descriptor-driven kernels against their plain version on valid and
    corrupt blocks with garbage past each length, the pre-pass on the card
    equal to the one on the CPU, the verdicts equal to the production
    kernel's and the rows equal to its rows."""
    base = form[:2]
    valid = walk_streams(big)
    streams = valid + corrupt_streams()
    comp, lens = pack_streams(streams, cc)
    c_h, l_h = _t(comp.astype(np.uint8)), _t(lens)
    c_d, l_d = c_h.to(cuda_device), l_h.to(cuda_device)
    for a, b in zip(dh._prepass(c_d, base), dh._prepass(c_h, base)):
        if b is not None:
            assert (a.cpu() == b).all()
    _build.reset_launches()
    fn = {"v5": dh.decode_v5, "v6": dh.decode_v6, "v7": dh.decode_v7}[base]
    got = fn(c_d, l_d, out_cap, unroll2=True) if form == "v7u" else fn(c_d, l_d, out_cap)
    torch.cuda.synchronize()
    # Every form makes its descriptors with its pre-pass kernel.
    assert dict(_build.LAUNCHES) == {dh.FORMS[base][1]: 1, f"prepass_{base}": 1}
    want = dh.decode_hybrid_plain(c_h, l_h, out_cap, base)
    assert (got[2].cpu() == want[2]).all(), (got[2].tolist(), want[2].tolist())
    assert (got[1].cpu() == want[1]).all()
    assert not want[2][: len(valid)].any()
    _rows_equal(got[0], want[0], want[1])
    k1 = decode_blocks_bytes(c_d, l_d, out_cap)
    _rows_equal(got[0], k1[0], want[1])
    assert ((k1[2] == 0) == (got[2] == 0)).all()


def test_cuda_decode_v5_spec_matches_decode_v5(cuda_device):
    streams = walk_streams(65536) + corrupt_streams()
    comp, lens = pack_streams(streams, 68608)
    c_d, l_d = _t(comp.astype(np.uint8)).to(cuda_device), _t(lens).to(cuda_device)
    want = dh.decode_v5(c_d, l_d, 65536)
    _build.reset_launches()
    got = dh.decode_v5_spec(dh.pack_words(c_d), dh.spec_from_comp(c_d), l_d, 65536)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"decode_v5_parts": 1}
    assert (got[2] == want[2]).all() and (got[1] == want[1]).all()
    _rows_equal(got[0], want[0], want[1])


def test_cuda_decode_hybrid_rejects_what_does_not_fit(cuda_device):
    """Every form holds the output image alone in shared memory: each takes a
    row of 200,000 bytes (its verdict the plain version's) and refuses an
    image that does not fit."""
    comp = torch.zeros((1, 200000), dtype=torch.uint8, device=cuda_device)
    lens = torch.tensor([5], device=cuda_device)
    for form in ("v5", "v6", "v7"):
        fn = getattr(dh, f"decode_{form}")
        got = fn(comp, lens, 65536)
        want = dh.decode_hybrid_plain(comp.cpu(), lens.cpu(), 65536, form)
        assert got[2].tolist() == want[2].tolist() == [4] and got[1].tolist() == [0]
        with pytest.raises(ValueError, match="shared memory"):
            fn(comp[:, :64], lens, 232000)


def _v7_rows():
    """decode_v7's main-path rows: 9 blocks of 65,536 bytes of the word mix
    and a shorter one, the batch edges and corrupt streams."""
    import chip_smoke

    mix = chip_smoke.word_mix() * 12
    blocks = [oracle.compress(np.frombuffer(mix[i * 65536: (i + 1) * 65536], np.uint8))
              for i in range(9)]
    blocks.append(oracle.compress(np.frombuffer(mix[:40000], np.uint8)))
    return blocks + batch_streams() + corrupt_streams()


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("tight", [False, True], ids=["codec_width", "tight_width"])
@pytest.mark.parametrize("unroll2", [False, True], ids=["v7", "v7u"])
def test_cuda_decode_v7_matches_plain(cuda_device, unroll2, tight, offset):
    """decode_v7, with and without unroll2, at the codec's row width (68,608
    B) and the tight one (the longest block rounded up to 1 KiB), on word
    rows and on rows 1 byte into a buffer (the byte loader), against its
    plain version: error words, lengths and bytes; the plaintext too."""
    streams = _v7_rows()
    cc = -(-(max(map(len, streams)) + 8) // 1024) * 1024 if tight else 68608
    comp, lens = pack_streams(streams, cc)
    c_h, l_h = _t(comp.astype(np.uint8)), _t(lens)
    c_d = _offset_rows(comp.astype(np.uint8), offset, cuda_device)
    _build.reset_launches()
    got = dh.decode_v7(c_d, l_h.to(cuda_device), 65536, unroll2=unroll2)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"decode_v7": 1, "prepass_v7": 1}
    want = dh.decode_hybrid_plain(c_h, l_h, 65536, "v7")
    assert (got[2].cpu() == want[2]).all(), (got[2].tolist(), want[2].tolist())
    assert (got[1].cpu() == want[1]).all() and set(want[2].tolist()) == {0, 4, 8}
    _rows_equal(got[0], want[0], want[1])
    for i in range(10):
        assert got[0][i, : int(got[1][i])].cpu().numpy().tobytes() == oracle.decompress(streams[i])


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("cc", [68608, 68605, 4])
def test_cuda_prepass_v7_matches_cpu(cuda_device, cc, offset):
    """The pre-pass kernel against its plain version (the CPU's tensor code,
    bit-equal to the TPU's _spec2_from_words): word rows (16-byte stores),
    rows 3 bytes narrower and rows 1 and 3 bytes into a buffer (the byte
    loader); random bytes and streams with garbage tails."""
    rng = np.random.default_rng(cc + offset)
    comp, _ = pack_streams(_v7_rows()[:12], 68608)
    rows = np.concatenate([comp, rng.integers(0, 256, (3, 68608))])[:, :cc].astype(np.uint8)
    _build.reset_launches()
    got = dh.prepass_v7(_offset_rows(rows, offset, cuda_device))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"prepass_v7": 1}
    want = dh.spec2_from_words(dh.pack_words(_t(rows)), cc)
    assert (got[0].cpu() == want[0]).all() and (got[1].cpu() == want[1]).all()


def test_cuda_decode_v7_layout(cuda_device):
    """decode_v7 holds the output image alone: three blocks an SM at out_cap
    65,536 whatever the row's width (K1's layout), its shared bytes those
    ``decode_hybrid.block_smem_bytes`` counts; word rows read as words."""
    for cc in (68608, 17408, 200000):
        rows = torch.zeros((2, cc), dtype=torch.uint8, device=cuda_device)
        lay = dh.decode_hybrid_layout(rows, 65536, "v7")
        assert lay == {"blocks_per_sm": 3, "smem_bytes": dh.block_smem_bytes("v7", 65536),
                       "threads": 64, "loader": "words"}, lay
    odd = torch.zeros(2 * 4096 + 1, dtype=torch.uint8, device=cuda_device)[1:].view(2, 4096)
    assert dh.decode_hybrid_layout(odd, 65536, "v7")["loader"] == "bytes"


@pytest.mark.parametrize("form", ["v5", "v6"])
def test_cuda_decode_v5_v6_layout(cuda_device, form):
    """decode_v5 and decode_v6 hold the output image alone, beside one
    descriptor ring: three blocks of two warps an SM at out_cap 65,536
    whatever the row's width, their shared bytes those
    ``decode_hybrid.block_smem_bytes`` counts; word rows read as words."""
    for cc in (68608, 17408, 200000):
        rows = torch.zeros((2, cc), dtype=torch.uint8, device=cuda_device)
        lay = dh.decode_hybrid_layout(rows, 65536, form)
        assert lay == {"blocks_per_sm": 3, "smem_bytes": dh.block_smem_bytes(form, 65536),
                       "threads": 64, "loader": "words"}, lay
    odd = torch.zeros(2 * 4096 + 1, dtype=torch.uint8, device=cuda_device)[1:].view(2, 4096)
    assert dh.decode_hybrid_layout(odd, 65536, form)["loader"] == "bytes"


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("tight", [False, True], ids=["codec_width", "tight_width"])
@pytest.mark.parametrize("form", ["v5", "v6"])
def test_cuda_decode_v5_v6_matches_plain(cuda_device, form, tight, offset):
    """decode_v5 and decode_v6 at the codec's row width (68,608 B) and the
    tight one, on word rows and on rows 1 byte into a buffer (the byte
    loaders), against their plain version on decode_v7's main-path rows
    (9 blocks of 65,536 bytes of the word mix), the batch edges, the
    corrupt streams and the step-back streams (v5 steps its output back
    inside a batch): error words, lengths and bytes; the plaintext too. Then
    decode_v5_spec on the same rows."""
    streams = _v7_rows() + step_back_streams()
    cc = -(-(max(map(len, streams)) + 8) // 1024) * 1024 if tight else 68608
    comp, lens = pack_streams(streams, cc)
    c_h, l_h = _t(comp.astype(np.uint8)), _t(lens)
    c_d, l_d = _offset_rows(comp.astype(np.uint8), offset, cuda_device), l_h.to(cuda_device)
    _build.reset_launches()
    got = getattr(dh, f"decode_{form}")(c_d, l_d, 65536)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {f"decode_{form}": 1, f"prepass_{form}": 1}
    want = dh.decode_hybrid_plain(c_h, l_h, 65536, form)
    assert (got[2].cpu() == want[2]).all(), (got[2].tolist(), want[2].tolist())
    assert (got[1].cpu() == want[1]).all() and set(want[2].tolist()) >= {0, 4, 8}
    _rows_equal(got[0], want[0], want[1])
    for i in range(10):
        assert got[0][i, : int(got[1][i])].cpu().numpy().tobytes() == oracle.decompress(streams[i])
    assert want[2][-3:].tolist() == ([0, 0, 0] if form == "v5" else [4, 4, 4])
    if form == "v5":
        spec = dh.prepass_v5(c_d)
        got = dh.decode_v5_spec(dh.pack_words(c_d), spec, l_d, 65536)
        assert (got[2].cpu() == want[2]).all() and (got[1].cpu() == want[1]).all()
        _rows_equal(got[0], want[0], want[1])


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("cc", [68608, 68605, 4])
@pytest.mark.parametrize("form", ["v5", "v6"])
def test_cuda_prepass_v5_v6_matches_cpu(cuda_device, form, cc, offset):
    """prepass_v5 (the rows read a byte at a time) and prepass_v6 (word rows
    read as words) against their plain versions, the CPU's tensor code
    (bit-equal to the TPU's _spec_from_comp and _spec_from_words): word rows
    (16-byte stores), rows 3 bytes narrower and rows 1 and 3 bytes into a
    buffer (the byte loader, a store a position where the width is no
    multiple of 4); random bytes and streams with garbage tails."""
    rng = np.random.default_rng(cc + offset)
    comp, _ = pack_streams(_v7_rows()[:12], 68608)
    rows = np.concatenate([comp, rng.integers(0, 256, (3, 68608))])[:, :cc].astype(np.uint8)
    _build.reset_launches()
    got = getattr(dh, f"prepass_{form}")(_offset_rows(rows, offset, cuda_device))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {f"prepass_{form}": 1}
    want = (dh.spec_from_comp(_t(rows)) if form == "v5"
            else dh.spec_from_words(dh.pack_words(_t(rows)), cc))
    assert got.dtype == torch.int32 and (got.cpu() == want).all()


def test_cuda_ablation_launches_under_one_lock(cuda_device):
    """Four host threads at once, 20 calls each: T1 (decode_v2) and T7
    (decode_pipe2) at two shared sizes each (rows of 2,048 and 68,608
    bytes) and T10 (chain) at two (an advance row of 20,480 and of 40,960
    words), every launch's result against the plain versions: each
    kernel's attributes are set and its launch enqueued under one lock, so
    no launch runs under a size another thread set."""
    import concurrent.futures

    rows = {}
    for cc in (2048, 68608):
        comp, lens = pack_streams(walk_streams(65536 if cc > 2048 else 0) + corrupt_streams(), cc)
        rows[cc] = (_t(comp.astype(np.uint8)), _t(lens))
    out_cap = {2048: 1024, 68608: 65536}
    want_v2 = {cc: dv.decode_variant_plain(c, n, out_cap[cc], "v2") for cc, (c, n) in rows.items()}
    want_p2 = {cc: dv.decode_pipe_plain(c, n, out_cap[cc], True, True)
               for cc, (c, n) in rows.items()}
    chains = {w: np.ones(w, np.int32) for w in (20480, 40960)}
    want_chain = {w: hp.chain_plain(_t(a), w - 480, 3, 5) for w, a in chains.items()}

    def decode(fn, want, cc):
        c, n = (x.to(cuda_device) for x in rows[cc])
        with torch.cuda.device(cuda_device):
            for _ in range(20):
                got = fn(c, n, out_cap[cc])
                torch.cuda.current_stream().synchronize()
                assert (got[2].cpu() == want[cc][2]).all() and (got[1].cpu() == want[cc][1]).all()
                _rows_equal(got[0], want[cc][0], want[cc][1])

    def chain(w):
        adv = _t(chains[w]).to(cuda_device)
        with torch.cuda.device(cuda_device):
            for _ in range(20):
                got = hp.chain(adv, w - 480, 3, 5)
                torch.cuda.current_stream().synchronize()
                assert all((a.cpu() == b).all() for a, b in zip(got, want_chain[w]))

    pipe2 = lambda c, n, o: dv.decode_pipe2(c, n, o, unroll=2)  # noqa: E731
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(decode, dv.decode_v2, want_v2, cc) for cc in rows]
        jobs += [pool.submit(decode, pipe2, want_p2, cc) for cc in rows]
        jobs += [pool.submit(chain, w) for w in chains]
        for f in jobs:
            f.result()


@pytest.mark.parametrize("F", [4096, 65536])
def test_cuda_encode_stats_matches_plain(cuda_device, F):
    """The encoder's budget (T9) against its plain walk, exact, on the
    encoder rows with garbage past each length."""
    frags, lens = encode_rows(F)
    rows = slice(None) if F == 4096 else [0, 1, 2, 5, 12]
    f_h, l_h = _t(frags[rows].astype(np.uint8)), _t(lens[rows])
    _build.reset_launches()
    got = ev.encode_stats(f_h.to(cuda_device), l_h.to(cuda_device))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"encode_stats": 1}
    assert (got.cpu() == ev.encode_stats_plain(f_h, l_h)).all()


def test_cuda_encode_stats_layout(cuda_device):
    """T9 runs in K2's layout: one warp a fragment, only the 15-bit match
    table in shared memory, three blocks an SM (512 fragments in two waves
    on 132 SMs); the word loader on aligned 64 KiB rows, the byte loader on
    an unaligned view of an odd width, whose counts equal the plain walk's."""
    rows = torch.zeros((4, 65536), dtype=torch.uint8, device=cuda_device)
    assert ev.encode_stats_layout(rows) == {"blocks_per_sm": 3, "smem_bytes": 65536,
                                            "threads": 32, "loader": "words"}
    frags, lens = encode_rows(4096)
    f_h, l_h = _t(frags[:, :4095].astype(np.uint8)), _t(np.minimum(lens, 4095))
    buf = torch.zeros(f_h.numel() + 1, dtype=torch.uint8, device=cuda_device)
    odd = buf[1:].view(f_h.shape)
    odd.copy_(f_h)
    assert ev.encode_stats_layout(odd)["loader"] == "bytes"
    got = ev.encode_stats(odd, l_h.to(cuda_device))
    assert (got.cpu() == ev.encode_stats_plain(f_h, l_h)).all()


@pytest.mark.parametrize("with_rec", [False, True], ids=["chain", "chainrec"])
def test_cuda_chain_matches_plain(cuda_device, with_rec):
    """T10 (cliff's walk over the staged advances) on both probe blocks and
    on a walk of 20,000 steps, at R = 1, 5 and 200, and on cliff's edge
    walks: checksum and record buffer."""
    cases = [hp.chain_inputs(b)[:2] for b in probe_blocks().values()]
    cases.append((np.ones(20480, np.int32), 20000))
    walks = [(adv, n, 3, R) for adv, n in cases for R in (1, 5, 200)] + _cliff_cases()[-4:]
    for adv, n, start, R in walks:
        _build.reset_launches()
        got = hp.chain(_t(adv).to(cuda_device), n, start, R, with_rec)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {"chain": 1}
        want = hp.chain_plain(_t(adv), n, start, R, with_rec)
        assert (got[0].cpu() == want[0]).all() and (got[1].cpu() == want[1]).all()


@pytest.mark.parametrize("mode", ["2d", "3d"])
def test_cuda_vcopy_matches_plain(cuda_device, mode):
    """T11 over both probe blocks' records, the edge records and the edge
    records at loop counts around a batch of 32: checksum and final image."""
    img = np.arange(hp.IMAGE_WORDS, dtype=np.int32) * 40503
    recs = [hp.vcopy_records(hp.tags_from_block(b)[1]) for b in probe_blocks().values()]
    edges = [count_records(vcopy_edges(mode), n) for n in BATCH_EDGE_COUNTS]
    for rec in recs + [vcopy_edges(mode)] + edges:
        _build.reset_launches()
        got = hp.vcopy(_t(rec).to(cuda_device), _t(img).to(cuda_device), mode)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {"vcopy": 1}
        want = hp.vcopy_plain(_t(rec), _t(img), mode)
        assert (got[0].cpu() == want[0]).all() and (got[1].cpu() == want[1]).all()


@pytest.mark.parametrize("nvec", hp.COISSUE_NVEC)
def test_cuda_coissue_matches_plain(cuda_device, nvec):
    """T12 from interpret mode's fill and from a random tile, at the TPU's
    8,192 iterations and at 5 (where the tile updates still show)."""
    rand = _t(np.random.default_rng(nvec).integers(-(1 << 31), 1 << 31, hp.TILE, dtype=np.int64)
              .astype(np.int32))
    for seed, tile, iters in ((3, None, 8192), (-5, rand, 8192), (7, rand, 5), (9, rand, 37)):
        got = hp.coissue(seed, nvec, None if tile is None else tile.to(cuda_device), iters,
                         device=cuda_device)
        want = hp.coissue_plain(seed, nvec, tile, iters)
        assert (got[0].cpu() == want[0]).all() and (got[1].cpu() == want[1]).all()


def test_cuda_coissue_vec_matches_plain(cuda_device):
    """The vector stream alone (the coissue launcher at nvec -1) from the
    fill and a random tile at 5, 37 and 8,192 iterations: coissue_plain's
    tile at nvec 8 and its count of odd words; one launch a call, counted as
    coissue_vec."""
    rand = _t(np.random.default_rng(16).integers(-(1 << 31), 1 << 31, hp.TILE, dtype=np.int64)
              .astype(np.int32))
    for tile, iters in ((None, 8192), (rand, 8192), (rand, 5), (rand, 37)):
        _build.reset_launches()
        got = hp.coissue_vec(None if tile is None else tile.to(cuda_device), iters,
                             device=cuda_device)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {"coissue_vec": 1}
        want = hp.coissue_vec_plain(tile, iters)
        assert (want[1] == hp.coissue_plain(3, 8, tile, iters)[1]).all()
        assert (got[0].cpu() == want[0]).all() and (got[1].cpu() == want[1]).all()


@pytest.mark.parametrize("mode", hp.ISO_MODES)
def test_cuda_iso_matches_plain(cuda_device, mode):
    """T13 over both probe blocks' records and vcopy's 2d edge records, at
    their count and at counts around a batch of 32 (a count of 1 leaves the
    odd passes empty): checksum and the image after the 20 passes."""
    img = np.arange(hp.IMAGE_WORDS, dtype=np.int32) * 40503
    edges = [count_records(vcopy_edges("2d"), n) for n in (200, *BATCH_EDGE_COUNTS)]
    recs = [hp.iso_records(hp.tags_from_block(b)[1]) for b in probe_blocks().values()]
    for rec in recs + edges:
        _build.reset_launches()
        got = hp.iso(_t(rec).to(cuda_device), _t(img).to(cuda_device), mode)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {"iso": 1}
        want = hp.iso_plain(_t(rec), _t(img), mode)
        assert (got[0].cpu() == want[0]).all() and (got[1].cpu() == want[1]).all()


@pytest.mark.parametrize("nwhen", hp.BPROBE_NWHEN)
def test_cuda_bprobe_matches_plain(cuda_device, nwhen):
    """T17 at each built nwhen, seed 3 and -5: checksum and scratch; any
    other nwhen is refused on the card."""
    for seed in (3, -5):
        got = hp.bprobe(nwhen, seed, device=cuda_device)
        want = hp.bprobe_plain(nwhen, seed)
        assert (got[0].cpu() == want[0]).all() and (got[1].cpu() == want[1]).all()
    with pytest.raises(ValueError, match="built for nwhen"):
        hp.bprobe(5, device=cuda_device)


def test_cuda_bprobe_floor_matches_plain(cuda_device):
    """The floor yardstick (bprobe's mix alone) at seeds 3 and -5 and the
    fill word: one launch a call, counted as bprobe_floor."""
    for seed in (3, -5, hp.FILL):
        _build.reset_launches()
        got = hp.bprobe_floor(seed, device=cuda_device)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {"bprobe_floor": 1}
        assert got.cpu().tolist() == hp.bprobe_floor_plain(seed).tolist()


def _cliff_cases():
    """(adv, n, start, R): both probe blocks at R = 1, 5 and 200 from 3; a
    walk that ends exactly at n; one whose last advance jumps past the
    advance array's end; starts at and past n."""
    cases = []
    for b in probe_blocks().values():
        adv, n, _ = hp.chain_inputs(b)
        cases += [(adv, n, 3, R) for R in (1, 5, 200)]
    ones = np.ones(64, np.int32)
    jump = ones.copy()
    jump[60] = 40
    return cases + [(ones, 64, 3, 3), (jump, 64, 3, 5), (jump, 64, 64, 2), (jump, 62, 61, 3)]


@pytest.mark.parametrize("mode", hp.CLIFF_MODES)
def test_cuda_cliff_matches_plain(cuda_device, mode):
    """T19 on both probe blocks at R = 1, 5 and 200 and on the walk's edges:
    checksum and image."""
    for adv, n, start, R in _cliff_cases():
        _build.reset_launches()
        got = hp.cliff(_t(adv).to(cuda_device), n, mode, start, R)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {"cliff": 1}
        want = hp.cliff_plain(_t(adv), n, mode, start, R)
        assert (got[0].cpu() == want[0]).all() and (got[1].cpu() == want[1]).all()


def test_cuda_chase_matches_plain(cuda_device):
    """The chase (cliff's walk with no body) against chain's plain version,
    and against chain on the card, on cliff's cases."""
    for adv, n, start, R in _cliff_cases():
        _build.reset_launches()
        got = hp.chase(_t(adv).to(cuda_device), n, start, R)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {"chase": 1}
        want = hp.chain_plain(_t(adv), n, start, R)[0]
        assert got.cpu().tolist() == want.tolist()
        chain = hp.chain(_t(adv).to(cuda_device), n, start, R)[0]
        assert got.cpu().tolist() == chain.cpu().tolist()


def test_cuda_bitonic_matches_plain(cuda_device):
    """T20 on the tool's keys, on keys with many ties and on sorted and
    reversed keys: keys and indices; one wrapper call counts one launch."""
    rng = np.random.default_rng(5)
    cases = [rng.integers(-(2**31), 2**31 - 1, hp.SORT_N, np.int64).astype(np.int32),
             rng.integers(-4, 4, hp.SORT_N).astype(np.int32),
             np.arange(hp.SORT_N, dtype=np.int32), np.arange(hp.SORT_N, 0, -1, dtype=np.int32)]
    for x in cases:
        _build.reset_launches()
        keys, vals = hp.bitonic(_t(x).to(cuda_device))
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {"bitonic": 1}
        want = hp.bitonic_plain(_t(x))
        assert (keys.cpu() == want[0]).all() and (vals.cpu() == want[1]).all()


def test_cuda_bitonic_on_an_unaligned_view(cuda_device):
    """T20 reads its keys by TMA from a 16-byte aligned address: keys that
    start 4 bytes into their buffer are copied first and give the plain
    version's keys and indices."""
    x = np.random.default_rng(11).integers(-1000, 1000, hp.SORT_N + 1).astype(np.int32)
    view = _t(x).to(cuda_device)[1:]
    assert view.data_ptr() % 16 == 4
    keys, vals = hp.bitonic(view)
    want = hp.bitonic_plain(_t(x[1:].copy()))
    assert (keys.cpu() == want[0]).all() and (vals.cpu() == want[1]).all()


@pytest.fixture(scope="module")
def torch_fuzz():
    """``tools/torch_fuzz.py``, loaded by its path (it imports no JAX)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "torch_fuzz.py"
    spec = importlib.util.spec_from_file_location("torch_fuzz", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["roundtrip", "corrupt", "scalar", "facade", "device-stream"])
def test_cuda_fuzz_campaign_at_default_volume(cuda_device, torch_fuzz, name):
    """Each device campaign of the fuzz tool at its default volume on the
    card: every row exact, each kernel it drives launched (the campaign
    raises otherwise), the corrupt campaign's batches on both loaders."""
    r = torch_fuzz.RUNNERS[name](torch_fuzz.DEFAULTS[name], 301, cuda_device)
    assert r["rows"] >= torch_fuzz.DEFAULTS[name]
    if name == "corrupt":
        assert r["mutants"] >= 16384 and r["oracle_judged"] >= r["judged"] // 16
        assert r["loaders"] == {"ring": r["batches"], "bytes": r["batches"]}
    if name == "device-stream":
        assert r["crc_caught"] > 0 and r["launches"]["crc32c"] > 0


def test_cuda_codec_at_batch_2048(cuda_device, torch_fuzz):
    """``SnappyCodec(with_crc=True)`` on 2,048 x 64 KiB (128 MiB, the batch a
    100 MB stream picks): every body decodes through the native engine to
    its row, every CRC equals the host's, and ``decompress_batch`` of the
    native engine's streams is exact (tools/repro_bigbatch.py's check)."""
    r = torch_fuzz.bigbatch(2048, 301, cuda_device)
    assert r["rows"] == 2048 and r["launches"]["encode"] and r["launches"]["decode"]


@pytest.fixture(scope="module")
def ratio_table():
    """``tools/torch_ratio_table.py``, loaded by its path (it imports no JAX)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "torch_ratio_table.py"
    spec = importlib.util.spec_from_file_location("torch_ratio_table", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cuda_ratio_table_matches_its_cpu_columns(cuda_device, ratio_table):
    """The ratio table's device columns on the card at 8 KiB stand-ins: the
    same streams as its CPU columns (which the CPU tests hold to the JAX
    package), each decoded by the oracle; K2 and K4 launched once each."""
    files = ratio_table.corpus(8192)
    host = ratio_table.device_streams(files, "cpu")
    _build.reset_launches()
    dev = ratio_table.device_streams(files, cuda_device)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["encode"] == 1 and _build.LAUNCHES["encode_best"] == 1
    for name, data in files.items():
        assert dev[name] == host[name], name
        assert all(oracle.decompress(s) == data for s in dev[name].values()), name
        assert len(dev[name]["best"]) <= len(dev[name]["scalar"]), name


def test_cuda_device_trace_names_the_encode_and_decode_kernels(cuda_device, tmp_path):
    """``device_trace`` on the card around a codec round trip: its Chrome
    trace holds kernel events named after K2 and K1 (launched through ctypes,
    not as torch operators), and ``Throughput`` times the round trip to the
    end of its kernels."""
    import json

    from snappier_tpu_torch.utils.profiling import Throughput, device_trace

    frags = np.stack([html_like(65536, seed) for seed in range(8)]).astype(np.uint8)
    f_c = _t(frags).to(cuda_device)
    l_c = torch.full((8,), 65536, dtype=torch.int32, device=cuda_device)
    codec = SnappyCodec(with_crc=False)
    codec.compress_batch(f_c, l_c)
    with device_trace(tmp_path) as prof, Throughput(2 * frags.size) as t:
        bodies, body_lens, _ = codec.compress_batch(f_c, l_c)
        pre = torch.tensor([0x80, 0x80, 0x04], dtype=torch.uint8, device=cuda_device)
        rows = torch.cat([pre.expand(8, 3), bodies.to(torch.uint8)], dim=1)
        rows = torch.nn.functional.pad(rows, (0, (-rows.shape[1]) % 1024))
        outs, out_lens, errs = codec.decompress_batch(rows, body_lens + 3, out_cap=65536)
    assert t.seconds > 0 and t.gbps > 0 and len(prof.key_averages()) > 0
    assert bool((errs == 0).all()) and bool((outs == f_c.to(torch.int32)).all())
    (path,) = tmp_path.glob("trace-*.json")
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "kernel"]
    assert any("encode_kernel" in n for n in names), names
    assert any("decode_kernel" in n for n in names), names


def test_cuda_device_spans_free_their_events_as_the_card_passes(cuda_device, monkeypatch):
    """Device spans queued ahead of the card all come back with their stream
    time; once the card has passed them their events are reused, so calls
    made one at a time take at most two calls' events in all."""
    from snappier_tpu_torch.utils import profiling

    class Counted(torch.cuda.Event):
        made = 0

        def __new__(cls, *args, **kwargs):
            Counted.made += 1
            return super().__new__(cls, *args, **kwargs)

    monkeypatch.setattr(torch.cuda, "Event", Counted)
    monkeypatch.setattr(profiling, "_ENABLED", True)
    monkeypatch.setattr(profiling, "_event_pool", collections.defaultdict(list))
    profiling.spans_reset()
    frags = torch.from_numpy(np.stack([html_like(4096, seed) for seed in range(64)])).to(
        cuda_device)
    lengths = torch.full((64,), 4096, dtype=torch.int32, device=cuda_device)
    codec = SnappyCodec(fragment_size=4096, with_crc=False)
    for _ in range(40):  # queued: no wait between the calls
        codec.compress_batch_packed(frags, lengths)
    torch.cuda.synchronize(cuda_device)
    recs = [r for r in profiling.spans_snapshot() if r["stream_ms"] is not None]
    assert len(recs) == 80 and all(r["stream_ms"] > 0 for r in recs)
    assert not profiling._pending
    profiling.spans_reset()
    profiling._event_pool.clear()
    before = Counted.made
    for _ in range(40):  # one at a time: a call's events are free by the next but one
        codec.compress_batch_packed(frags, lengths)
        torch.cuda.synchronize(cuda_device)
    assert Counted.made - before <= 8 and len(profiling._pending) <= 2
    recs = profiling.spans_snapshot()
    assert len(recs) == 3 * 40 and profiling.spans_dropped() == 0
    assert all(r["stream_ms"] > 0 for r in recs if r["name"] != "codec.compress")
    profiling.spans_reset()


def test_cuda_device_spans_carry_stream_time(cuda_device, monkeypatch):
    """With spans on, the candidate search's and the codec's encode, pack
    and decode spans carry the stream's time between their edges, above 0;
    the facade's no more than its root's host time (the root ends with the
    bodies on the host). Every other span is a host span."""
    from snappier_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.spans_reset()
    data = b"".join(html_like(65536, seed).tobytes() for seed in range(3))
    assert st.decompress(st.compress(data, level="best")) == data
    frags = np.stack([html_like(65536, seed) for seed in range(4)]).astype(np.uint8)
    codec = SnappyCodec(with_crc=False)
    packed, body_lens, _ = codec.compress_batch_packed(
        _t(frags).to(cuda_device), torch.full((4,), 65536, dtype=torch.int32, device=cuda_device))
    pre = torch.tensor([0x80, 0x80, 0x04], dtype=torch.uint8, device=cuda_device).expand(4, 3)
    outs, _, errs = codec.decompress_batch(torch.cat([pre, packed.view(torch.uint8)], dim=1),
                                           body_lens + 3)
    torch.cuda.synchronize(cuda_device)
    assert bool((errs == 0).all()) and bool((outs.cpu() == _t(frags).to(torch.int32)).all())
    recs = profiling.spans_snapshot()
    assert profiling.spans_dropped() == 0
    by_id = {r["id"]: r for r in recs}
    dev = [r for r in recs if r["stream_ms"] is not None]
    assert sorted(r["name"] for r in dev) == [
        "best.candidates", "codec.decode", "codec.encode", "codec.pack"]
    for r in dev:
        assert r["stream_ms"] > 0, r
        root = by_id[r["call"]]
        assert root["name"] in ("block.compress[cuda]", "codec.compress", "codec.decompress"), root
        if root["name"] == "block.compress[cuda]":
            assert r["stream_ms"] <= (root["t1_ns"] - root["t0_ns"]) * 1e-6, (r, root)
    profiling.spans_reset()
