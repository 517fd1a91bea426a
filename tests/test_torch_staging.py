"""The block facade's host staging (``runtime/block.py``: ``_stage_rows``,
``_device_bodies``): the object crosses to the device through a pooled
host buffer whose last row's tail is zeroed, and the bodies come back
through a second one.

Each case runs on the CPU (``device="cpu"``: pageable buffers, the
kernels' plain versions) and, marked ``cuda``, on the card (page-locked
buffers, the CUDA kernels). The reference is the port's own batch entry
point, ``compress_fragments``, on explicitly zero-padded rows; tolerance
is exact equality. Imports no JAX, so the card runs the file with
``--noconftest``.
"""

from __future__ import annotations

import concurrent.futures
import sys

import numpy as np
import pytest
import torch

import snappier_tpu_torch as st
from snappier_tpu_torch.constants import BLOCK_SIZE
from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.format.varint import write_varint
from snappier_tpu_torch.runtime import block
from snappier_tpu_torch.utils.pool import StagingPool
from torch_cases import html_like

LENGTHS = [0, 1, 65535, 65536, 65537, 3 * 65536 + 12345]


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def dev(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


@pytest.fixture
def pool(monkeypatch):
    """A fresh staging pool for the facade, so that rents are counted from
    zero and buffers are reused only within the test."""
    fresh = StagingPool()
    monkeypatch.setattr(block, "staging_pool", fresh)
    return fresh


def _kind(dev) -> str:
    return "pinned" if dev.type == "cuda" else "pageable"


def _object(n: int, seed: int = 0) -> bytes:
    """Markup with a random stretch in its second quarter, ``n`` bytes."""
    rng = np.random.default_rng(seed)
    data = html_like(n, seed).copy()
    data[n // 4 : n // 2] = rng.integers(0, 256, n // 2 - n // 4, dtype=np.uint8)
    return data.tobytes()


def _padded_stream(data: bytes, level: str, dev) -> bytes:
    """The stream from explicitly zero-padded 64 KiB rows through the batch
    entry point: the varint length, then each row's body."""
    n = len(data)
    nfrags = max(1, -(-n // BLOCK_SIZE))
    frags = np.zeros((nfrags, BLOCK_SIZE), np.uint8)
    frags.reshape(-1)[:n] = np.frombuffer(data, np.uint8)
    lens = np.full(nfrags, BLOCK_SIZE, np.int32)
    lens[-1] = n - (nfrags - 1) * BLOCK_SIZE
    bodies, body_lens = block.compress_fragments(
        frags, lens, kernel="best" if level == "best" else None, device=dev)
    bodies, body_lens = bodies.cpu().numpy(), body_lens.cpu().tolist()
    return write_varint(n) + b"".join(bodies[i, : body_lens[i]].tobytes()
                                      for i in range(nfrags))


@pytest.mark.parametrize("level", ["fast", "best"])
@pytest.mark.parametrize("n", LENGTHS)
def test_compress_equals_zero_padded_rows(dev, pool, level, n):
    data = _object(n, seed=n % 97)
    got = st.compress(data, level=level, device=dev)
    assert got == _padded_stream(data, level, dev)
    assert oracle.decompress(np.frombuffer(got, np.uint8)) == data


def test_smaller_call_after_a_larger_one_sees_a_zero_tail(dev, pool, monkeypatch):
    """The second call's rows come from the buffer the first one filled
    with random bytes (same bucket); past its length they must be zero."""
    seen = []
    real = block._encode_rows

    def capture(fs, ls, *args):
        seen.append((fs.data_ptr(), fs.cpu().clone(), ls.cpu().clone()))
        return real(fs, ls, *args)

    monkeypatch.setattr(block, "_encode_rows", capture)
    rng = np.random.default_rng(3)
    big = rng.integers(0, 256, 4 * BLOCK_SIZE - 100, dtype=np.uint8).tobytes()
    small = _object(2 * BLOCK_SIZE + 777, seed=5)
    st.compress(big, device=dev)
    (stale,) = pool._buffers[(4 * BLOCK_SIZE, dev.type == "cuda")]
    assert stale[len(small) : 3 * BLOCK_SIZE].numpy().any()  # the tail to clear is dirty
    got = st.compress(small, device=dev)
    assert pool.rents[f"{_kind(dev)}.reused"] >= 1
    if dev.type == "cpu":  # the rows are the staging buffer itself
        assert seen[1][0] == stale.data_ptr()
    rows, lens = seen[1][1], seen[1][2]
    assert rows.shape == (3, BLOCK_SIZE)
    assert lens.tolist() == [BLOCK_SIZE, BLOCK_SIZE, len(small) - 2 * BLOCK_SIZE]
    flat = rows.reshape(-1).numpy()
    assert flat[: len(small)].tobytes() == small
    assert not flat[len(small) :].any()
    assert got == _padded_stream(small, "fast", dev)


def test_into_try_and_memory_agree_with_compress(dev, pool):
    data = _object(2 * BLOCK_SIZE + 4321, seed=8)
    ref = st.compress(data, device=dev)
    out = bytearray(st.get_max_compressed_length(len(data)))
    assert st.compress_into(data, out, device=dev) == len(ref)
    assert bytes(out[: len(ref)]) == ref
    arr = np.zeros(len(ref) + 9, np.uint8)
    assert st.try_compress(data, arr, device=dev) == (True, len(ref))
    assert arr[: len(ref)].tobytes() == ref
    with st.compress_to_memory(data, device=dev) as m:
        assert bytes(m) == ref
    # The minimum-size check passes and the result does not fit: the
    # fetched bodies' buffer still goes back to the pool.
    assert st.try_compress(data, bytearray(len(ref) - 1), device=dev) == (False, 0)
    pool.reset_rents()
    assert st.compress(data, device=dev) == ref
    assert pool.rents == {f"{_kind(dev)}.reused": 2}


@pytest.mark.parametrize("level", ["fast", "best"])
def test_second_call_reuses_every_buffer(dev, pool, level):
    data = _object(3 * BLOCK_SIZE + 5, seed=11)
    first = st.compress(data, level=level, device=dev)
    assert pool.rents[f"{_kind(dev)}.allocated"] >= 1
    assert set(pool.rents) <= {f"{_kind(dev)}.allocated", f"{_kind(dev)}.reused"}
    pool.reset_rents()
    assert st.compress(data, level=level, device=dev) == first
    assert pool.rents == {f"{_kind(dev)}.reused": 2}


def test_a_failed_encode_drops_the_staging_buffer(dev, pool, monkeypatch):
    """An exception between the rent and the wait keeps the rows' buffer out
    of the pool (a copy may still read it); the next call allocates anew
    and is unaffected."""
    data = _object(BLOCK_SIZE + 10, seed=2)
    ref = st.compress(data, device=dev)

    def fail(*args):
        raise RuntimeError("planted")

    with monkeypatch.context() as m:
        m.setattr(block, "_encode_rows", fail)
        with pytest.raises(RuntimeError, match="planted"):
            st.compress(data, device=dev)
    pool.reset_rents()
    assert st.compress(data, device=dev) == ref
    assert pool.rents[f"{_kind(dev)}.allocated"] == 1


@pytest.mark.parametrize("piece", [4096, BLOCK_SIZE + 7])
def test_staging_copy_in_pieces_on_threads(dev, pool, monkeypatch, piece):
    """Pieces smaller than the object, some not a row's multiple: the copy
    spreads over the helper threads and the stream is unchanged."""
    data = _object(3 * BLOCK_SIZE + 999, seed=4)
    want = _padded_stream(data, "fast", dev)
    monkeypatch.setattr(block, "_PIECE", piece)
    assert st.compress(data, device=dev) == want
    src = np.frombuffer(data, np.uint8)
    dst = np.full(len(data) + 5, 7, np.uint8)
    block._copy(dst, src)
    assert dst[: len(data)].tobytes() == data and (dst[len(data) :] == 7).all()


def test_concurrent_callers_share_the_pool(dev, pool, monkeypatch):
    """More callers than cores, switching often, small copy pieces: every
    stream is its own object's, and every rent is counted."""
    monkeypatch.setattr(block, "_PIECE", 16384)
    datas = [_object(BLOCK_SIZE + 5000 * (i + 1), seed=30 + i) for i in range(6)]
    want = [st.compress(d, device=dev) for d in datas]
    pool.reset_rents()
    calls = [i % len(datas) for i in range(32)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(16) as callers:
            jobs = [callers.submit(st.compress, datas[i], device=dev) for i in calls]
            got = [job.result(timeout=120) for job in jobs]
    finally:
        sys.setswitchinterval(interval)
    assert got == [want[i] for i in calls]
    assert sum(pool.rents.values()) == 2 * len(calls)
