"""The port's block-axis sharding (``snappier_tpu_torch/parallel``,
``snappier_tpu_torch/graft_entry.py``) against ``snappier_tpu.parallel`` and
``__graft_entry__`` on the same numpy-seeded batches.

The reference runs on the virtual CPU devices that ``tests/conftest.py``
sets up (its scalar kernels in Pallas interpret mode, as off a TPU), the
port on a mesh of as many CPU shards, made by ``mesh_from_reference``.
Comparisons are exact (lengths, offsets, error words, ``ok``, bytes below
each length); bytes past a length are unspecified and never compared.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from snappier_tpu.format import oracle as ref_oracle
from snappier_tpu.parallel import distributed as ref_dist
from snappier_tpu.parallel import mesh as ref_mesh
from snappier_tpu_torch import graft_entry, parallel
from snappier_tpu_torch.convert import mesh_from_reference
from snappier_tpu_torch.errors import InvalidDataError
from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.format.varint import read_varint, write_varint
from snappier_tpu_torch.parallel import distributed, mesh as port_mesh
from tests.torch_cases import corrupt_streams

F = 2048  # small fragments: fast CPU compiles, same code path
KERNELS = ["scan", "scalar"]
SIZES = [1, 2, 8]


def _meshes(nd: int):
    if len(jax.devices()) < nd:
        pytest.skip(f"needs {nd} virtual devices")
    ref = ref_mesh.make_mesh(jax.devices()[:nd])
    return ref, mesh_from_reference(ref, device="cpu")


def _make_batch(b=16, seed=0):
    """The batch of tests/test_parallel.py."""
    rng = np.random.default_rng(seed)
    text = (b"shard me across the mesh in ordered blocks " * 2000)[: b * F]
    frags = np.frombuffer(text, np.uint8).reshape(b, F).astype(np.int32)
    frags[1::2, : F // 2] = rng.integers(0, 256, (b // 2, F // 2))
    lengths = np.full(b, F, np.int32)
    lengths[-1] = F // 3  # ragged tail
    frags[-1, F // 3 :] = 0
    return frags, lengths


def _small_window_stream(n_chunks=11, frag=2048, seed=9):
    """The variable-length stream of tests/test_parallel.py: each chunk
    compressed alone, bodies joined under one preamble."""
    rng = np.random.default_rng(seed)
    chunks = []
    for i in range(n_chunks):
        text = (f"fragment {i:04d} payload ".encode() * 200)[:frag]
        arr = np.frombuffer(text, np.uint8).copy()
        noise = rng.integers(0, 256, frag // 5, dtype=np.uint8)
        arr[i * 13 % (frag - len(noise)) :][: len(noise)] = noise
        chunks.append(arr.tobytes())
    chunks[-1] = chunks[-1][: frag // 3]  # ragged tail
    data = b"".join(chunks)
    parts = [write_varint(len(data))]
    for c in chunks:
        body = oracle.compress(np.frombuffer(c, np.uint8))
        _, off = read_varint(np.frombuffer(body, np.uint8))
        parts.append(body[off:])
    return data, b"".join(parts)


def _rows_equal(port_rows, ref_rows, lens):
    port_rows = port_rows.gather().numpy()
    ref_rows = np.asarray(ref_rows)
    assert port_rows.shape == ref_rows.shape
    for i, n in enumerate(lens):
        assert (port_rows[i, :n] == ref_rows[i, :n]).all(), i


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("nd", SIZES)
def test_sharded_compress_matches_jax(kernel, nd):
    ref, port = _meshes(nd)
    frags, lengths = _make_batch(seed=3)
    rb, rl, ro = ref_mesh.sharded_compress(frags, lengths, mesh=ref, kernel=kernel)
    pb, pl, po = parallel.sharded_compress(frags, lengths, mesh=port, kernel=kernel)
    assert pl.dtype == torch.int32 and po.dtype == torch.int64
    assert (pl.numpy() == np.asarray(rl)).all()
    assert (po.numpy() == np.asarray(ro)).all()
    _rows_equal(pb, rb, pl.tolist())
    assert len(pb.addressable_shards) == nd
    per = len(lengths) // nd
    assert [r for r, _ in pb.addressable_shards] == [
        range(s * per, (s + 1) * per) for s in range(nd)]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("nd", SIZES)
def test_sharded_decompress_matches_jax(kernel, nd):
    ref, port = _meshes(nd)
    frags, lengths = _make_batch(seed=5)
    b = frags.shape[0]
    comp = np.zeros((b, 3072), np.int32)
    comp_lens = np.zeros(b, np.int32)
    for i in range(b):
        c = np.frombuffer(ref_oracle.compress(frags[i, : lengths[i]].astype(np.uint8)), np.uint8)
        comp[i, : len(c)] = c
        comp_lens[i] = len(c)
    ro, rl, re = ref_mesh.sharded_decompress(comp, comp_lens, F, mesh=ref, kernel=kernel)
    po, pl, pe = parallel.sharded_decompress(comp, comp_lens, F, mesh=port, kernel=kernel)
    assert int(pe) == int(re) == 0
    assert (pl.numpy() == np.asarray(rl)).all() and (pl.numpy() == lengths).all()
    _rows_equal(po, ro, pl.tolist())
    for i in range(b):
        assert (po.gather().numpy()[i, : lengths[i]] == frags[i, : lengths[i]]).all()


@pytest.mark.parametrize("kernel", KERNELS)
def test_sharded_decompress_corrupt_rows_give_the_same_max_err(kernel):
    ref, port = _meshes(8)
    bad = corrupt_streams()
    for lo in (0, 8):  # two batches of 8 corrupt rows, one per shard
        rows = bad[lo : lo + 8]
        comp = np.zeros((8, 3072), np.int32)
        comp_lens = np.zeros(8, np.int32)
        for i, s in enumerate(rows):
            comp[i, : len(s)] = np.frombuffer(s, np.uint8)
            comp_lens[i] = len(s)
        _, rl, re = ref_mesh.sharded_decompress(comp, comp_lens, 1024, mesh=ref, kernel=kernel)
        _, pl, pe = parallel.sharded_decompress(comp, comp_lens, 1024, mesh=port, kernel=kernel)
        assert int(pe) == int(re) != 0
        assert (pl.numpy() == np.asarray(rl)).all()


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("nd", SIZES)
def test_sharded_roundtrip_step_matches_jax(kernel, nd):
    ref, port = _meshes(nd)
    frags, lengths = _make_batch()
    rb, rl, ro, rok = ref_mesh.sharded_roundtrip_step(frags, lengths, mesh=ref, kernel=kernel)
    pb, pl, po, pok = parallel.sharded_roundtrip_step(frags, lengths, mesh=port, kernel=kernel)
    assert bool(pok) and bool(rok)
    assert (pl.numpy() == np.asarray(rl)).all()
    assert (po.numpy() == np.asarray(ro)).all()
    off, bl = po.numpy(), pl.numpy()
    assert off[0] == 0 and (np.diff(off) == bl[:-1]).all()
    _rows_equal(pb, rb, bl.tolist())


def test_batch_must_be_a_multiple_of_the_mesh():
    _, port = _meshes(8)
    frags, lengths = _make_batch(b=12)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        parallel.sharded_compress(frags, lengths, mesh=port, kernel="scan")
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        parallel.sharded_roundtrip_step(frags, lengths, mesh=port, kernel="scalar")
    with pytest.raises(ValueError, match="unknown kernel"):
        parallel.sharded_compress(frags[:8], lengths[:8], mesh=port, kernel="pallas")


def test_no_quiet_cpu_mesh_and_default_kernel():
    """Without a card the default mesh raises; CPU shards must be named."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh(["cuda:0"])
    frags, lengths = _make_batch(b=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.sharded_compress(frags, lengths)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.compress_corpus_sharded(b"abc")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
    m = parallel.make_mesh(["cpu"] * 3)
    assert m.size == 3 and m.shape == {parallel.BLOCK_AXIS: 3} and m.world == 1
    assert port_mesh._check_kernel(None) in ("scalar", "scan")
    distributed.initialize()  # one process, no address: nothing to join
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(None, num_processes=2)
    with pytest.raises(ValueError, match="process_id"):  # it would wait for ranks that never come
        distributed.initialize("localhost:1", num_processes=2, process_id=5)
    assert not torch.distributed.is_initialized()


def test_mesh_from_reference_checks_the_axis():
    class Other:
        axis_names = ("data", "model")
        devices = np.zeros((2, 2))

    with pytest.raises(ValueError, match="axes"):
        mesh_from_reference(Other(), device="cpu")


def _meta_equal(port_meta, ref_meta):
    assert set(port_meta) == set(ref_meta)
    for k, v in ref_meta.items():
        if isinstance(v, (list, bool, int)):
            assert port_meta[k] == v, k
        else:
            assert (np.asarray(port_meta[k]) == np.asarray(v)).all(), k


@pytest.mark.parametrize("kernel", KERNELS)
def test_decompress_corpus_sharded_matches_jax(kernel):
    ref, port = _meshes(8)
    data, comp = _small_window_stream()
    r_plain, r_meta = ref_dist.decompress_corpus_sharded(
        comp, mesh=ref, kernel=kernel, fragment_size=F)
    p_plain, p_meta = distributed.decompress_corpus_sharded(
        comp, mesh=port, kernel=kernel, fragment_size=F)
    assert p_plain == r_plain == data
    _meta_equal(p_meta, r_meta)
    assert p_meta["local_fragments"] == list(range(len(p_meta["fragment_lengths"])))


@pytest.mark.parametrize("kernel", KERNELS)
def test_compress_corpus_sharded_matches_jax_on_900_kb(kernel):
    """The 900 KB buffer of tests/test_parallel.py: 14 fragments of 64 KiB
    padded to 16 rows; the same payload bytes and the same meta. The decode
    twin at the small fragment line falls back to the host decoder, as the
    reference's does (the compress twin's window is 64 KiB)."""
    ref, port = _meshes(8)
    data, _ = _small_window_stream()
    big = data * 40
    p_payload, p_meta = distributed.compress_corpus_sharded(big, mesh=port, kernel=kernel)
    r_payload, r_meta = ref_dist.compress_corpus_sharded(big, mesh=ref, kernel=kernel)
    assert p_payload == r_payload
    _meta_equal(p_meta, r_meta)
    assert ref_oracle.decompress(p_payload) == big
    off, bl = p_meta["block_offsets"], p_meta["block_lengths"]
    assert (np.diff(off) == bl[:-1]).all() and int(off[-1] + bl[-1]) == len(p_payload)
    assert p_meta["local_blocks"] == list(range(len(bl)))
    plain, meta = distributed.decompress_corpus_sharded(
        p_payload, mesh=port, kernel=kernel, fragment_size=F)
    assert plain == big
    assert meta.get("window_crossing_fallback") is True
    r_plain, r_meta = ref_dist.decompress_corpus_sharded(
        p_payload, mesh=ref, kernel=kernel, fragment_size=F)
    assert r_plain == plain
    _meta_equal(meta, r_meta)


def test_compress_corpus_sharded_small_buffers_match_jax():
    """Empty, tiny and one-fragment buffers through both compress twins
    (scan engine), mesh of 2."""
    ref, port = _meshes(2)
    for data in (b"", b"a", b"snappy " * 300):
        r_payload, r_meta = ref_dist.compress_corpus_sharded(data, mesh=ref, kernel="scan")
        p_payload, p_meta = distributed.compress_corpus_sharded(data, mesh=port, kernel="scan")
        assert p_payload == r_payload
        _meta_equal(p_meta, r_meta)
        assert oracle.decompress(np.frombuffer(p_payload, np.uint8)) == data


def test_decompress_corpus_sharded_at_the_production_line():
    """Two 64 KiB fragments and a tail through both twins at
    ``fragment_size = 65536`` (scalar engine's plain versions), no
    fallback."""
    _, port = _meshes(2)
    rng = np.random.default_rng(4)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"<tag>", b"\n"]
    data = b" ".join(words[i] for i in rng.integers(0, len(words), 30000))[:150000]
    payload, meta = distributed.compress_corpus_sharded(data, mesh=port, kernel="scalar")
    assert len(meta["block_lengths"]) == 3
    plain, dmeta = distributed.decompress_corpus_sharded(payload, mesh=port, kernel="scalar")
    assert plain == data and not dmeta.get("window_crossing_fallback")
    assert dmeta["fragment_lengths"].tolist() == [65536, 65536, 150000 - 131072]
    assert dmeta["local_fragments"] == [0, 1, 2]


@pytest.mark.parametrize("kernel", KERNELS)
def test_decompress_corpus_sharded_corrupt(kernel):
    """The corrupt case of tests/test_parallel.py: the same verdict as the
    reference, never garbage."""
    ref, port = _meshes(8)
    _, comp = _small_window_stream(n_chunks=5)
    bad = bytearray(comp)
    bad[len(bad) // 2] ^= 0xFF

    def run(fn, mesh, exc):
        try:
            return fn(bytes(bad), mesh=mesh, kernel=kernel, fragment_size=F)[0]
        except exc as e:
            return type(e).__name__

    from snappier_tpu.errors import InvalidDataError as RefInvalid

    got = run(distributed.decompress_corpus_sharded, port, InvalidDataError)
    want = run(ref_dist.decompress_corpus_sharded, ref, RefInvalid)
    assert got == want
    # A stream cut mid-tag must raise.
    with pytest.raises(InvalidDataError):
        distributed.decompress_corpus_sharded(comp[:-5], mesh=port, kernel=kernel,
                                              fragment_size=F)


def test_graft_entry_matches_reference():
    """The same example batch, and on it the bodies, lengths and CRCs of the
    reference codec on the engine the port's entry takes."""
    from snappier_tpu.models.codec import SnappyCodec as RefCodec

    fn, args = graft_entry.entry(device="cpu")
    _, r_args = ref_entry.entry()
    assert (args[0].numpy() == np.asarray(r_args[0])).all()
    assert (args[1].numpy() == np.asarray(r_args[1])).all()
    bodies, lens, crcs = fn(*args)
    rb, rl, rc = RefCodec(kernel=fn.__self__.kernel).compress_batch(*r_args)
    assert (lens.numpy() == np.asarray(rl)).all()
    assert (crcs.numpy() == np.asarray(rc)).all()
    assert bodies.shape == np.asarray(rb).shape
    for i, n in enumerate(lens.tolist()):
        assert (bodies[i, :n].numpy() == np.asarray(rb)[i, :n]).all(), i


def test_dryrun_multichip(capsys):
    graft_entry.dryrun_multichip(8, device="cpu")
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    ref_entry.dryrun_multichip(8)
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    # The reference prints its mesh shape as an OrderedDict; all else is equal.
    assert port_line.startswith("dryrun_multichip ok: mesh={'blocks': 8}, ")
    assert port_line.split("}, ", 1)[1] == ref_line.split("}), ", 1)[1]
