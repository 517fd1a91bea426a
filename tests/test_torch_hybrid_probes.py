"""The hybrid decode's micro-probes of the port
(``snappier_tpu_torch/ops/cuda/hybrid_probes.py``: ``chain``, ``chainrec``,
``vcopy`` in both modes, ``coissue``) against the probes of
``tools/perf_probe_hybrid.py`` run in Pallas interpret mode on the CPU.

The tool's probes build their ``pallas_call`` inside the function, take
their input from ``_tags_from_html`` (a corpus file that need not exist),
and print a time. For the span of a test, the module's ``_tags_from_html``
returns the port's :func:`tags_from_block` of a given block, its ``timeit``
calls the probe once and keeps the result, and ``R`` is a few trials;
``tests/torch_cases.py::interpreted_tool`` forces interpret mode. Nothing
under ``tools/`` changes. Comparisons are exact int32 equality.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.ops.cuda import hybrid_probes as hp
from tests.torch_cases import interpreted_tool, probe_blocks, vcopy_edges

BLOCKS = probe_blocks()
COISSUE_FILL_SUM = -1848653238  # seed 3 from interpret mode's 0x80000000 fill


@pytest.fixture(scope="module")
def hybrid():
    """``tools/perf_probe_hybrid.py`` with its kernels in interpret mode."""
    with interpreted_tool("perf_probe_hybrid") as mod:
        yield mod


def _run_tool(hybrid, monkeypatch, probe, block=None, R=4):
    """The tool's probe on ``block``'s tags, ``R`` trials; returns the
    kernel's int32 result."""
    got = []

    def once(fn, iters=3, passes=3):
        got.append(int(np.asarray(fn())[0]))
        return 1.0

    monkeypatch.setattr(hybrid, "timeit", once)
    monkeypatch.setattr(hybrid, "R", R)
    if block is not None:
        tags = hp.tags_from_block(block)
        monkeypatch.setattr(hybrid, "_tags_from_html", lambda: tags)
    probe()
    assert len(got) == 1
    return got[0]


@pytest.mark.parametrize("name", list(BLOCKS))
def test_tags_walk_the_block(name):
    """Each record accounts for its bytes of the plaintext: a literal's
    bytes sit in the block at ``src``, a copy's repeat the output at ``src``;
    the advances cover the block exactly."""
    block = BLOCKS[name]
    plain = oracle.decompress(block)
    adv, recs, n, out_len = hp.tags_from_block(block)
    assert n == len(block) and out_len == len(plain) == int(recs[:, 2].sum())
    assert adv.dtype == np.int32 and len(adv) == len(block) + 8
    out = bytearray()
    for op, src, ln, is_lit in recs.tolist():
        assert op == len(out)
        if is_lit:
            out += block[src : src + ln]
        else:
            for i in range(ln):
                out.append(out[src + i])
    assert bytes(out) == plain
    starts = recs.shape[0]
    assert (adv != 1).sum() == starts and (adv[adv != 1] >= 2).all()
    advp, n2, ntags = hp.chain_inputs(block)
    assert len(advp) % 1024 == 0 and n2 == n and ntags == starts
    assert (advp[: len(adv)] == adv).all() and not advp[len(adv) :].any()


@pytest.mark.parametrize("with_rec", [False, True], ids=["chain", "chainrec"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_chain_matches_interpreted_tpu_kernel(hybrid, monkeypatch, name, with_rec):
    want = _run_tool(hybrid, monkeypatch, lambda: hybrid.chain(with_rec), BLOCKS[name])
    adv, n, ntags = hp.chain_inputs(BLOCKS[name])
    got, recs = hp.chain(torch.from_numpy(adv), n, start=3, R=4, with_rec=with_rec)
    assert got.dtype == torch.int32 and got.tolist() == [want]
    assert recs.shape == ((hp.REC_WORDS,) if with_rec else (0,))


@pytest.mark.parametrize("mode", ["2d", "3d"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_vcopy_matches_interpreted_tpu_kernel(hybrid, monkeypatch, name, mode):
    want = _run_tool(hybrid, monkeypatch, lambda: hybrid.vcopy(mode), BLOCKS[name])
    rec = hp.vcopy_records(hp.tags_from_block(BLOCKS[name])[1])
    got, img = hp.vcopy(torch.from_numpy(rec), torch.arange(hp.IMAGE_WORDS, dtype=torch.int32),
                        mode)
    assert got.tolist() == [want]
    assert img.dtype == torch.int32 and img.shape == (hp.IMAGE_WORDS,)


@pytest.mark.parametrize("mode", ["2d", "3d"])
def test_vcopy_edges_match_interpreted_tpu_kernel(hybrid, mode):
    """The TPU's copy body on records that the tool's construction cannot
    make (3d: a source in the image's last row), called as the tool calls
    it."""
    import functools

    import jax
    import jax.numpy as jnp

    rec = vcopy_edges(mode)
    shape = (128, 128) if mode == "2d" else (16, 8, 128)
    img = (np.arange(hp.IMAGE_WORDS, dtype=np.int64) * 40503).astype(np.int32)
    pl, pltpu = hybrid.pl, hybrid.pltpu
    want = pl.pallas_call(
        functools.partial(hybrid._vcopy_kernel, mode=mode),
        out_shape=jax.ShapeDtypeStruct((1,), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        scratch_shapes=[pltpu.VMEM(shape, jnp.int32), pltpu.SemaphoreType.DMA],
        compiler_params=pltpu.CompilerParams(has_side_effects=True),
    )(jnp.asarray(rec), jnp.asarray(img.reshape(shape)))
    got, _ = hp.vcopy(torch.from_numpy(rec), torch.from_numpy(img), mode)
    assert got.tolist() == np.asarray(want).tolist()
    if mode == "3d":
        assert ((rec[hp.REC_HALF : hp.REC_HALF + 200] >> 9) == 127).any()


def test_vcopy_modes_differ_where_the_tpu_bodies_do():
    """On the word mix the records reach both 3d cases (a source row that
    ends its tile, a destination at row 7 that spills), and the two modes'
    sums differ, as the TPU's do."""
    rec = hp.vcopy_records(hp.tags_from_block(BLOCKS["word_mix"])[1])
    count = int(rec[hp.COUNT_AT])
    assert count == 2 * len(hp.tags_from_block(BLOCKS["word_mix"])[1])
    dst, src, ln = (rec[k * hp.REC_HALF : k * hp.REC_HALF + count] for k in range(3))
    nw = ((ln + 3) >> 2) + 1
    assert ((src >> 9) & 7 == 7).any()
    assert (((dst >> 9) & 7 == 7) & ((dst >> 2) % 128 + nw > 128)).any()
    assert (nw > 128).any()  # the records past nrec take the loop count as a length
    img = torch.arange(hp.IMAGE_WORDS, dtype=torch.int32)
    s2, i2 = hp.vcopy(torch.from_numpy(rec), img, "2d")
    s3, i3 = hp.vcopy(torch.from_numpy(rec), img, "3d")
    assert s2.tolist() != s3.tolist() and not (i2 == i3).all()


@pytest.mark.parametrize("nvec", [0, 1, 8])
def test_coissue_matches_interpreted_tpu_kernel(hybrid, monkeypatch, nvec):
    """Interpret mode fills the unwritten scratch and tile with 0x80000000;
    one update takes such a tile to 0, so every nvec gives the same sum."""
    want = _run_tool(hybrid, monkeypatch, lambda: hybrid.coissue(nvec))
    got, tile = hp.coissue(3, nvec, device="cpu")
    assert got.tolist() == [want] == [COISSUE_FILL_SUM]
    assert tile.shape == hp.TILE and (tile == (hp.FILL if nvec == 0 else 0)).all()


def test_coissue_result_never_sees_the_tile_updates():
    """4,096 updates take any tile to 0 modulo 2**32 (modulo 2, ``(3 + S^k)^128
    = 1 + S^(128 k) = 0`` for the rotation ``S``), so at the TPU's 8,192
    iterations and nvec >= 1 the tile is 0 and the sum the scalar chain's,
    from any tile. At 5 iterations the updates show, in the tile and the
    sum."""
    rng = np.random.default_rng(5)
    tile = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, hp.TILE, dtype=np.int64)
                            .astype(np.int32))
    runs = {nvec: hp.coissue(3, nvec, tile) for nvec in (0, 1, 2)}
    assert runs[0][0].tolist() == [COISSUE_FILL_SUM + int((tile & 1).sum())]
    assert (runs[0][1] == tile).all()
    for nvec in (1, 2):
        assert runs[nvec][0].tolist() == [COISSUE_FILL_SUM] and not runs[nvec][1].any()
    short = {nvec: hp.coissue(3, nvec, tile, iters=5) for nvec in (0, 1, 2)}
    assert len({int(x[0]) for x in short.values()}) == 3
    v = tile.numpy().view(np.uint32)
    for _ in range(5):
        v = v * np.uint32(3) + np.roll(v, 1, axis=1)
    assert (short[1][1].numpy().view(np.uint32) == v).all()


def test_chainrec_records_are_the_last_trials():
    """The record buffer holds the last trial's steps over the one before
    it; a walk of more than 8,192 steps wraps its record index."""
    adv = torch.tensor([1, 1, 1, 2, 1, 3, 9, 1, 4, 9, 9, 9, 2, 1, 1, 1], dtype=torch.int32)
    n = 14
    _, recs = hp.chain(adv, n, start=3, R=2, with_rec=True)
    # r = 1 starts at 4: 4 -> 5 -> 8 -> 12 -> 14; r = 0 starts at 3: 3 -> 5 -> 8 -> 12 -> 14.
    want = [(4 << 8) | 1, (5 << 8) | 3, (8 << 8) | 4, (12 << 8) | 2]
    assert recs[:4].tolist() == want
    assert recs[hp.REC_HALF : hp.REC_HALF + 4].tolist() == [0, 1, 4, 8]
    assert not recs[4 : hp.REC_HALF].any()
    long = torch.ones(20000, dtype=torch.int32)
    total, recs = hp.chain(long, 20000, start=0, R=1, with_rec=True)
    assert total.tolist() == [20000 + 20000]
    assert recs[0].item() == ((16384 << 8) | 1) and recs[hp.REC_HALF].item() == 16384
    assert recs[hp.REC_HALF - 1].item() == ((16383 << 8) | 1)
    assert hp.chain(long, 20000, start=0, R=3)[0].tolist() == [3 * 20000]


def test_wrapper_argument_checks():
    adv = torch.ones(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        hp.chain(adv.float(), 10)
    with pytest.raises(ValueError, match="n <= len"):
        hp.chain(adv, 65)
    zero = adv.clone()
    zero[20] = 0
    with pytest.raises(ValueError, match="would not end"):
        hp.chain(zero, 30)
    assert hp.chain(zero, 20)[0].tolist() == [200 * 20]  # the 0 lies past n
    with pytest.raises(ValueError, match="shared memory"):
        hp.chain(torch.ones(50000, dtype=torch.int32), 10, with_rec=True)
    assert hp.chain(torch.ones(50000, dtype=torch.int32), 10)[0].tolist() == [2000]
    img = torch.arange(hp.IMAGE_WORDS, dtype=torch.int32)
    rec = torch.zeros(hp.VCOPY_WORDS, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown mode"):
        hp.vcopy(rec, img, "1d")
    with pytest.raises(ValueError, match="32768"):
        hp.vcopy(rec[:100], img)
    with pytest.raises(ValueError, match="16384"):
        hp.vcopy(rec, img[:100])
    rec[hp.COUNT_AT] = hp.REC_WORDS + 1
    with pytest.raises(ValueError, match="loop count"):
        hp.vcopy(rec, img)
    # A source in the image's last row: the 2d body reads the row after it
    # (out of the image), the 3d body clamps to tile 15.
    rec[hp.COUNT_AT] = 1
    rec[hp.REC_HALF] = 4 * (127 * 128 + 5)
    with pytest.raises(ValueError, match="record 0 .* leaves the image in mode 2d"):
        hp.vcopy(rec, img, "2d")
    assert hp.vcopy(rec, img, "3d")[0].dtype == torch.int32
    rec[hp.REC_HALF] = -4
    with pytest.raises(ValueError, match="leaves the image in mode 3d"):
        hp.vcopy(rec, img, "3d")
    with pytest.raises(ValueError, match="at most 8192"):
        hp.vcopy_records(np.zeros((8193, 4), np.int32))
    with pytest.raises(ValueError, match="nvec"):
        hp.coissue(3, -1, device="cpu")
    with pytest.raises(ValueError, match="iters"):
        hp.coissue(3, 1, iters=-1, device="cpu")
    with pytest.raises(ValueError, match="1024"):
        hp.coissue(3, 0, torch.zeros(10, dtype=torch.int32))
    assert hp.coissue(3, 3, device="cpu")[0].tolist() == [COISSUE_FILL_SUM]  # any nvec here
