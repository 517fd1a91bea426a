"""The hybrid decode's micro-probes of the port
(``snappier_tpu_torch/ops/cuda/hybrid_probes.py``: ``chain``, ``chainrec``,
``vcopy`` in both modes, ``coissue``, ``iso``, ``bprobe``, ``cliff``,
``bitonic``) against the probes of ``tools/perf_probe_hybrid.py`` run in
Pallas interpret mode on the CPU.

The tool's probes build their ``pallas_call`` inside the function, take
their input from ``_tags_from_html`` (a corpus file that need not exist),
and print a time. For the span of a test, the module's ``_tags_from_html``
returns the port's :func:`tags_from_block` of a given block, its ``timeit``
calls the probe once and keeps the result, and ``R`` is a few trials;
``tests/torch_cases.py::interpreted_tool`` forces interpret mode. Nothing
under ``tools/`` changes. The TPU probes return one checksum word; what it
cannot see (an image, a scratch, the indices) is read from the TPU kernels
themselves, each called inside a kernel that copies its scratch out.
Comparisons are exact int32 equality.
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


def _tool_results(hybrid, monkeypatch, probe, block=None, R=4):
    """The tool's probe on ``block``'s tags, ``R`` trials; returns what each
    of its ``timeit`` calls computed, as numpy arrays."""
    got = []

    def once(fn, iters=3, passes=3):
        got.append(np.asarray(fn()))
        return 1.0

    monkeypatch.setattr(hybrid, "timeit", once)
    monkeypatch.setattr(hybrid, "R", R)
    if block is not None:
        tags = hp.tags_from_block(block)
        monkeypatch.setattr(hybrid, "_tags_from_html", lambda: tags)
    probe()
    return got


def _run_tool(hybrid, monkeypatch, probe, block=None, R=4):
    """The tool's probe on ``block``'s tags, ``R`` trials; returns the
    kernel's int32 result."""
    got = _tool_results(hybrid, monkeypatch, probe, block, R)
    assert len(got) == 1
    return int(got[0][0])


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


def test_coissue_vec_is_the_tile_of_nvec_8():
    """The vector stream alone (``coissue_vec``, a yardstick with no TPU
    counterpart) on the CPU: ``coissue``'s tile at nvec 8, which never
    depends on the chain, and the tile's count of odd words, at 5 and 37
    iterations from a random tile, at the TPU's 8,192 from the fill (the
    tile 0); it refuses a negative iteration count."""
    rng = np.random.default_rng(6)
    tile = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, hp.TILE, dtype=np.int64)
                            .astype(np.int32))
    for given, iters in ((tile, 5), (tile, 37), (None, hp.COISSUE_ITERS)):
        odd, got = hp.coissue_vec(given, iters, device="cpu")
        want = hp.coissue(3, hp.COISSUE_VEC_NVEC, given, iters, device="cpu")[1]
        assert (got == want).all() and odd.tolist() == [int((want & 1).sum())]
    assert not got.any()
    with pytest.raises(ValueError, match="iters"):
        hp.coissue_vec(tile, iters=-1)


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


# --- T13 iso, T17 bprobe, T19 cliff, T20 bitonic -------------------------------

ISO_CASES = [(m, "markup") for m in hp.ISO_MODES] + [("full", "word_mix"), ("scalar", "word_mix")]
SORT_KEYS = np.random.default_rng(5).integers(-(2**31), 2**31 - 1, hp.SORT_SHAPE,
                                               np.int64).astype(np.int32)  # the tool's keys


def _ties():
    """Keys with many ties (8 values), for the rule on equal keys."""
    return np.random.default_rng(9).integers(-4, 4, hp.SORT_SHAPE).astype(np.int32)


def _tpu_call(hybrid, body, out_shapes, args, in_specs, out_specs, scratch_shapes):
    """``body`` (a tool kernel with the extra outputs after its own) in
    interpret mode; returns its outputs as numpy arrays."""
    import jax
    import jax.numpy as jnp

    outs = hybrid.pl.pallas_call(
        body,
        out_shape=tuple(jax.ShapeDtypeStruct(sh, jnp.int32) for sh in out_shapes),
        in_specs=in_specs, out_specs=out_specs, scratch_shapes=scratch_shapes,
        compiler_params=hybrid.pltpu.CompilerParams(has_side_effects=True),
    )(*(jnp.asarray(a) for a in args))
    return [np.asarray(o) for o in outs]


def _tpu_iso(hybrid, rec, img, mode):
    """The TPU's iso: checksum and the image after the 20 passes."""
    import jax.numpy as jnp

    pl, pltpu = hybrid.pl, hybrid.pltpu

    def body(rec_ref, img_hbm, out_ref, img_out, img_s, sem):
        hybrid._iso_kernel(rec_ref, img_hbm, out_ref, img_s, sem, mode=mode)
        img_out[...] = img_s[...]

    return _tpu_call(hybrid, body, [(1,), (128, 128)], [rec, img.reshape(128, 128)],
                     [pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pl.ANY)],
                     (pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.VMEM)),
                     [pltpu.VMEM((128, 128), jnp.int32), pltpu.SemaphoreType.DMA])


def _tpu_bprobe(hybrid, nwhen):
    """The TPU's bprobe at seed 3: checksum and scratch."""
    import jax.numpy as jnp

    pl, pltpu = hybrid.pl, hybrid.pltpu

    def body(seed_ref, out_ref, scratch_out, scratch):
        hybrid._bprobe_kernel(seed_ref, out_ref, scratch, nwhen=nwhen)
        scratch_out[...] = scratch[...]

    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    return _tpu_call(hybrid, body, [(1,), (64,)], [np.array([3], np.int32)], [smem],
                     (smem, smem), [pltpu.SMEM((64,), jnp.int32)])


def _tpu_cliff(hybrid, monkeypatch, block, mode, R):
    """The TPU's cliff on ``block``: checksum and the image after R trials."""
    import jax.numpy as jnp

    pl, pltpu = hybrid.pl, hybrid.pltpu
    monkeypatch.setattr(hybrid, "R", R)
    adv, n, _ = hp.chain_inputs(block)

    def body(adv_ref, meta_ref, out_ref, img_out, adv_s, img, sem):
        hybrid._cliff_kernel(adv_ref, meta_ref, out_ref, adv_s, img, sem, mode=mode)
        img_out[...] = img[...]

    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    return _tpu_call(hybrid, body, [(1,), (hp.IMAGE_WORDS,)], [adv, np.array([n, 3], np.int32)],
                     [pl.BlockSpec(memory_space=pl.ANY), smem], (smem, smem),
                     [pltpu.SMEM((len(adv),), jnp.int32), pltpu.SMEM((hp.IMAGE_WORDS,), jnp.int32),
                      pltpu.SemaphoreType.DMA])


def _tpu_bitonic(hybrid, x):
    """The TPU's merge pass: keys and the indices it computes and drops."""
    import jax.numpy as jnp

    pl, pltpu = hybrid.pl, hybrid.pltpu

    def body(x_ref, out_ref, vals_out, keys, vals):
        hybrid._bitonic_kernel(x_ref, out_ref, keys, vals)
        vals_out[...] = vals[...]

    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    return _tpu_call(hybrid, body, [hp.SORT_SHAPE, hp.SORT_SHAPE], [x], [vmem], (vmem, vmem),
                     [pltpu.VMEM(hp.SORT_SHAPE, jnp.int32), pltpu.VMEM(hp.SORT_SHAPE, jnp.int32)])


@pytest.mark.parametrize("mode,name", ISO_CASES)
def test_iso_matches_interpreted_tpu_kernel(hybrid, monkeypatch, mode, name):
    want = _run_tool(hybrid, monkeypatch, lambda: hybrid.iso(mode), BLOCKS[name])
    rec = hp.iso_records(hp.tags_from_block(BLOCKS[name])[1])
    got, img = hp.iso(torch.from_numpy(rec), torch.arange(hp.IMAGE_WORDS, dtype=torch.int32), mode)
    assert got.tolist() == [want]
    assert img.dtype == torch.int32 and img.shape == (hp.IMAGE_WORDS,)


@pytest.mark.parametrize("mode", hp.ISO_MODES)
def test_iso_image_matches_tpu_kernel(hybrid, mode):
    """The image after the 20 passes, which the TPU's checksum does not see
    (four modes give one checksum), from an image that is not ``arange``."""
    rec = hp.iso_records(hp.tags_from_block(BLOCKS["markup"])[1])
    img = (np.arange(hp.IMAGE_WORDS, dtype=np.int64) * 40503).astype(np.int32)
    want, want_img = _tpu_iso(hybrid, rec, img, mode)
    got, got_img = hp.iso(torch.from_numpy(rec), torch.from_numpy(img), mode)
    assert got.tolist() == want.tolist()
    assert (got_img.numpy() == want_img.reshape(-1)).all()
    assert (mode == "scalar") == (got_img.numpy() == img).all()


def test_iso_full_is_vcopy_2d_replayed():
    """``full``'s image is T11's 2d body over the same records, pass by pass
    (odd passes from record 1)."""
    rec = hp.iso_records(hp.tags_from_block(BLOCKS["markup"])[1])
    nrec = int(rec[hp.COUNT_AT])
    img = torch.arange(hp.IMAGE_WORDS, dtype=torch.int32)
    _, want = hp.iso(torch.from_numpy(rec), img, "full")
    for p in range(hp.ISO_PASSES):
        s = p & 1
        r = np.zeros_like(rec)
        for k in range(3):
            r[k * hp.REC_HALF : k * hp.REC_HALF + nrec - s] = rec[k * hp.REC_HALF + s :
                                                                  k * hp.REC_HALF + nrec]
        r[hp.COUNT_AT] = nrec - s
        img = hp.vcopy_plain(torch.from_numpy(r), img, "2d")[1]
    assert (img == want).all()


@pytest.mark.parametrize("nwhen", [0, 1, 3, 8])
def test_bprobe_matches_interpreted_tpu_kernel(hybrid, monkeypatch, nwhen):
    """The tool's 524,288 iterations at seed 3; the scratch from the TPU
    kernel."""
    want = _run_tool(hybrid, monkeypatch, lambda: hybrid.bprobe(nwhen))
    got, scratch = hp.bprobe(nwhen, device="cpu")
    assert got.tolist() == [want]
    want_sum, want_scratch = _tpu_bprobe(hybrid, nwhen)
    assert want_sum.tolist() == [want] and (scratch.numpy() == want_scratch).all()


def test_bprobe_floor_is_the_mix_chain():
    """The floor yardstick's plain version against the recurrence written
    in numpy int32 arithmetic (an arithmetic shift, wrapping adds) over
    2,048 iterations from 64 seeds at once; the CPU wrapper runs it over
    bprobe's 524,288 iterations and launches nothing."""
    from snappier_tpu_torch.ops.cuda import _build

    seeds = np.random.default_rng(17).integers(-(1 << 31), 1 << 31, 64).astype(np.int32)
    seeds[:3] = (3, -5, hp.FILL)
    x, acc = seeds.copy(), np.zeros(64, np.int32)
    with np.errstate(over="ignore"):
        for t in range(2048):
            x = x ^ np.int32(t)
            for _ in range(4):
                x = (x + (x >> 3)) & np.int32(0x7FFFFFFF)
            acc += x
    got = [int(hp.bprobe_floor_plain(int(s), 2048)[0]) for s in seeds]
    assert got == acc.tolist()
    _build.reset_launches()
    full = hp.bprobe_floor(3, device="cpu")
    assert full.dtype == torch.int32 and full.shape == (1,) and not _build.LAUNCHES
    assert full.tolist() == hp.bprobe_floor_plain(3).tolist() != hp.bprobe_plain(1)[0].tolist()
    with pytest.raises(ValueError, match="unsupported device"):
        hp.bprobe_floor(3, device="meta")


def test_bprobe_select_stores_equal_three_whens():
    """Three select-stores (nwhen 0) and three conditional stores compute
    the same thing: checksum and scratch."""
    a, b = hp.bprobe(0, device="cpu"), hp.bprobe(3, device="cpu")
    assert a[0].tolist() == b[0].tolist() and (a[1] == b[1]).all()
    assert (a[1] != hp.FILL).any() and hp.bprobe(1, device="cpu")[0].tolist() != a[0].tolist()


@pytest.mark.parametrize("mode", hp.CLIFF_MODES)
@pytest.mark.parametrize("name", list(BLOCKS))
def test_cliff_matches_interpreted_tpu_kernel(hybrid, monkeypatch, name, mode):
    want = _run_tool(hybrid, monkeypatch, lambda: hybrid.cliff(mode), BLOCKS[name])
    adv, n, _ = hp.chain_inputs(BLOCKS[name])
    got, img = hp.cliff(torch.from_numpy(adv), n, mode, start=3, R=4)
    assert got.tolist() == [want]
    want_sum, want_img = _tpu_cliff(hybrid, monkeypatch, BLOCKS[name], mode, 4)
    assert want_sum.tolist() == [want] and (img.numpy() == want_img).all()
    assert (img != hp.FILL).any() == (mode != "load4")  # load4 only copies the fill


def test_bitonic_matches_interpreted_tpu_kernel(hybrid, monkeypatch):
    """The tool's keys (the first result its ``timeit`` sees; the second is
    the library sort), and the indices from the TPU kernel, on the tool's
    keys and on keys with many ties."""
    got = _tool_results(hybrid, monkeypatch, hybrid.bitonic)
    assert len(got) == 2
    assert (got[1].reshape(-1) == np.sort(SORT_KEYS.reshape(-1))).all()
    for x in (SORT_KEYS, _ties()):
        keys, vals = hp.bitonic(torch.from_numpy(x))
        want_keys, want_vals = _tpu_bitonic(hybrid, x)
        assert keys.shape == vals.shape == hp.SORT_SHAPE
        assert (keys.numpy() == want_keys).all() and (vals.numpy() == want_vals).all()
        if x is SORT_KEYS:
            assert (keys.numpy() == got[0]).all()


@pytest.mark.parametrize("ties", [False, True])
def test_bitonic_vals_are_where_the_keys_came_from(ties):
    """``keys == x.flat[vals]`` and ``vals`` is a permutation, with and
    without ties; the first stage takes the smaller key of each pair at
    stride 32,768 to the lower half, which the later stages only reorder."""
    x = _ties() if ties else SORT_KEYS
    keys, vals = (t.reshape(-1).numpy() for t in hp.bitonic(torch.from_numpy(x)))
    flat = x.reshape(-1)
    assert (keys == flat[vals]).all()
    assert (np.sort(vals) == np.arange(hp.SORT_N)).all()
    assert not (vals == np.arange(hp.SORT_N)).all()
    half = hp.SORT_N // 2
    assert (np.sort(keys[:half]) == np.sort(np.minimum(flat[:half], flat[half:]))).all()


def test_new_probe_argument_checks():
    img = torch.arange(hp.IMAGE_WORDS, dtype=torch.int32)
    rec = torch.zeros(hp.VCOPY_WORDS, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown mode"):
        hp.iso(rec, img, "2d")
    with pytest.raises(ValueError, match="32768"):
        hp.iso(rec[:100], img, "full")
    with pytest.raises(ValueError, match="16384"):
        hp.iso(rec, img[:100], "full")
    rec[hp.COUNT_AT] = hp.REC_WORDS + 1
    with pytest.raises(ValueError, match="loop count"):
        hp.iso(rec, img, "scalar")
    # A source in the image's last row: full reads the row after it, the
    # one-row modes stay inside; scalar takes any record.
    rec[hp.COUNT_AT] = 1
    rec[hp.REC_HALF] = 4 * (127 * 128 + 5)
    with pytest.raises(ValueError, match="record 0 .* leaves the image in mode full"):
        hp.iso(rec, img, "full")
    rows = img.reshape(128, 128)
    row0 = {"dynload": rows[127], "dynload8": rows[120], "statroll": rows[127].roll(5),
            "dynroll": rows[127].roll(128 - 5)}  # torch.roll rolls as pltpu.roll
    for mode, want in row0.items():
        assert (hp.iso(rec, img, mode)[1].reshape(128, 128)[0] == want).all(), mode
    rec[0] = -8
    with pytest.raises(ValueError, match="leaves the image in mode dynload"):
        hp.iso(rec, img, "dynload")
    assert hp.iso(rec, img, "scalar")[1].equal(img)
    assert hp.iso_records(np.zeros((5, 4), np.int32))[hp.COUNT_AT] == 5
    with pytest.raises(ValueError, match="nwhen"):
        hp.bprobe(32, device="cpu")
    with pytest.raises(ValueError, match="nwhen"):
        hp.bprobe(-1, device="cpu")
    adv = torch.ones(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown mode"):
        hp.cliff(adv, 10, "when3")
    with pytest.raises(ValueError, match="n <= len"):
        hp.cliff(adv, 65, "when1")
    zero = adv.clone()
    zero[20] = 0
    with pytest.raises(ValueError, match="would not end"):
        hp.cliff(zero, 30, "store4")
    with pytest.raises(ValueError, match="shared memory"):
        hp.cliff(torch.ones(45000, dtype=torch.int32), 10, "when1")
    assert hp.cliff(torch.ones(40000, dtype=torch.int32), 10, "when1", R=2)[0].tolist() == [
        _i32_sum(10 + 7, 10 + 6, hp.FILL)]
    with pytest.raises(ValueError, match="65536"):
        hp.bitonic(torch.zeros(100, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        hp.bitonic(torch.zeros(hp.SORT_N, dtype=torch.int64))


def _i32_sum(*xs):
    v = sum(xs) & 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v
