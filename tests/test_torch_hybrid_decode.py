"""The descriptor-driven block decode of the port
(``snappier_tpu_torch/ops/cuda/decode_hybrid.py``) against the decode kernels
of ``tools/perf_probe_hybrid.py`` run in Pallas interpret mode on the CPU.

The tool passes ``interpret=False`` literally, so the fixture swaps the
module's ``pl`` for a copy whose ``pallas_call`` forces ``interpret=True``
(``tests/torch_cases.py::interpreted_tool``); nothing under ``tools/``
changes. The TPU walks cut a row at ``owc * 4 - 1024`` bytes rather than at
``out_cap``, so the shapes here keep ``out_cap + 1024`` a multiple of 4096,
where the two agree. Comparisons are exact: the pre-passes bit for bit on
whole rows, the walks on error words, lengths and the bytes below each
length (bytes past ``out_len`` are unspecified and never compared).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.format.varint import write_varint
from snappier_tpu_torch.ops.cuda import decode_hybrid as dh
from snappier_tpu_torch.ops.cuda.scalar_codec import decode_blocks_plain
from tests.torch_cases import (
    corrupt_streams,
    interpreted_tool,
    pack_streams,
    step_back_streams,
    tag_sweep_sample,
    walk_streams,
)

CC, OUT_CAP = 4096, 3072  # OUT_CAP + 1024 is a multiple of 4096
FORMS = ["v5", "v6", "v7", "v7u"]


@pytest.fixture(scope="module")
def hybrid():
    """``tools/perf_probe_hybrid.py`` with its kernels in interpret mode."""
    with interpreted_tool("perf_probe_hybrid") as mod:
        yield mod


def _reference(hybrid, form, comp, lens, out_cap):
    c, n = jnp.asarray(comp), jnp.asarray(lens)
    if form in ("v7", "v7u"):
        res = hybrid.decode_v7(c, n, out_cap, form == "v7u")
    else:
        res = getattr(hybrid, f"decode_{form}")(c, n, out_cap)
    return [np.asarray(x) for x in res]


def _port(form, comp, lens, out_cap):
    c, n = torch.from_numpy(comp), torch.from_numpy(lens)  # int32 rows, as the JAX side takes
    if form in ("v7", "v7u"):
        res = dh.decode_v7(c, n, out_cap, unroll2=form == "v7u")
    else:
        res = getattr(dh, f"decode_{form}")(c, n, out_cap)
    return [x.numpy() for x in res]


def _assert_same(got, want):
    assert got[0].dtype == np.uint8 and got[0].shape == want[0].shape
    assert (got[2] == want[2]).all(), (got[2].tolist(), want[2].tolist())
    assert (got[1] == want[1]).all()
    for i in range(len(got[1])):
        assert (got[0][i, : got[1][i]] == want[0][i, : want[1][i]]).all(), i


@pytest.mark.parametrize("garbage", [None, 5], ids=["zero_tail", "garbage_tail"])
@pytest.mark.parametrize("form", FORMS)
def test_plain_matches_interpreted_tpu_kernel(hybrid, form, garbage):
    """Valid blocks (every short offset, overlapping copies, long literals, a
    4-byte offset) and corrupt ones: the TPU functions' error words, lengths
    and bytes."""
    valid = walk_streams()
    streams = valid + corrupt_streams()
    comp, lens = pack_streams(streams, CC, garbage_seed=garbage)
    want = _reference(hybrid, form, comp, lens, OUT_CAP)
    got = _port(form, comp, lens, OUT_CAP)
    _assert_same(got, want)
    assert not got[2][: len(valid)].any()
    assert not got[1][got[2] != 0].any()  # out_len is 0 on any error
    words = set(got[2].tolist())
    assert words == ({0, 4, 8} if form.startswith("v7") else {0, 2, 3, 4, 8}), words


@pytest.mark.parametrize("form", FORMS)
def test_plain_matches_interpreted_tpu_kernel_on_the_tag_sweep(hybrid, form):
    """Every 23rd stream of the exhaustive tag-byte sweep."""
    streams = tag_sweep_sample()
    comp, lens = pack_streams(streams, CC, garbage_seed=None)
    _assert_same(_port(form, comp, lens, OUT_CAP), _reference(hybrid, form, comp, lens, OUT_CAP))


def _prepass_rows():
    """Random bytes (every lane of every word sees bytes >= 0x80); tags whose
    4-byte literal length or copy offset wraps or sits at a poison edge
    (lengths 0xFFFFFFF8-0xFFFFFFFF, 0x7FFFFFFF, 0x80000000, 0x3FFFA-0x3FFFF;
    offsets 0xFFFF, 0x10000, negative), at every byte phase; and packed
    streams with garbage tails."""
    rng = np.random.default_rng(41)
    rand = rng.integers(0, 256, (3, CC))
    fields = [[x, 0xFF, 0xFF, 0xFF] for x in range(0xF8, 0x100)]
    fields += [[0xFF, 0xFF, 0xFF, 0x7F], [0, 0, 0, 0x80], [0xFF, 0xFF, 0, 0], [0, 0, 1, 0]]
    fields += [[x, 0xFF, 0x03, 0] for x in range(0xFA, 0x100)]
    groups = [[tag] + f for tag in (0xFC, 0xFF, 0xF8, 0xFE) for f in fields]
    runs = np.tile(np.array(sum(groups, []), np.int64), CC // (5 * len(groups)) + 1)[:CC]
    wraps = np.stack([np.roll(runs, k) for k in range(4)])
    comp, _ = pack_streams(walk_streams() + corrupt_streams(), CC, garbage_seed=9)
    return np.concatenate([rand, wraps, comp]).astype(np.int32)


def test_prepasses_bit_equal_to_jax(hybrid):
    rows = _prepass_rows()
    assert (rows[:3] >= 0x80).any(axis=1).all()
    B = rows.shape[0]
    c = jnp.asarray(rows)
    jwords = np.asarray((c.reshape(B, CC // 4, 4) * jnp.array([1, 1 << 8, 1 << 16, 1 << 24],
                                                             jnp.int32)).sum(axis=2,
                                                                             dtype=jnp.int32))
    t = torch.from_numpy(rows)
    words = dh.pack_words(t)
    assert words.dtype == torch.int32 and (words.numpy() == jwords).all()
    want = np.asarray(hybrid._spec_from_comp(c))
    got = dh.spec_from_comp(t)
    assert got.dtype == torch.int32 and (got.numpy() == want).all()
    assert (got.numpy() < 0).any() and (got.numpy() == (1 | (7 << 18))).any()
    assert (dh.spec_from_words(words, CC).numpy()
            == np.asarray(hybrid._spec_from_words(jnp.asarray(jwords), CC))).all()
    s0, s1 = dh.spec2_from_words(words, CC)
    j0, j1 = (np.asarray(x) for x in hybrid._spec2_from_words(jnp.asarray(jwords), CC))
    assert (s0.numpy() == j0).all() and (s1.numpy() == j1).all()


def test_prepass_of_uneven_rows():
    """Rows whose width is no multiple of 4: the word forms see the same
    bytes as the byte form, zeros past the row."""
    rows = torch.from_numpy(_prepass_rows()[:, :1001])
    words = dh.pack_words(rows)
    assert words.shape == (rows.shape[0], 251)
    assert (dh.spec_from_words(words, 1001) == dh.spec_from_comp(rows)).all()


def test_prepass_wrappers_on_the_cpu():
    """On CPU rows the pre-pass wrappers run their plain versions, the tensor
    code: prepass_v5 is spec_from_comp, prepass_v6 spec_from_words of
    pack_words, prepass_v7 spec2_from_words of pack_words; no kernel is
    launched."""
    from snappier_tpu_torch.ops.cuda import _build

    rows = torch.from_numpy(_prepass_rows()[:, :1003])
    _build.reset_launches()
    assert (dh.prepass_v5(rows) == dh.spec_from_comp(rows)).all()
    assert (dh.prepass_v6(rows) == dh.spec_from_words(dh.pack_words(rows), 1003)).all()
    for a, b in zip(dh.prepass_v7(rows), dh.spec2_from_words(dh.pack_words(rows), 1003)):
        assert (a == b).all()
    assert sum(_build.LAUNCHES.values()) == 0


def test_decode_v5_spec_equals_decode_v5():
    """T15's entry point on the pre-pass computed beforehand gives
    ``decode_v5``'s triple."""
    streams = walk_streams() + corrupt_streams()
    comp, lens = pack_streams(streams, CC)
    c, n = torch.from_numpy(comp), torch.from_numpy(lens)
    want = [x.numpy() for x in dh.decode_v5(c, n, OUT_CAP)]
    got = [x.numpy() for x in dh.decode_v5_spec(dh.pack_words(c), dh.spec_from_comp(c), n,
                                                 OUT_CAP)]
    _assert_same(got, want)


@pytest.mark.parametrize("form", FORMS)
def test_forms_match_production_decode_on_valid_input(form):
    """On valid blocks (three of 64 KiB among them) every form gives the
    production decoder's rows (its plain version's) and the plaintext."""
    streams = walk_streams(big=65536)
    comp, lens = pack_streams(streams, 68608)
    got = _port(form, comp, lens, 65536)
    k1 = [x.numpy() for x in decode_blocks_plain(torch.from_numpy(comp.astype(np.uint8)),
                                                 torch.from_numpy(lens), 65536)]
    assert not got[2].any() and not k1[2].any() and (got[1] == k1[1]).all()
    for i, s in enumerate(streams):
        assert (got[0][i, : got[1][i]] == k1[0][i, : k1[1][i]]).all(), i
        assert got[0][i, : got[1][i]].tobytes() == oracle.decompress(s), i


@pytest.mark.parametrize("form", FORMS)
def test_verdicts_match_production_decode(form):
    """The forms refuse exactly the blocks the production decoder refuses, by
    their own words: 8 where it says 8."""
    streams = corrupt_streams() + tag_sweep_sample(61)
    comp, lens = pack_streams(streams, 2048)
    got = _port(form, comp, lens, 1024)
    k1 = decode_blocks_plain(torch.from_numpy(comp.astype(np.uint8)), torch.from_numpy(lens), 1024)
    k1_err = k1[2].numpy()
    assert ((got[2] == 0) == (k1_err == 0)).all()
    assert ((got[2] == 8) == (k1_err == 8)).all()
    assert (got[1] == k1[1].numpy()).all()


def test_negative_literal_step_back(hybrid):
    """A 4-byte literal length of 0xFFFFFFFE is a literal of -1 bytes that
    advances 4: the next tag starts at its top length byte (a copy-4 tag).
    ``v5`` steps its output back by one byte, as the TPU function does;
    ``v6`` and ``v7`` take the literal as empty. Where the step would take
    the output below 0, ``v5`` refuses the tag with 4 (the TPU walk takes it
    and fails on the next tag with 3)."""
    lit16 = bytes([15 << 2]) + b"abcdefghijklmnop"
    neg = bytes([0xFC, 0xFE, 0xFF, 0xFF, 0xFF, 8, 0, 0, 0])  # then 64 bytes at offset 8
    back = write_varint(79) + lit16 + neg
    comp, lens = pack_streams([back, bytes([64]) + neg], CC)
    c, n = torch.from_numpy(comp), torch.from_numpy(lens)
    got = [x.numpy() for x in dh.decode_v5(c, n, OUT_CAP)]
    want = _reference(hybrid, "v5", comp, lens, OUT_CAP)
    assert got[2].tolist() == [0, 4] and want[2].tolist() == [0, 3]
    _assert_same([x[:1] for x in got], [x[:1] for x in want])
    plain = bytearray(b"abcdefghijklmno")
    for _ in range(64):
        plain.append(plain[-8])
    assert got[0][0, : got[1][0]].tobytes() == bytes(plain)
    for form in ("v6", "v7"):
        assert _port(form, comp, lens, OUT_CAP)[2].tolist() == [4, 3 if form == "v6" else 4]


@pytest.mark.parametrize("form", ["v5", "v6"])
def test_step_back_inside_one_batch(hybrid, form):
    """``torch_cases.step_back_streams``: the step back after four tags of one
    32-byte window (twice in the second block) and in a batch of its own.
    ``v5`` decodes them as the TPU function does, the output stepped back a
    byte each time; ``v6`` takes the literal as empty and overruns the
    claim (4), as the TPU function does."""
    streams = step_back_streams()
    comp, lens = pack_streams(streams, CC)
    got = _port(form, comp, lens, OUT_CAP)
    _assert_same(got, _reference(hybrid, form, comp, lens, OUT_CAP))
    if form == "v6":
        assert got[2].tolist() == [4, 4, 4]
        return
    assert got[2].tolist() == [0, 0, 0]
    head = bytearray(b"ab" + b"abab" + b"cde" + b"cdecd")
    out = head[:-1]
    for _ in range(64):
        out.append(out[-8])
    assert got[0][0, : got[1][0]].tobytes() == bytes(out + b"xyz")
    twice = out + head[:-1]
    for _ in range(64):
        twice.append(twice[-5])
    assert got[0][1, : got[1][1]].tobytes() == bytes(twice)


def test_wrapper_argument_checks():
    comp = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.tensor([3, 3], dtype=torch.int32)
    # Every form holds the output image alone in shared memory: an out_cap
    # whose image does not fit is refused, a wide row is taken.
    for fn in (dh.decode_v5, dh.decode_v6, dh.decode_v7):
        with pytest.raises(ValueError, match="shared memory"):
            fn(comp, lens, 232000)
    wide = dh.decode_v5(torch.zeros((1, 200000), dtype=torch.uint8), lens[:1], 65536)
    assert wide[2].tolist() == [4] and wide[1].tolist() == [0]
    with pytest.raises(ValueError, match="shared memory"):
        dh.decode_v5_spec(dh.pack_words(comp), dh.spec_from_comp(comp), lens, 232000)
    with pytest.raises(ValueError):
        dh.decode_v6(comp, lens[:1], 64)
    with pytest.raises(ValueError):
        dh.decode_v7(comp.float(), lens, 64)
    with pytest.raises(ValueError, match="unknown form"):
        dh.decode_hybrid_plain(comp, lens, 64, "v8")
    with pytest.raises(ValueError, match="does not fit"):
        dh.decode_v5_spec(dh.pack_words(comp), torch.zeros((2, 65), dtype=torch.int32), lens, 64)
    with pytest.raises(ValueError, match="int32"):
        dh.decode_v5_spec(comp, dh.spec_from_comp(comp), lens, 64)
    # Lengths outside the row are taken as 0 or the row's width.
    out = dh.decode_v5(comp, torch.tensor([-4, 1000], dtype=torch.int32), 64)
    assert out[2].tolist() == [8, 4] and out[1].tolist() == [0, 0]


def test_probe_tool_names_what_is_not_ported():
    """``tools/torch_perf_probe_hybrid.py`` runs the five decode probes and
    every micro-probe of the JAX tool (none is left unported) and refuses an
    unknown name or mode; without a card it exits 2 and times nothing."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "torch_perf_probe_hybrid.py"
    spec = importlib.util.spec_from_file_location("torch_perf_probe_hybrid", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name in tool.PROBES:
        tool.check_probe(name)
    assert {"chain", "chainrec", "vcopy2d", "vcopy3d", "coissue0", "coissue8", "iso:full",
            "iso:dynload8", "bprobe0", "bprobe2", "bprobe8", "cliff:when1", "cliff:load4",
            "bitonic"} <= set(tool.PROBES)
    assert not hasattr(tool, "NOT_PORTED")
    for name in ("iso:bogus", "cliff:bogus", "bprobe5", "bitonic2", "vcopy1d"):
        with pytest.raises(ValueError, match=f"unknown probe {name!r}"):
            tool.check_probe(name)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    import subprocess
    import sys

    for probes in (["v5"], ["chain", "vcopy3d", "coissue8"],
                   ["iso:full", "bprobe3", "cliff:load4", "bitonic"]):
        r = subprocess.run([sys.executable, str(path), *probes], capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 2 and "no CUDA device" in r.stderr and not r.stdout
