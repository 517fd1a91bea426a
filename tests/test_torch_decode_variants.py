"""The plain versions of the decode-walk ablation variants
(``snappier_tpu_torch/ops/cuda/decode_variants.py``) against the TPU kernels
of ``tools/perf_probe.py`` run in Pallas interpret mode on the CPU.

The probes pass ``interpret=False`` literally, so the fixtures swap the
module's ``pl`` for a copy whose ``pallas_call`` forces ``interpret=True``
(``tests/torch_cases.py::interpreted_tool``); nothing under ``tools/``
changes. The pipelined walks (``decode_pipe``, ``decode_pipe2``) are held
against the kernels of ``tools/perf_probe_r4.py`` the same way. The TPU word
variants cut a row at ``owc * 4 - 1024``
bytes rather than at ``out_cap``, so the shapes here keep ``out_cap + 1024``
a multiple of 4096, where the two agree; every compressed row keeps 8 bytes
of room past its length, where the TPU kernels' window never clamps.
Comparisons are exact; bytes past ``out_len`` are unspecified and never
compared.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.ops.cuda import decode_variants as dv
from snappier_tpu_torch.ops.cuda.scalar_codec import decode_blocks_bytes, decode_blocks_plain
from tests.torch_cases import (
    PIPE_CASES,
    corrupt_streams,
    empty_literal_streams,
    interpreted_tool,
    pack_streams,
    tag_sweep_sample,
    walk_streams,
)

CC, OUT_CAP = 4096, 3072  # OUT_CAP + 1024 is a multiple of 4096
WRAPPERS = {"v2": dv.decode_v2, "v4": dv.decode_v4, "v3": dv.decode_v3}


@pytest.fixture(scope="module")
def probe():
    """``tools/perf_probe.py`` with its kernels in interpret mode."""
    with interpreted_tool("perf_probe") as mod:
        yield mod


@pytest.fixture(scope="module")
def probe_r4():
    """``tools/perf_probe_r4.py`` with its kernels in interpret mode."""
    with interpreted_tool("perf_probe_r4") as mod:
        yield mod


def _reference(probe, variant, comp, lens, out_cap):
    if variant in WRAPPERS:
        fn = getattr(probe, f"decode_{variant}")
        res = fn(jnp.asarray(comp), jnp.asarray(lens), out_cap)
    else:
        res = probe.decode_variant(jnp.asarray(comp), jnp.asarray(lens), out_cap, variant)
    return [np.asarray(x) for x in res]


def _port(variant, comp, lens, out_cap):
    c, n = torch.from_numpy(comp), torch.from_numpy(lens)  # int32 rows, as the JAX side takes
    if variant in WRAPPERS:
        res = WRAPPERS[variant](c, n, out_cap)
    else:
        res = dv.decode_variant(c, n, out_cap, variant)
    return [x.numpy() for x in res]


@pytest.mark.parametrize("garbage", [None, 5], ids=["zero_tail", "garbage_tail"])
@pytest.mark.parametrize("variant", ["v2", "v4", "v3", "v1", "v1nock", "v1nocp"])
def test_plain_matches_interpreted_tpu_kernel(probe, variant, garbage):
    valid = walk_streams()
    streams = valid + ([] if variant == "v1nock" else corrupt_streams())
    comp, lens = pack_streams(streams, CC, garbage_seed=garbage)
    want = _reference(probe, variant, comp, lens, OUT_CAP)
    got = _port(variant, comp, lens, OUT_CAP)
    assert got[0].dtype == np.uint8 and got[0].shape == (len(streams), OUT_CAP)
    assert (got[2] == want[2]).all(), (got[2].tolist(), want[2].tolist())
    assert (got[1] == want[1]).all()
    assert not got[2][: len(valid)].any()
    if variant != "v1nock":
        assert {1, 2, 4, 8} <= set(got[2].tolist())  # the separate error words
        assert not got[1][got[2] != 0].any()  # out_len is 0 on any error
    if variant != "v1nocp":
        for i in range(len(streams)):
            assert (got[0][i, : got[1][i]] == want[0][i, : want[1][i]]).all(), i


def test_plain_matches_interpreted_tpu_kernel_on_the_tag_sweep(probe):
    """Every 23rd stream of the exhaustive tag-byte sweep through one word
    variant and the byte variant."""
    streams = tag_sweep_sample()
    comp, lens = pack_streams(streams, CC, garbage_seed=None)
    for variant in ("v3", "v1"):
        want = _reference(probe, variant, comp, lens, OUT_CAP)
        got = _port(variant, comp, lens, OUT_CAP)
        assert (got[2] == want[2]).all() and (got[1] == want[1]).all()
        for i in range(len(streams)):
            assert (got[0][i, : got[1][i]] == want[0][i, : want[1][i]]).all(), i


@pytest.mark.parametrize("variant", ["v2", "v4", "v3", "v1", "v1nock"])
def test_variants_match_production_decode_on_valid_input(variant):
    """On valid blocks every full variant gives the production decoder's
    rows (its plain version's) and the plaintext."""
    streams = walk_streams(big=65536)
    comp, lens = pack_streams(streams, 68608)
    got = _port(variant, comp, lens, 65536)
    c8 = torch.from_numpy(comp.astype(np.uint8))
    k1 = [x.numpy() for x in decode_blocks_plain(c8, torch.from_numpy(lens), 65536)]
    assert not got[2].any() and not k1[2].any() and (got[1] == k1[1]).all()
    for i, s in enumerate(streams):
        assert (got[0][i, : got[1][i]] == k1[0][i, : k1[1][i]]).all(), i
        assert got[0][i, : got[1][i]].tobytes() == oracle.decompress(s), i


def test_variant_errors_against_production_decode():
    """The variants reject exactly the blocks the production decoder rejects,
    by their own words: 8 where it says 8, one of 1, 2, 4 where it says its
    combined 7 or 4."""
    streams = corrupt_streams()
    comp, lens = pack_streams(streams, 2048)
    got = _port("v2", comp, lens, 1024)
    k1 = decode_blocks_plain(torch.from_numpy(comp.astype(np.uint8)), torch.from_numpy(lens), 1024)
    k1_err = k1[2].numpy()
    assert ((got[2] == 0) == (k1_err == 0)).all()
    assert ((got[2] == 8) == (k1_err == 8)).all()
    assert set(got[2][(k1_err == 7) | (k1_err == 4)].tolist()) <= {1, 2, 4}
    nocp = _port("v1nocp", comp, lens, 1024)
    assert (nocp[1] == got[1]).all() and (nocp[2] == got[2]).all() and not nocp[0].any()


def test_wrapper_argument_checks():
    comp = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.tensor([3, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown variant"):
        dv.decode_variant(comp, lens, 64, "v9")
    with pytest.raises(ValueError, match="unknown variant"):
        dv.decode_variant(comp, lens, 64, "v2")  # has a wrapper of its own
    with pytest.raises(ValueError, match="shared memory"):
        dv.decode_v2(comp, lens, 240000)  # the image alone passes MAX_OUT_CAP
    cap = 229248  # the image and the static 3,200 bytes fit; with v1's 128 of slack not
    assert dv.decode_v2(comp, lens, cap)[2].tolist() == [4, 4]
    with pytest.raises(ValueError, match="shared memory"):
        dv.decode_variant(comp, lens, cap, "v1")
    # A row of any width decodes: the row is not staged in shared memory.
    wide = torch.zeros((1, 200000), dtype=torch.uint8)
    wide[0, :7] = torch.tensor(list(bytes([5, 4 << 2]) + b"hello"), dtype=torch.uint8)
    got = dv.decode_v2(wide, torch.tensor([7], dtype=torch.int32), 65536)
    want = dv.decode_variant_plain(wide, torch.tensor([7], dtype=torch.int32), 65536, "v2")
    assert got[1].tolist() == want[1].tolist() == [5] and got[2].tolist() == [0]
    assert bytes(got[0][0, :5].tolist()) == bytes(want[0][0, :5].tolist()) == b"hello"
    with pytest.raises(ValueError):
        dv.decode_v3(comp, lens[:1], 64)
    with pytest.raises(ValueError):
        dv.decode_v4(comp.float(), lens, 64)
    # Lengths outside the row are taken as 0 or the row's width.
    out = dv.decode_v2(comp, torch.tensor([-4, 1000], dtype=torch.int32), 64)
    assert out[2].tolist() == [8, 4] and out[1].tolist() == [0, 0]


def _pipe_port(name, comp, lens, out_cap, kw):
    c, n = torch.from_numpy(comp), torch.from_numpy(lens)
    res = dv.decode_pipe(c, n, out_cap) if name == "pipe" else dv.decode_pipe2(c, n, out_cap, **kw)
    return [x.numpy() for x in res]


@pytest.mark.parametrize("garbage", [None, 5], ids=["zero_tail", "garbage_tail"])
@pytest.mark.parametrize("case", PIPE_CASES, ids=[c[0] for c in PIPE_CASES])
def test_pipe_plain_matches_interpreted_tpu_kernel(probe_r4, case, garbage):
    """``decode_pipe`` and ``decode_pipe2`` at every unroll, with ``unc``,
    ``dma_pipe`` and ``emit=False``, on valid, edge and corrupt blocks and a
    sample of the tag sweep: the TPU kernel's error words, lengths and bytes
    below each length (none compared without emission)."""
    name, kw = case
    valid = walk_streams()
    empty = empty_literal_streams()
    streams = valid + corrupt_streams() + tag_sweep_sample(97) + empty
    comp, lens = pack_streams(streams, CC, garbage_seed=garbage)
    fn = probe_r4.decode_pipe if name == "pipe" else probe_r4.decode_pipe2
    want = [np.asarray(x) for x in fn(jnp.asarray(comp), jnp.asarray(lens), OUT_CAP, **kw)]
    got = _pipe_port(name, comp, lens, OUT_CAP, kw)
    assert got[0].dtype == np.uint8 and got[0].shape == (len(streams), OUT_CAP)
    assert (got[2] == want[2]).all(), (got[2].tolist(), want[2].tolist())
    assert (got[1] == want[1]).all()
    assert not got[2][: len(valid)].any()
    assert set(got[2].tolist()) == {0, 4, 7, 8}  # the production kernel's words
    assert not got[1][got[2] != 0].any()  # out_len is 0 on any error
    # decode_pipe refuses a literal of no bytes, decode_pipe2 takes it.
    assert got[2][-len(empty):].tolist() == [7 if name == "pipe" else 0] * len(empty)
    if kw.get("emit", True):
        for i in range(len(streams)):
            assert (got[0][i, : got[1][i]] == want[0][i, : want[1][i]]).all(), i


@pytest.mark.parametrize("fold", [False, True], ids=["pipe", "pipe2"])
def test_pipe_matches_production_decode(fold):
    """On valid blocks (one of 64 KiB among them) the pipelined walks give
    the production decoder's rows; on corrupt blocks its error words, but for
    ``decode_pipe2``'s literal of no bytes."""
    streams = walk_streams(big=65536)
    comp, lens = pack_streams(streams, 68608)
    c8, n = torch.from_numpy(comp.astype(np.uint8)), torch.from_numpy(lens)
    got = [x.numpy() for x in dv.decode_pipe_plain(c8, n, 65536, fold)]
    k1 = [x.numpy() for x in decode_blocks_plain(c8, n, 65536)]
    assert not got[2].any() and (got[1] == k1[1]).all()
    for i, s in enumerate(streams):
        assert got[0][i, : got[1][i]].tobytes() == oracle.decompress(s), i
    empty_literal = bytes([0xFC, 0xFF, 0xFF, 0xFF, 0xFF])
    bad = corrupt_streams() + [bytes([4]) + empty_literal + bytes([3 << 2]) + b"abcd"]
    comp, lens = pack_streams(bad, 2048)
    c8, n = torch.from_numpy(comp.astype(np.uint8)), torch.from_numpy(lens)
    got = [x.numpy() for x in dv.decode_pipe_plain(c8, n, 1024, fold)]
    k1 = [x.numpy() for x in decode_blocks_plain(c8, n, 1024)]
    same = np.array([not fold or empty_literal not in s for s in bad])
    assert same.sum() >= len(bad) - 2
    assert (got[2][same] == k1[2][same]).all() and (got[1][same] == k1[1][same]).all()
    assert k1[2][-1] == 7 and got[2][-1] == (0 if fold else 7)
    assert got[1][-1] == (4 if fold else 0)


def _holds_empty_literal(stream: bytes) -> bool:
    """Whether the tag chain of a block (its preamble skipped, the tags
    followed by their lengths, unchecked) holds a literal whose 4-byte
    length field is 0xFFFFFFFF."""
    ip = 1 + next((i for i, b in enumerate(stream[:5]) if b < 0x80), 4)
    while ip < len(stream):
        tag = stream[ip]
        if tag & 3:
            ip += (0, 2, 3, 5)[tag & 3]
            continue
        extra = max((tag >> 2) - 59, 0)
        field = int.from_bytes(stream[ip + 1 : ip + 1 + extra], "little")
        if extra == 4 and field == 0xFFFFFFFF:
            return True
        ip += 1 + extra + (field + 1 if extra else (tag >> 2) + 1)
    return False


@pytest.mark.parametrize("fold", [False, True], ids=["pipe", "pipe2"])
def test_pipe_triple_matches_decode_blocks_bytes(fold):
    """``decode_pipe`` computes the production decoder's function: its
    triple equals ``decode_blocks_bytes``' on valid, edge and corrupt blocks
    and blocks holding a literal of no bytes, error words included;
    ``decode_pipe2``'s equals it on every row whose tags hold no such
    literal, and it decodes the blocks built around one, which the
    production decoder refuses (error 7)."""
    built = empty_literal_streams()
    streams = walk_streams() + corrupt_streams() + built
    comp, lens = pack_streams(streams, CC)
    c8, n = torch.from_numpy(comp.astype(np.uint8)), torch.from_numpy(lens)
    fn = dv.decode_pipe2 if fold else dv.decode_pipe
    got = [x.numpy() for x in fn(c8, n, OUT_CAP)]
    k1 = [x.numpy() for x in decode_blocks_bytes(c8, n, OUT_CAP)]
    holds = np.array([_holds_empty_literal(s) for s in streams])
    assert holds[-len(built):].all() and holds.sum() > len(built)  # corrupt rows hold some
    empty = holds & fold
    assert (got[2][~empty] == k1[2][~empty]).all(), (got[2].tolist(), k1[2].tolist())
    assert (got[1][~empty] == k1[1][~empty]).all()
    for i in np.flatnonzero(~empty):
        assert (got[0][i, : got[1][i]] == k1[0][i, : k1[1][i]]).all(), i
    assert set(k1[2].tolist()) == {0, 4, 7, 8}
    assert (k1[2][holds] == 7).all()
    if fold:
        assert not got[2][-len(built):].any()


def test_pipe_wrapper_argument_checks():
    comp = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.tensor([3, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="unroll"):
        dv.decode_pipe2(comp, lens, 64, unroll=5)
    with pytest.raises(ValueError, match="unc"):
        dv.decode_pipe2(comp, lens, 64, unc=3)
    with pytest.raises(ValueError, match="shared memory"):
        dv.decode_pipe(comp, lens, 240000)
    # The row is never staged: a wide row fits, only the output image counts.
    wide = dv.decode_pipe(torch.zeros((1, 200000), dtype=torch.uint8), lens[:1], 65536)
    assert wide[2].tolist() == [7]
    # Lengths outside the row are taken as 0 or the row's width.
    out = dv.decode_pipe(comp, torch.tensor([-4, 1000], dtype=torch.int32), 64)
    assert out[2].tolist() == [8, 7] and out[1].tolist() == [0, 0]
    comp[:, 0] = 2
    out = dv.decode_pipe2(comp, lens + 2, 64, unroll=4, emit=False)  # two literals of 1 byte
    assert out[2].tolist() == [0, 0] and out[1].tolist() == [2, 2] and not out[0].any()
