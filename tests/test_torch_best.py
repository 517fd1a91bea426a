"""Parity of the port's ``level="best"`` pieces and match-extension probe
with the JAX package: ``exact_candidates`` against
``snappier_tpu.ops.best_match``, the best-mode walk (the plain version of
``csrc/encode_best.cu``) against ``_encode_best_pallas`` in Pallas interpret
mode, and the probe (the plain version of ``csrc/probe.cu``) against
``match_extension_probe`` in interpret mode on the FindMatchLength golden
vectors. The same numpy inputs go to both sides; tolerance is exact
equality.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappier_tpu.ops.best_match import exact_candidates as jax_exact_candidates
from snappier_tpu.ops.pallas.scalar_codec import (
    _encode_best_pallas,
    encode_blocks_best as jax_encode_blocks_best,
    match_extension_probe as jax_probe,
)
from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.ops import best_match
from snappier_tpu_torch.ops.best_match import DEFAULT_WIDTHS, exact_candidates
from snappier_tpu_torch.ops.cuda import _build
from snappier_tpu_torch.ops.cuda.scalar_codec import (
    _encode_best,
    encode_blocks_best,
    encode_blocks_scalar,
    match_extension_probe,
)
from tests.test_match_length import VECTORS, _layout
from tests.torch_cases import best_rows, block_stream, html_like, planted_matches


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def rows():
    return best_rows()


@pytest.mark.parametrize("widths", [DEFAULT_WIDTHS, (4,), (4, 16)])
def test_exact_candidates_match_jax(rows, widths):
    frags, lens = rows
    ref = np.asarray(jax_exact_candidates(jnp.asarray(frags), jnp.asarray(lens), widths=widths))
    got = exact_candidates(_t(frags), _t(lens), widths)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert (got.numpy() == ref).all()
    pos = np.arange(frags.shape[1])[None, :]
    assert (got.numpy() < pos).all()  # a candidate lies before its position


def test_exact_candidates_reject_bad_ladders():
    f, n = torch.zeros((1, 64), dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    for widths in [(8, 16), (4, 12), ()]:
        with pytest.raises(ValueError):
            exact_candidates(f, n, widths)


@pytest.mark.parametrize("widths, mask", [
    (DEFAULT_WIDTHS, 0b11111100),
    ((4,), 0b100),
    ((4, 8, 16, 32, 64, 128, 256), 0b111111100),
    ((128, 4, 4, 8), 0b10001100),  # any order, repeats once
    ((4, 1 << 30, 1 << 31, 1 << 40), 0b100 | 1 << 30),  # past 2**30 no position
])
def test_widths_mask_encodes_the_ladder(widths, mask):
    """The kernel's ladder: bit k for width 2**k."""
    assert best_match.widths_mask(widths) == mask


def test_exact_candidates_checks_its_arguments():
    """Refused before any device work, on the CPU as on the card: bad
    ladders, frags that are not [B, F] uint8 or int32, lengths not [B]
    integers, rows wider than the kernel's 65,536; and the kernel's
    fallback counter and layout query take only what they can use."""
    f, n = torch.zeros((2, 64), dtype=torch.uint8), torch.zeros(2, dtype=torch.int32)
    bad = [
        (f, n, (8, 16)), (f, n, (4, 12)), (f, n, ()), (f, n, (4, 0)),
        (f[0], n, DEFAULT_WIDTHS),  # not 2-D
        (f.to(torch.float32), n, DEFAULT_WIDTHS), (f.to(torch.int64), n, DEFAULT_WIDTHS),
        (f, n[:1], DEFAULT_WIDTHS), (f, n.to(torch.float32), DEFAULT_WIDTHS),
        (f, n.bool(), DEFAULT_WIDTHS), (f, [0, 0], DEFAULT_WIDTHS),
        (torch.zeros((1, best_match.MAX_WIDTH + 1), dtype=torch.uint8), n[:1], DEFAULT_WIDTHS),
    ]
    for frags, lengths, widths in bad:
        with pytest.raises(ValueError):
            exact_candidates(frags, lengths, widths)
    with pytest.raises(ValueError):
        best_match.launch_candidates(f, n, DEFAULT_WIDTHS, torch.zeros(2, dtype=torch.int32))
    for F, dev in ((0, "cuda"), (best_match.MAX_WIDTH + 1, "cuda"), (4096, "cpu")):
        with pytest.raises(ValueError):
            best_match.candidates_layout(F, dev)
    # the widest row the kernel takes, and one of no bytes, pass the checks
    wide = torch.zeros((1, best_match.MAX_WIDTH), dtype=torch.uint8)
    assert (exact_candidates(wide, n[:1], (4,)) == -1).all()
    assert exact_candidates(torch.zeros((2, 0), dtype=torch.int32), n).shape == (2, 0)


def test_best_walk_matches_jax_on_same_candidates(rows):
    frags, lens = rows
    cands = np.asarray(jax_exact_candidates(jnp.asarray(frags), jnp.asarray(lens)))
    ref_b, ref_l = (np.asarray(x) for x in _encode_best_pallas(
        jnp.asarray(frags), jnp.asarray(lens), jnp.asarray(cands), interpret=True))
    _build.reset_launches()
    bodies, body_lens = _encode_best(_t(frags), _t(lens), _t(cands))
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: the plain walk
    assert bodies.dtype == torch.uint8 and body_lens.dtype == torch.int32
    bodies, body_lens = bodies.numpy(), body_lens.numpy()
    assert (body_lens == ref_l).all(), (body_lens, ref_l)
    for i, n in enumerate(lens):
        assert (bodies[i, : body_lens[i]] == ref_b[i, : ref_l[i]]).all(), i
        assert oracle.decompress(block_stream(n, bodies[i, : body_lens[i]])) == (
            frags[i, :n].astype(np.uint8).tobytes()), i


def test_best_walk_treats_out_of_range_candidates_as_none():
    frags = np.stack([html_like(2048, 4)]).astype(np.int32)
    lens = np.array([2048], np.int32)
    none = np.full((1, 2048), -1, np.int32)
    late = np.tile(np.arange(2048, dtype=np.int32) + 1, (1, 1))  # every cand >= i
    a = _encode_best(_t(frags), _t(lens), _t(none))
    b = _encode_best(_t(frags), _t(lens), _t(late))
    assert int(a[1][0]) == int(b[1][0]) == 2048 + 3  # one literal
    assert (a[0] == b[0]).all()


@pytest.mark.parametrize("F", [1024, 4096])
def test_encode_blocks_best_matches_jax(F):
    frags, lens = best_rows(F, seed=5, lens=(F, F - 7, 40))
    frags, lens = frags[::2], lens[::2]  # a handful of rows of every kind
    ref_b, ref_l = (np.asarray(x) for x in jax_encode_blocks_best(
        jnp.asarray(frags), jnp.asarray(lens), interpret=True))
    bodies, body_lens = encode_blocks_best(_t(frags), _t(lens))
    assert bodies.dtype == torch.int32 and bodies.shape == ref_b.shape
    assert (body_lens.numpy() == ref_l).all()
    for i in range(len(lens)):
        assert (bodies.numpy()[i, : ref_l[i]] == ref_b[i, : ref_l[i]]).all(), i


def test_best_is_no_larger_than_fast_on_markup():
    F = 4096
    frags = np.stack([html_like(F, s) for s in range(4)]).astype(np.int32)
    lens = np.full(4, F, np.int32)
    _, best_l = encode_blocks_best(_t(frags), _t(lens))
    _, fast_l = encode_blocks_scalar(_t(frags), _t(lens))
    assert (best_l <= fast_l).all(), (best_l, fast_l)
    assert int(best_l.sum()) < int(fast_l.sum())


def _golden_rows():
    rows, ats, ns, expects = [], [], [], []
    for expected, s1, s2, length in VECTORS:
        if expected < 4:  # the walk runs only after a verified 4-byte seed
            continue
        buf, at, n = _layout(s1, s2, length)
        row = np.zeros(1024, np.int32)
        row[: len(buf)] = np.frombuffer(buf, np.uint8)
        rows.append(row)
        ats.append(at)
        ns.append(n)
        expects.append(expected)
    return (np.stack(rows), np.array(ats, np.int32), np.zeros(len(ats), np.int32),
            np.array(ns, np.int32), np.array(expects, np.int32))


def test_probe_matches_jax_on_golden_vectors():
    bufs, ats, cands, ns, expects = _golden_rows()
    ref = np.asarray(jax_probe(jnp.asarray(bufs), ats, cands, ns, interpret=True))
    got = match_extension_probe(_t(bufs), _t(ats), _t(cands), _t(ns))
    assert got.dtype == torch.int32
    assert (got.numpy() == ref).all(), (got, ref)
    assert (got.numpy() == expects).all()


def test_probe_matches_jax_on_planted_matches():
    bufs, ats, cands, ns, planted = planted_matches(24, 8192)
    ref = np.asarray(jax_probe(jnp.asarray(bufs.astype(np.int32)), ats, cands, ns,
                               interpret=True))
    got = match_extension_probe(_t(bufs), _t(ats), _t(cands), _t(ns)).numpy()
    assert (got == ref).all(), (got, ref)
    assert (got == planted).all()


def test_probe_clamps_its_arguments():
    """Rows outside the precondition give a bounded walk that never reads
    past the row (a narrow row, n past its end, a negative position)."""
    bufs = torch.zeros((3, 16), dtype=torch.uint8)
    got = match_extension_probe(bufs, torch.tensor([4, -5, 8]), torch.tensor([0, 0, 99]),
                                torch.tensor([1 << 30, 16, 12]))
    assert got.tolist() == [12, 16, 4]
