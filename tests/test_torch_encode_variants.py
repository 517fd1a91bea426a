"""The plain versions of the encode-walk ablation
(``snappier_tpu_torch/ops/cuda/encode_variants.py``) against the TPU kernels
of ``tools/perf_probe_enc.py`` (``encode_variant``) and
``tools/perf_probe_r4.py`` (``encode_r4``, ``encode_stats``) run in Pallas
interpret mode on the CPU (``tests/torch_cases.py::interpreted_tool``).

Comparisons are exact: ``body_lens`` always, and the bytes below each length
where the variant emits; bytes past a length are unspecified and never
compared. Every emitting variant is also decoded back to its input.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappier_tpu_torch.format import oracle
from snappier_tpu_torch.format.varint import write_varint
from snappier_tpu_torch.ops.cuda import encode_variants as ev
from snappier_tpu_torch.ops.cuda.scalar_codec import HASH_BITS, encode_blocks_plain
from tests.torch_cases import encode_rows, html_like, interpreted_tool

F = 2048
ROWS = [0, 1, 2, 3, 4, 6, 10, 11, 12, 13, 14, 15]  # markup, random, zeros, periods, short rows


@pytest.fixture(scope="module")
def probe_enc():
    with interpreted_tool("perf_probe_enc") as mod:
        yield mod


@pytest.fixture(scope="module")
def probe_r4():
    with interpreted_tool("perf_probe_r4") as mod:
        yield mod


def _rows():
    frags, lens = encode_rows(F)
    return frags[ROWS], lens[ROWS]


def _check(want, got, frags, lens, emits: bool):
    want_b, want_l = np.asarray(want[0]), np.asarray(want[1])
    got_b, got_l = got[0].numpy(), got[1].numpy()
    assert got_b.dtype == np.uint8 and got_b.shape == (len(lens), F + 2048)
    assert (got_l == want_l).all(), (got_l.tolist(), want_l.tolist())
    if not emits:
        return
    for i, n in enumerate(lens):
        assert (got_b[i, : got_l[i]] == want_b[i, : want_l[i]]).all(), i
        block = write_varint(int(n)) + got_b[i, : got_l[i]].tobytes()
        assert oracle.decompress(np.frombuffer(block, np.uint8)) == \
            frags[i, :n].astype(np.uint8).tobytes(), i


def _port(fn, frags, lens, arg):
    return fn(torch.from_numpy(frags), torch.from_numpy(lens), arg)  # int32 rows, as JAX takes


@pytest.mark.parametrize("name", list(ev.VARIANT_FLAGS))
def test_encode_variant_plain_matches_interpreted_tpu_kernel(probe_enc, name):
    flags = ev.VARIANT_FLAGS[name]
    assert flags == probe_enc.VARIANT_FLAGS[name]
    frags, lens = _rows()
    want = probe_enc.encode_variant(jnp.asarray(frags), jnp.asarray(lens), flags)
    _check(want, _port(ev.encode_variant, frags, lens, flags), frags, lens, "noemit" not in flags)


@pytest.mark.parametrize("flags", [(), ("probe8",), ("merged", "adv4", "st1"),
                                   ("ext8", "merged", "hb12"), ("probe8", "st8", "bcopy")],
                         ids=lambda f: "-".join(f) or "none")
def test_encode_variant_other_tuples_match(probe_enc, flags):
    """Tuples that no name has, the empty one among them."""
    frags, lens = _rows()
    want = probe_enc.encode_variant(jnp.asarray(frags), jnp.asarray(lens), flags)
    _check(want, _port(ev.encode_variant, frags, lens, flags), frags, lens, True)


@pytest.mark.parametrize("name", list(ev.R4_VARIANTS))
def test_encode_r4_plain_matches_interpreted_tpu_kernel(probe_r4, name):
    frags, lens = _rows()
    want = probe_r4.encode_r4(jnp.asarray(frags), jnp.asarray(lens), variant=name)
    _check(want, _port(ev.encode_r4, frags, lens, name), frags, lens, name not in ev.R4_NO_BYTES)


def test_r4_production_bytes_and_shared_walks():
    """The variants named as giving the production encoder's bytes do, on
    64 KiB of markup too; the others that emit are other valid encodings;
    ``encnoemit`` counts its own walk's lengths."""
    frags = np.stack([html_like(65536, 9), html_like(65536, 10)]).astype(np.uint8)
    frags[1, 30000:] = np.random.default_rng(2).integers(0, 256, 35536)
    f8, n = torch.from_numpy(frags), torch.tensor([65536, 65531], dtype=torch.int32)
    k2_b, k2_l = (x.numpy() for x in encode_blocks_plain(f8, n, HASH_BITS, 32))
    lens = {}
    for name in ("encr4", "encext8u", "encwhen8", "enccopywhen", "encnoemit", "encext16u"):
        b, l = (x.numpy() for x in ev.encode_r4_plain(f8, n, name))
        lens[name] = l
        if name in ev.R4_PRODUCTION_BYTES:
            assert (l == k2_l).all()
            for i in range(2):
                assert (b[i, : l[i]] == k2_b[i, : l[i]]).all()
        elif name not in ev.R4_NO_BYTES:
            for i in range(2):
                block = write_varint(int(n[i])) + b[i, : l[i]].tobytes()
                assert oracle.decompress(np.frombuffer(block, np.uint8)) == \
                    frags[i, : n[i]].tobytes()
    assert (lens["encnoemit"] == lens["enccopywhen"]).all()
    assert (lens["encext16u"] != k2_l).any()  # another encoding, not production's
    assert set(ev.R4_PRODUCTION_BYTES) == {
        k for k, m in ev.R4_VARIANTS.items()
        if m & ev.EXT_MASK == ev.EXT_8U and not m & ev.OCT}


def test_wrapper_argument_checks():
    frags = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.tensor([64, 64], dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown flag"):
        ev.encode_variant(frags, lens, ("merged", "fast"))
    with pytest.raises(ValueError, match="hbN"):
        ev.encode_variant(frags, lens, ("hb15",))
    with pytest.raises(ValueError, match="stN"):
        ev.encode_variant(frags, lens, ("st0",))
    with pytest.raises(ValueError, match="unknown variant"):
        ev.encode_r4(frags, lens, "encbase")
    with pytest.raises(ValueError, match="fragment width"):
        ev.encode_r4(torch.zeros((1, 70000), dtype=torch.uint8), lens[:1])
    with pytest.raises(ValueError):
        ev.encode_variant(frags.float(), lens, ())
    # Lengths outside the row are taken as 0 or the row's width.
    _, got = ev.encode_r4(frags, torch.tensor([-3, 900], dtype=torch.int32), "encdmaonly")
    assert got.tolist() == [0, 64]
    _, got = ev.encode_variant(frags, lens, ev.VARIANT_FLAGS["edma"])
    assert got.tolist() == [0, 0]
    assert ev.flags_mask(ev.VARIANT_FLAGS["e7"])[2] == 2  # 4 stores over 8 positions


def test_encode_stats_plain_matches_interpreted_tpu_kernel(probe_r4):
    """The encoder's budget, int32 [B, 4], on every row of ``encode_rows``
    (markup, random, zeros, periods 1-7, rows of 1-40 bytes), garbage past
    each length."""
    frags, lens = encode_rows(F)
    want = np.asarray(probe_r4.encode_stats(jnp.asarray(frags), jnp.asarray(lens)))
    got = ev.encode_stats(torch.from_numpy(frags), torch.from_numpy(lens))
    assert got.dtype == torch.int32 and got.shape == (len(lens), 4)
    assert (got.numpy() == want).all(), (got.tolist(), want.tolist())
    assert want[:, 0].any() and want[:, 1].any() and want[:, 2].any()


def test_encode_stats_counts_its_walk():
    """Two per hit is what the same walk counts without stats, and the
    matches cover no more than the fragment, on 64 KiB rows."""
    frags = np.stack([html_like(65536, 9), np.zeros(65536, np.uint8)])
    f8, n = torch.from_numpy(frags), torch.tensor([65536, 40000], dtype=torch.int32)
    st = ev.encode_stats(f8, n).numpy()
    _, hits2 = ev.encode_walk_plain(f8, n, ev.STATS_MASK, HASH_BITS, 1)
    assert (hits2.numpy() == 2 * st[:, 1]).all()
    assert (st[:, 3] <= n.numpy()).all() and st[1, 3] > 39000
    assert (st[:, 2] >= (st[:, 3] - 7 * st[:, 1]) // 4).all()  # a step per 4 bytes past the first


def test_encode_stats_argument_checks_and_tool_without_a_card():
    """``tools/torch_perf_probe_r4.py encstats`` exits 2 without a card and
    times nothing."""
    with pytest.raises(ValueError, match="fragment width"):
        ev.encode_stats(torch.zeros((1, 70000), dtype=torch.uint8), torch.tensor([5]))
    with pytest.raises(ValueError):
        ev.encode_stats(torch.zeros((2, 64)), torch.tensor([5, 5]))
    got = ev.encode_stats(torch.zeros((2, 64), dtype=torch.uint8), torch.tensor([-3, 900]))
    assert got.tolist() == [[0, 0, 0, 0], [0, 1, 14, 62]]  # lengths taken as 0 and 64
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    import pathlib
    import subprocess
    import sys

    tool = pathlib.Path(__file__).resolve().parents[1] / "tools" / "torch_perf_probe_r4.py"
    r = subprocess.run([sys.executable, str(tool), "4", "encstats"], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 2 and "no CUDA device" in r.stderr and not r.stdout
