"""The plain reference: the Python codec, the tensor decoder that decides
``correct``, the control encoder and the traffic generator."""

from __future__ import annotations

import random
import subprocess
import sys

import pytest
import torch

from portbench_tiny import REPO

from portbench import generator
from portbench.reference import control, snappy_plain, snappy_torch

GOLDEN = {"alice29.txt": 88074 / 148481, "html_x_4": 92318 / 409600}  # BASELINE.md


@pytest.fixture(scope="module")
def corpus_rows():
    mix = generator.load_mix("corpus")
    made = generator.files(mix, 7, 1, "cpu")
    rows, lens = generator.fragment_rows(made, mix, snappy_plain.BLOCK_SIZE, 49)
    return mix, made, rows, lens


def _pad_rows(bodies: list[bytes]):
    W = max(1, max(len(b) for b in bodies)) + 3
    comp = torch.zeros((len(bodies), W), dtype=torch.uint8)
    for i, b in enumerate(bodies):
        comp[i, : len(b)] = torch.tensor(list(b), dtype=torch.uint8)
    return comp, torch.tensor([len(b) for b in bodies])


EDGE = [b"", b"a", b"abcd" * 3 + b"abc", b"x" * 16, bytes(65536), bytes(range(256)) * 256,
        b"ab" * 40000, random.Random(3).randbytes(70000)]


@pytest.mark.parametrize("data", EDGE, ids=lambda d: f"{len(d)}B")
def test_plain_round_trip_edges(data):
    comp = snappy_plain.compress(data)
    assert snappy_plain.decompress(comp) == data
    assert len(comp) <= snappy_plain.max_compressed_length(len(data))


def test_plain_round_trip_corpus(corpus_rows):
    _, made, _, _ = corpus_rows
    for name in ("alice29.txt", "fireworks.jpeg", "geo.protodata"):
        data = made[name][0].numpy().tobytes()
        assert snappy_plain.decompress(snappy_plain.compress(data)) == data


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_greedy_ratio_near_golden(corpus_rows, name):
    """The plain greedy encoder on the calibrated stand-ins lands near the
    reference encoder's golden ratio on the real file."""
    _, made, _, _ = corpus_rows
    data = made[name][0].numpy().tobytes()
    assert abs(len(snappy_plain.compress(data)) / len(data) - GOLDEN[name]) < 0.03


def test_tensor_decoder_equals_plain(corpus_rows):
    _, _, rows, lens = corpus_rows
    sel = [0, 2, 4, 9, 20, 48]
    bodies = [snappy_plain.compress_body(rows[i, : lens[i]].numpy().tobytes()) for i in sel]
    comp, bl = _pad_rows(bodies)
    out, ok = snappy_torch.decode_bodies(comp, bl, lens[sel], rows.shape[1])
    assert ok.all()
    for k, i in enumerate(sel):
        assert torch.equal(out[k, : lens[i]], rows[i, : lens[i]])
    assert snappy_torch.check_rows(comp, bl, rows[sel], lens[sel], block_rows=4).all()


def _tags(*parts) -> bytes:
    return b"".join(parts)


# hand-made streams: every tag kind, long literal headers, overlapping copies
HAND = [
    (_tags(bytes([(4 - 1) << 2]) + b"hell", bytes([1, 4])), b"hellhell"),
    (_tags(bytes([0]) + b"a", bytes([((9 - 1) << 2) | 2]) + (1).to_bytes(2, "little")),
     b"a" * 10),
    (_tags(bytes([1 << 2]) + b"ab", bytes([((5 - 1) << 2) | 3]) + (2).to_bytes(4, "little")),
     b"ab" + b"ababa"),
    (_tags(bytes([60 << 2, 99]) + bytes(range(100))), bytes(range(100))),
    (_tags(bytes([61 << 2]) + (299).to_bytes(2, "little") + bytes(300)), bytes(300)),
    (_tags(bytes([62 << 2]) + (69999).to_bytes(3, "little") + b"q" * 70000), b"q" * 70000),
    (_tags(bytes([63 << 2]) + (69999).to_bytes(4, "little") + b"r" * 70000), b"r" * 70000),
]


@pytest.mark.parametrize("k", range(len(HAND)))
def test_tensor_decoder_hand_streams(k):
    body, want = HAND[k]
    assert snappy_plain.decompress_body(body, len(want)) == want
    comp, bl = _pad_rows([body])
    out, ok = snappy_torch.decode_bodies(comp, bl, torch.tensor([len(want)]), len(want) + 8)
    assert ok.all() and bytes(out[0, : len(want)].tolist()) == want


BAD = [
    bytes([(4 - 1) << 2]) + b"abc",  # literal runs past the end
    bytes([0]) + b"a" + bytes([((4 - 1) << 2) | 2, 2, 0]),  # copy reaches before the output
    bytes([0]) + b"a" + bytes([((4 - 1) << 2) | 2, 0, 0]),  # offset 0
    bytes([0]) + b"a" + bytes([1 << 2 | 1]),  # copy header cut short
    bytes([61 << 2, 5]),  # literal length bytes cut short
]


@pytest.mark.parametrize("body", BAD, ids=range(len(BAD)))
def test_tensor_decoder_rejects(body):
    with pytest.raises(snappy_plain.CorruptStream):
        snappy_plain.decompress_body(body, 5)
    comp, bl = _pad_rows([body])
    _, ok = snappy_torch.decode_bodies(comp, bl, torch.tensor([5]), 16)
    assert not ok.any()


def test_tensor_decoder_agrees_on_mutants(corpus_rows):
    """Bit flips, cut streams and overwritten bytes: the tensor decoder
    accepts exactly what the plain walk accepts, with the same output."""
    _, _, rows, lens = corpus_rows
    rng = random.Random(11)
    base = [snappy_plain.compress_body(rows[i, : lens[i]].numpy().tobytes()) for i in (0, 4, 9)]
    mutants, want = [], []
    for t in range(60):
        k = t % 3
        b = bytearray(base[k])
        kind = rng.randrange(3)
        if kind == 0:
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        elif kind == 1:
            del b[len(b) - rng.randrange(1, 6):]
        else:
            b[rng.randrange(len(b))] = rng.randrange(256)
        n = int(lens[(0, 4, 9)[k]])
        try:
            want.append(snappy_plain.decompress_body(bytes(b), n))
        except snappy_plain.CorruptStream:
            want.append(None)
        mutants.append((bytes(b), n))
    comp, bl = _pad_rows([m for m, _ in mutants])
    ns = torch.tensor([n for _, n in mutants])
    out, ok = snappy_torch.decode_bodies(comp, bl, ns, snappy_plain.BLOCK_SIZE)
    for i, w in enumerate(want):
        assert bool(ok[i]) == (w is not None), i
        if w is not None:
            assert bytes(out[i, : ns[i]].tolist()) == w
    assert any(w is None for w in want) and any(w is not None for w in want)


def test_control_encoder(corpus_rows):
    """Exact keys: valid streams within the bound. Keys trusted on a hash:
    streams the check rejects."""
    _, _, rows, lens = corpus_rows
    lens = lens.clone()
    lens[3], lens[5], lens[6], lens[7] = 65533, 10, 0, 1
    bodies, bl = control.chunk_encode(rows, lens, None)
    assert snappy_torch.check_rows(bodies, bl, rows, lens).all()
    assert ((bl + 3) <= 32 + lens + lens // 6).all()
    for i in (0, 3, 5, 6, 7):
        got = snappy_plain.decompress_body(bodies[i, : bl[i]].numpy().tobytes(), int(lens[i]))
        assert got == rows[i, : lens[i]].numpy().tobytes()
    bodies, bl = control.chunk_encode(rows, lens, 16)
    assert not snappy_torch.check_rows(bodies, bl, rows, lens).all()


def test_generator_is_seeded(corpus_rows):
    mix, made, _, _ = corpus_rows
    again = generator.files(mix, 7, 1, "cpu")
    other = generator.files(mix, 8, 1, "cpu")
    for f in mix["files"]:
        assert torch.equal(made[f["name"]], again[f["name"]])
        assert made[f["name"]].shape == (1, f["length"]) == other[f["name"]].shape
        assert not torch.equal(made[f["name"]], other[f["name"]])
    assert torch.equal(made["html_x_4"][0, :102400], made["html"][0])
    assert generator.rows_per_copy(mix, snappy_plain.BLOCK_SIZE) == 49


def test_fragment_rows_and_concatenation(corpus_rows):
    mix, made, rows, lens = corpus_rows
    flat = generator.concatenated(made, mix)
    assert len(flat) == int(lens.sum()) == sum(f["length"] for f in mix["files"])
    joined = torch.cat([rows[i, : lens[i]] for i in range(len(lens))])
    assert torch.equal(joined, flat)
    col = torch.arange(rows.shape[1])[None, :]
    assert not rows[col >= lens[:, None]].any()


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.snappy_plain, portbench.reference.snappy_torch\n"
            "import portbench.reference.control, portbench.generator\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('snappier_tpu_torch', 'snappier_tpu', 'jax', 'jaxlib', 'flax')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n") % str(REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
