"""The port's fuzz tool (``tools/torch_fuzz.py``) on the CPU.

Each campaign runs at a tiny volume on ``device="cpu"`` (the kernels' plain
versions). The tool's generators are held to the JAX tools' (``gen_block``
and ``size_for`` of ``tools/fuzz_host.py``) and to their mutation kinds, its
verdicts to the JAX package's oracle on the same mutants, and planted bugs
in the decoder show that its comparisons catch a wrong byte and a wrong
verdict. The full volumes are ``tests/test_torch_fuzz_campaigns.py`` (slow)
and, on the card, ``tests/test_torch_cuda.py -k fuzz``.
"""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from snappier_tpu.errors import InvalidDataError as JaxInvalidDataError
from snappier_tpu.format import oracle as jax_oracle
from snappier_tpu.runtime import stream as jax_stream

_TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, _TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fuzz():
    return _load("torch_fuzz")


# name -> (volume, keyword arguments): a few rows of each campaign.
TINY = {
    "roundtrip": (6, dict(batch=3)),
    "corrupt": (48, dict(batch=20)),
    "scalar": (24, dict(batch=8)),
    "facade": (2, {}),
    "device-stream": (1, dict(mutants_per_iter=16)),
    "native": (12, {}),
    "stream": (6, {}),
}


@pytest.mark.parametrize("name", list(TINY))
def test_campaign_exact_on_cpu(fuzz, name):
    volume, kw = TINY[name]
    r = fuzz.RUNNERS[name](volume, 301, "cpu", **kw)
    assert r["campaign"] == name and r["rows"] >= volume and r["bytes"] > 0
    assert r["launches"] == {}  # the plain versions launch nothing
    if name == "corrupt":
        assert r["mutants"] == volume and r["valid_rows"] > 0
        assert r["judged"] == volume - r["verdicts"].get("capped", 0)  # capped: no verdict
        if fuzz.native.available():  # the oracle beside the native engine, every 16th
            assert r["oracle_judged"] == -(-r["judged"] // fuzz.ORACLE_EVERY)
        assert r["verdicts"].get("accepted", 0) and r["verdicts"].get("rejected", 0)
    if name == "device-stream":
        assert r["crc_caught"] == r["kinds"]["literal"] > 0
    if name == "facade":
        assert set(r["by_kernel"]) == {"scalar", "scan"}


def test_generators_are_the_jax_tools(fuzz):
    """The data generators are copies of tools/fuzz_host.py's: the same
    bytes and sizes from the same seed."""
    host = _load("fuzz_host")
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for i in (0, 1, 150, 151):
        assert fuzz.size_for(a, i) == host.size_for(b, i)
        n = 3000
        assert fuzz.gen_block(a, n) == host.gen_block(b, n)


def _bases(fuzz, n: int = 12, seed: int = 9):
    """Valid blocks of each data kind, 1-3,000 bytes."""
    rng = np.random.default_rng(seed)
    return [fuzz.oracle.compress(fuzz.kind_block(rng, k % 5, int(rng.integers(1, 3000))))
            for k in range(n)]


def test_mutations_yield_every_kind(fuzz):
    """Every block mutation kind is drawn and has its shape; every framed
    kind is made."""
    rng = np.random.default_rng(11)
    assert {fuzz.pick_mutation(rng) for _ in range(400)} == set(fuzz.MUTATIONS)
    bases = _bases(fuzz)
    for s in bases:
        pre = fuzz.read_varint(s)[1]
        for kind in fuzz.MUTATIONS:
            m = fuzz.mutate(rng, s, kind)
            if kind == "byteflip":
                diff = np.flatnonzero(np.frombuffer(m, np.uint8) != np.frombuffer(s, np.uint8))
                assert len(m) == len(s) and 1 <= len(diff) <= 3
            elif kind == "bitflip":
                x = np.frombuffer(m, np.uint8) ^ np.frombuffer(s, np.uint8)
                assert len(m) == len(s) and all(bin(v).count("1") <= 7 for v in x)
                assert x.any()
            elif kind == "truncate":
                assert len(m) < len(s) and s.startswith(m)
            elif kind == "wide_literal":
                x = np.flatnonzero(np.frombuffer(m, np.uint8) != np.frombuffer(s, np.uint8))
                assert len(m) == len(s) and len(x) and x.max() - x.min() <= 4
                assert m[int(x.min())] in (0xF0, 0xF4, 0xF8, 0xFC) or x.min() > 0
            elif kind == "wide_insert":
                assert m[:pre] == s[:pre] and m[pre] == 0xFC and m[pre + 5 :] == s[pre:]
            elif kind == "extend":
                assert m.startswith(s) and 1 <= len(m) - len(s) < 40
            else:
                assert 1 <= len(m) < 2000
    framed = fuzz.pstream.stream_compress(b"abc" * 30000 + bytes(range(256)) * 40,
                                          engine="oracle", device="cpu")
    kinds = {k for k, _, _ in fuzz.framed_mutants(rng, framed, 1000)}
    assert kinds == set(fuzz.FRAMED_MUTATIONS)


def _jax_verdict(mb: bytes):
    try:
        return bytes(jax_oracle.decompress(np.frombuffer(mb, np.uint8)))
    except JaxInvalidDataError:
        return None


def test_verdicts_equal_the_jax_oracle(fuzz):
    """The tool's block verdicts (oracle, native engine, and the judge that
    pairs them) equal the JAX package's oracle on the tool's mutants."""
    rng = np.random.default_rng(12)
    run = fuzz._Run("verdicts", 12, torch.device("cpu"))
    bases = _bases(fuzz, 16)
    seen = {True: 0, False: 0}
    for i, s in enumerate(bases):
        for j, kind in enumerate(fuzz.MUTATIONS * 3):
            mb = fuzz.mutate(rng, s, kind)
            want = _jax_verdict(mb)
            assert fuzz.oracle_verdict(mb) == want, (i, kind)
            if fuzz.native.available():
                assert fuzz.native_verdict(mb) == want, (i, kind)
            assert run.judge(mb, i, j) == want, (i, kind)
            seen[want is not None] += 1
    assert seen[True] >= 20 and seen[False] >= 20, seen


def test_framed_verdicts_equal_the_jax_chunk_machine(fuzz):
    """The framed mutants' verdicts through the port's engines (the device
    engine's plain versions, native, oracle) equal the JAX package's chunk
    machine on its oracle engine."""
    rng = np.random.default_rng(13)
    data = fuzz.gen_block(rng, 70000)
    framed = fuzz.pstream.stream_compress(data, engine="oracle", device="cpu")
    engines = ["cuda", "oracle"] + (["native"] if fuzz.native.available() else [])
    for kind, mb, _ in fuzz.framed_mutants(rng, framed, 24):
        try:
            want = jax_stream.stream_decompress(mb, engine="oracle")
        except JaxInvalidDataError:
            want = None
        for e in engines:
            assert fuzz.stream_verdict(mb, e, "cpu") == want, (kind, e)


def _planted(fuzz, monkeypatch, plant: str):
    """Wrap the decoder the campaigns call with a one-row bug."""
    real = fuzz.decode_blocks_bytes

    def buggy(comp, lens, out_cap):
        out, out_lens, errs = real(comp, lens, out_cap)
        ok = (errs == 0) & (out_lens > 0)
        if plant == "byte" and ok.any():
            j = int(torch.nonzero(ok)[0])
            out[j, 0] ^= 1
        if plant == "verdict" and (errs != 0).any():
            errs[int(torch.nonzero(errs != 0)[0])] = 0
        return out, out_lens, errs

    monkeypatch.setattr(fuzz, "decode_blocks_bytes", buggy)


@pytest.mark.parametrize("campaign,plant", [("corrupt", "byte"), ("corrupt", "verdict"),
                                            ("scalar", "byte")])
def test_comparator_has_teeth(fuzz, monkeypatch, tmp_path, campaign, plant):
    """A decoder that flips one accepted byte, or accepts one rejected row,
    is caught, and the tool writes the row's input and exits 1."""
    volume = TINY[campaign][0]
    _planted(fuzz, monkeypatch, plant)
    with pytest.raises(fuzz.Mismatch) as e:
        fuzz.RUNNERS[campaign](volume, 301, "cpu")
    assert e.value.campaign == campaign and e.value.seed == 301 and e.value.data
    monkeypatch.setattr(fuzz, "FAIL_DIR", tmp_path)
    assert fuzz.main(["--device", "cpu", "--campaigns", campaign,
                      f"--{campaign}", str(volume)]) == 1
    (written,) = tmp_path.iterdir()
    assert written.read_bytes() == e.value.data


def test_bigbatch_on_cpu(fuzz):
    """The B=2,048 check's function at a few rows: bodies through the native
    engine, CRCs and the batched decode of the native engine's streams."""
    r = fuzz.bigbatch(B=9, device="cpu")
    assert r["rows"] == 9 and 0 < r["ratio"] < 1.1


def test_tool_needs_a_card_unless_asked_for_the_cpu(fuzz, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuzz.main(["--campaigns", "native", "--native", "1"])
