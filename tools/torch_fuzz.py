#!/usr/bin/env python3
"""Seeded fuzz campaigns of the PyTorch/CUDA port, on its device path.

The port's twin of ``tools/fuzz_host.py`` and ``tools/fuzz_tpu.py``: the
same data shapes, mutation kinds and volumes, driven through the port's
kernels on the card (``--device cuda``, the default, which raises without
one) or through their plain versions (``--device cpu``). Verdicts and bytes
are judged by the port's own oracle (``snappier_tpu_torch.format.oracle``)
and its native engine (``snappier_tpu_torch.runtime.native``). Each
campaign is a function that the tests and ``chip_smoke.py`` call:

* ``roundtrip`` (``fuzz_tpu.py:30-102``): blocks of five data kinds, 0-64
  KiB, through the encode kernel K2 into the oracle and into the decode
  kernel K1, and through the oracle's and the native engine's encoders
  into K1.
* ``corrupt`` (``fuzz_tpu.py:103-139``, with the kinds of
  ``tests/test_mutation_parity.py``): mutants of valid blocks of 1-64 KiB
  (bit and byte flips, truncation, wide-literal injection and insertion,
  extension, garbage) through K1, a valid row before each base's mutants,
  every batch at a row width of the ring loader and at one of the byte
  loader. K1 accepts exactly what the judge accepts, with its bytes; a
  length claim past ``out_cap`` is a capacity rejection.
* ``scalar`` (``fuzz_host.py:227-320``): fragments of 1, 8 and 64 KiB at
  random fills through K2, and through K4 (the best encode) every fourth
  batch, back through K1.
* ``facade`` (``fuzz_host.py:82-110``): ``compress`` / ``decompress`` with
  each device engine (``scalar``, the CUDA kernels; ``scan``, the
  parallel-scan engine), the native engine cross-checking every 20th
  iteration, and a mutant of each stream rejected exactly when the oracle
  rejects it.
* ``device-stream`` (``fuzz_host.py:174-224``): flush-heavy framed writes
  through ``SnappyWriter`` and ``stream_decompress`` on the device engine
  (K2, K3, K1), and framed mutants (chunk type, length field, CRC, payload
  and literal bytes, truncation) given the same verdict and bytes by the
  device, native and oracle engines. A flipped literal byte leaves its
  block valid, so only K3's CRC can catch it.
* ``native`` and ``stream`` (``fuzz_host.py:58``, ``:113``): the host
  engines, the C++ runtime and the Python chunk machine.

:func:`bigbatch` is the B=2,048 codec check of ``tools/repro_bigbatch.py``.

A device campaign routes no row to a plain version or a host engine: on the
card every wrapper launches its kernel, and each campaign reports the
launches it made (``ops.cuda._build.LAUNCHES``) and fails if a kernel it
drives did not launch. Only ``InvalidDataError`` and the kernels' error
words count as verdicts; any other exception, a CUDA error included, ends
the run. Every batch is followed by ``torch.cuda.synchronize()``, so an
asynchronous fault is pinned to its batch.

Usage:
    python3 tools/torch_fuzz.py [--device cuda|cpu] [--seed 301]
        [--campaigns roundtrip,corrupt,...] [--quick] [--bigbatch]
        [--roundtrip N] [--corrupt N] [--scalar N] [--facade N]
        [--device-stream N] [--native N] [--stream N]

It prints a line per campaign (rows, bytes, seconds, launches) and a JSON
line of all of them last. Exit code 0: every campaign exact. On a mismatch
it prints the campaign, seed, iteration and row, writes the input under
``build/fuzz/`` and exits 1.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import snappier_tpu_torch as st  # noqa: E402
from snappier_tpu_torch.constants import BLOCK_SIZE, STREAM_HEADER  # noqa: E402
from snappier_tpu_torch.errors import InvalidDataError  # noqa: E402
from snappier_tpu_torch.format import oracle  # noqa: E402
from snappier_tpu_torch.format.crc32c import crc32c  # noqa: E402
from snappier_tpu_torch.format.varint import read_varint, write_varint  # noqa: E402
from snappier_tpu_torch.models.codec import (  # noqa: E402
    SnappyCodec,
    default_kernel,
    resolve_device,
)
from snappier_tpu_torch.ops.cuda import _build  # noqa: E402
from snappier_tpu_torch.ops.cuda.scalar_codec import (  # noqa: E402
    decode_blocks_bytes,
    decode_layout,
    encode_blocks_best,
    encode_blocks_bytes,
)
from snappier_tpu_torch.runtime import native  # noqa: E402
from snappier_tpu_torch.runtime import stream as pstream  # noqa: E402

FAIL_DIR = ROOT / "build" / "fuzz"
CAMPAIGNS = ("roundtrip", "corrupt", "scalar", "facade", "device-stream", "native", "stream")
#: Volumes on the card: at least the JAX tools' defaults (fuzz_host.py:323-331;
#: fuzz_tpu.py's record of 768 round-trip blocks and 256 mutated streams).
DEFAULTS = {"roundtrip": 1024, "corrupt": 16384, "scalar": 256, "facade": 2000,
            "device-stream": 20, "native": 20000, "stream": 2000}
#: The reduced volumes of ``chip_smoke.py``'s ``fuzz`` phase (``--quick``).
QUICK = {"roundtrip": 128, "corrupt": 2048, "scalar": 96, "facade": 100,
         "device-stream": 4, "native": 50, "stream": 10}
ORACLE_EVERY = 16  # the oracle judges every 16th block beside the native engine
MUTANTS_PER_BASE = 3  # corrupt: a valid row, then this many of its mutants
SHAPES = (1024, 8192, 65536)  # scalar: the fragment ladder

#: The block mutation kinds: those of tests/test_mutation_parity.py's
#: ``_mutants`` and fuzz_tpu.py's corrupt campaign, and their weights.
MUTATIONS = ("byteflip", "bitflip", "truncate", "wide_literal", "wide_insert", "extend",
             "garbage")
_WEIGHTS = np.array([0.30, 0.20, 0.10, 0.15, 0.05, 0.10, 0.10])
#: Length fields of the wide-literal mutants: rest + 1 wraps to 0, about the
#: int32 maximum, wraps negative, an 8 MiB claim (and random, or 59 bytes).
WIDE_FIELDS = ([0xFF, 0xFF, 0xFF, 0xFF], [0xFE, 0xFF, 0xFF, 0x7F], [0xFF, 0xFF, 0xFF, 0x7F],
               [0x00, 0x00, 0x80, 0x00])
#: The framed mutation kinds (tests/test_stream_mutation_parity.py's).
FRAMED_MUTATIONS = ("type", "length", "crc", "payload", "literal", "truncate")


class Mismatch(AssertionError):
    """A row the port got wrong: the campaign, seed, iteration and row, and
    the input that shows it."""

    def __init__(self, campaign: str, seed: int, iteration: int, row: int, what: str,
                 data: bytes) -> None:
        super().__init__(f"{campaign} seed={seed} iteration={iteration} row={row}: {what}")
        self.campaign, self.seed, self.iteration, self.row = campaign, seed, iteration, row
        self.data = bytes(data)


def write_failure(m: Mismatch, out_dir: pathlib.Path | None = None) -> pathlib.Path:
    """Write a mismatch's input under ``out_dir`` (:data:`FAIL_DIR`);
    returns the file."""
    out_dir = FAIL_DIR if out_dir is None else out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{m.campaign}-seed{m.seed}-it{m.iteration}-row{m.row}.bin"
    path.write_bytes(m.data)
    return path


# ---------------------------------------------------------------------------
# Data and mutants
# ---------------------------------------------------------------------------


def gen_block(rng: np.random.Generator, size: int) -> bytes:
    """Skewed run-length data (fuzz_host.py:36): alternating constant runs
    and noise runs of geometric lengths."""
    out = np.empty(size, np.uint8)
    pos = 0
    while pos < size:
        run = min(int(rng.geometric(0.05)), size - pos)
        if rng.random() < 0.5:
            out[pos : pos + run] = rng.integers(0, 256)
        else:
            out[pos : pos + run] = rng.integers(0, 256, run, dtype=np.uint8)
        pos += run
    return out.tobytes()


def size_for(rng: np.random.Generator, i: int) -> int:
    """fuzz_host.py:52: the first 100 sizes cross a 64 KiB fragment line."""
    if i < 100:
        return int(rng.integers(65536, 131073))
    return int(rng.integers(0, 8192))


#: fuzz_tpu.py's five data kinds: geometric run parameter, share of
#: constant runs (kind 4 is always a full block).
_GEO = (0.5, 0.1, 0.02, 0.004, 0.02)
_SOLID = (0.9, 0.6, 0.4, 0.3, 0.5)


def kind_block(rng: np.random.Generator, kind: int, size: int) -> bytes:
    """fuzz_tpu.py's block of data kind ``kind``: runs of geometric length,
    a constant byte with probability ``_SOLID[kind]``, else noise. The runs
    are drawn at once, so a 64 KiB block of short runs costs no Python
    loop."""
    if size == 0:
        return b""
    p = _GEO[kind]
    runs = rng.geometric(p, int(size * p) + 64)
    while runs.sum() < size:
        runs = np.concatenate([runs, rng.geometric(p, int(size * p) + 64)])
    runs = runs[: int(np.searchsorted(np.cumsum(runs), size)) + 1]
    solid = np.repeat(rng.random(len(runs)) < _SOLID[kind], runs)[:size]
    fill = np.repeat(rng.integers(0, 256, len(runs), dtype=np.uint8), runs)[:size]
    noise = rng.integers(0, 256, size, dtype=np.uint8)
    return np.where(solid, fill, noise).tobytes()


def roundtrip_data(rng: np.random.Generator) -> bytes:
    """One round-trip block as fuzz_tpu.py draws it (0-64 KiB; kind 4 full)."""
    kind = int(rng.integers(0, 5))
    size = int(rng.integers(0, BLOCK_SIZE + 1)) if kind != 4 else BLOCK_SIZE
    return kind_block(rng, kind, size)


def _preamble_end(s: bytes) -> int:
    try:
        return read_varint(s)[1]
    except InvalidDataError:
        return 1


def mutate(rng: np.random.Generator, s: bytes, kind: str) -> bytes:
    """One mutant of the valid block ``s`` (kinds of ``MUTATIONS``). A kind
    that needs more bytes than ``s`` has becomes ``garbage``."""
    m = np.frombuffer(s, np.uint8).copy()
    if kind == "byteflip" and len(m):  # 1-3 bytes XOR a nonzero byte
        for _ in range(int(rng.integers(1, 4))):
            m[int(rng.integers(0, len(m)))] ^= int(rng.integers(1, 256))
        return m.tobytes()
    if kind == "bitflip" and len(m):  # 1-7 bits
        for _ in range(int(rng.integers(1, 8))):
            m[int(rng.integers(0, len(m)))] ^= 1 << int(rng.integers(0, 8))
        return m.tobytes()
    if kind == "truncate" and len(m):
        return s[: int(rng.integers(0, len(m)))]
    if kind == "wide_literal" and len(m) > 6:
        # A long-literal tag with an adversarial length field in place: the
        # shape of the int32 ``rest + 1`` wrap that random flips rarely make.
        i = int(rng.integers(1, len(m) - 5))
        m[i] = int(rng.choice([0xF0, 0xF4, 0xF8, 0xFC]))
        j = int(rng.integers(0, len(WIDE_FIELDS) + 1))
        field = WIDE_FIELDS[j] if j < len(WIDE_FIELDS) else rng.integers(0, 256, 4)
        m[i + 1 : i + 5] = np.asarray(field, np.uint8)
        return m.tobytes()
    if kind == "wide_insert" and len(m) > 1:
        # A whole 5-byte literal header spliced in after the preamble, the
        # tag stream intact behind it: a field misread as a small length
        # leaves a stream that decodes, and the verdicts diverge.
        k = int(rng.integers(0, len(WIDE_FIELDS) + 1))
        field = WIDE_FIELDS[k] if k < len(WIDE_FIELDS) else [0x3B, 0x00, 0x00, 0x00]
        at = _preamble_end(s)
        return s[:at] + bytes([0xFC, *field]) + s[at:]
    if kind == "extend":
        return s + rng.integers(0, 256, int(rng.integers(1, 40)), np.uint8).tobytes()
    return rng.integers(0, 256, int(rng.integers(1, 2000)), np.uint8).tobytes()


def pick_mutation(rng: np.random.Generator) -> str:
    return MUTATIONS[int(rng.choice(len(MUTATIONS), p=_WEIGHTS))]


def claim_of(mb: bytes):
    """A block's length claim, or None for a malformed preamble."""
    try:
        return read_varint(mb)[0]
    except InvalidDataError:
        return None


def oracle_verdict(mb: bytes):
    """The oracle's decoded bytes, or None where it rejects the block."""
    try:
        return oracle.decompress(mb)
    except InvalidDataError:
        return None


def native_verdict(mb: bytes):
    try:
        return native.decompress(mb)
    except InvalidDataError:
        return None


# ---------------------------------------------------------------------------
# Campaign bookkeeping
# ---------------------------------------------------------------------------


class _Run:
    """One campaign's counters, its launch baseline and its failure."""

    def __init__(self, name: str, seed: int, dev: torch.device) -> None:
        self.name, self.seed, self.dev = name, seed, dev
        self.rows = 0
        self.nbytes = 0
        self.extra: dict = {}
        self.base = collections.Counter(_build.LAUNCHES)
        self.t0 = time.perf_counter()

    def expect(self, cond, it: int, row: int, what: str, data: bytes) -> None:
        if not cond:
            raise Mismatch(self.name, self.seed, it, row, what, data)

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def launches(self) -> dict:
        return {k: n - self.base.get(k, 0) for k, n in _build.LAUNCHES.items()
                if n - self.base.get(k, 0) > 0}

    def judge(self, mb: bytes, it: int, row: int):
        """The stream verdict of block ``mb``: the native engine's for every
        block where it is built, the oracle's beside it on every 16th block
        judged (the two must agree), else the oracle's alone."""
        n = self.extra.get("judged", 0)
        self.extra["judged"] = n + 1
        if not native.available():
            return oracle_verdict(mb)
        v = native_verdict(mb)
        if n % ORACLE_EVERY == 0:
            self.expect(oracle_verdict(mb) == v, it, row, "native and oracle verdicts differ", mb)
            self.extra["oracle_judged"] = self.extra.get("oracle_judged", 0) + 1
        return v

    def result(self, needs=()) -> dict:
        launches = self.launches()
        if self.dev.type == "cuda":
            missing = [k for k in needs if not launches.get(k)]
            if missing:
                raise RuntimeError(f"{self.name}: kernels {missing} did not launch")
        return {"campaign": self.name, "device": self.dev.type, "seed": self.seed,
                "rows": self.rows, "bytes": self.nbytes,
                "seconds": time.perf_counter() - self.t0, "launches": launches, **self.extra}


def _rows_tensor(blocks: list, width: int, rng: np.random.Generator, dev: torch.device):
    """Blocks as uint8 rows of ``width`` with random garbage past each
    length (a decoder reads no byte past it), and their lengths."""
    comp = rng.integers(0, 256, (len(blocks), width), dtype=np.uint8)
    lens = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        comp[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return torch.from_numpy(comp).to(dev), torch.from_numpy(lens).to(dev)


def _decode(run: _Run, blocks: list, width: int, out_cap: int, rng):
    """K1 on ``blocks`` at row ``width``, synchronised, on the host; also
    returns the loader the launch took (``plain`` on the CPU)."""
    comp, lens = _rows_tensor(blocks, width, rng, run.dev)
    loader = decode_layout(comp, out_cap)["loader"] if run.dev.type == "cuda" else "plain"
    out, out_lens, errs = decode_blocks_bytes(comp, lens, out_cap)
    run.sync()
    return out.cpu().numpy(), out_lens.cpu().numpy(), errs.cpu().numpy(), loader


def _round16(n: int) -> int:
    return max(16, -(-n // 16) * 16)


# ---------------------------------------------------------------------------
# Device campaigns
# ---------------------------------------------------------------------------


def run_roundtrip(rows: int = DEFAULTS["roundtrip"], seed: int = 301, device=None,
                  batch: int = 128) -> dict:
    """Blocks of the five data kinds through K2 -> {oracle, K1} and the
    oracle's and the native engine's encoders -> K1; every row exact with
    error word 0."""
    dev = resolve_device(device)
    run = _Run("roundtrip", seed, dev)
    rng = np.random.default_rng(seed)
    it = 0
    while run.rows < rows:
        datas = [roundtrip_data(rng) for _ in range(min(batch, rows - run.rows))]
        B = len(datas)
        frags = np.zeros((B, BLOCK_SIZE), np.uint8)
        lens = np.zeros(B, np.int32)
        for i, d in enumerate(datas):
            frags[i, : len(d)] = np.frombuffer(d, np.uint8)
            lens[i] = len(d)
        bodies, body_lens = encode_blocks_bytes(torch.from_numpy(frags).to(dev),
                                                torch.from_numpy(lens).to(dev))
        run.sync()
        bodies, body_lens = bodies.cpu().numpy(), body_lens.cpu().numpy()
        paths = {"k2": [write_varint(len(d)) + bodies[i, : body_lens[i]].tobytes()
                        for i, d in enumerate(datas)],
                 "oracle": [oracle.compress(d) for d in datas]}
        if native.available():
            paths["native"] = [native.compress(d) for d in datas]
        for i, d in enumerate(datas):
            run.expect(oracle_verdict(paths["k2"][i]) == d, it, i, "K2 -> oracle", d)
        order = list(paths)
        blocks = [b for p in order for b in paths[p]]
        out, out_lens, errs, _ = _decode(run, blocks, _round16(max(map(len, blocks))),
                                         BLOCK_SIZE, rng)
        for j, blk in enumerate(blocks):
            d = datas[j % B]
            what = f"{order[j // B]} -> K1"
            run.expect(errs[j] == 0 and out_lens[j] == len(d)
                       and out[j, : len(d)].tobytes() == d, it, j % B,
                       f"{what}: err {errs[j]}, length {out_lens[j]} of {len(d)}", blk)
        run.rows += B
        run.nbytes += int(lens.sum())
        it += 1
    run.extra["paths"] = ["k2 -> oracle", *(f"{p} -> k1" for p in order)]
    return run.result(needs=("encode", "decode"))


def run_corrupt(mutants: int = DEFAULTS["corrupt"], seed: int = 301, device=None,
                batch: int = 512) -> dict:
    """Mutants of valid blocks through K1 beside valid rows (one before each
    base's ``MUTANTS_PER_BASE`` mutants), each batch at a row width of the
    ring loader (a multiple of 4) and of the byte loader (odd). K1 gives
    error word 0 exactly where the judge accepts, with its bytes; a claim
    past ``out_cap`` must be rejected."""
    dev = resolve_device(device)
    run = _Run("corrupt", seed, dev)
    rng = np.random.default_rng(seed + 3)
    out_cap = BLOCK_SIZE
    kinds: collections.Counter = collections.Counter()
    verdicts: collections.Counter = collections.Counter()
    loaders: collections.Counter = collections.Counter()
    made = it = nbase = 0
    while made < mutants:
        rows = []  # (kind, block, expected bytes or None, capped)
        while len(rows) + 1 + MUTANTS_PER_BASE <= batch and made < mutants:
            data = kind_block(rng, int(rng.integers(0, 5)), int(rng.integers(1, BLOCK_SIZE + 1)))
            base = (oracle.compress(data) if nbase % ORACLE_EVERY == 0 or not native.available()
                    else native.compress(data))
            nbase += 1
            rows.append(("valid", base, data, False))
            for _ in range(min(MUTANTS_PER_BASE, mutants - made)):
                kind = pick_mutation(rng)
                mb = mutate(rng, base, kind)
                kinds[kind] += 1
                claim = claim_of(mb)
                capped = claim is not None and claim > out_cap
                want = None if capped else run.judge(mb, it, len(rows))
                verdicts["capped" if capped else "accepted" if want is not None
                         else "rejected"] += 1
                rows.append((kind, mb, want, capped))
                made += 1
        blocks = [r[1] for r in rows]
        width = _round16(max(map(len, blocks)))
        for w in (width, width + 1):  # ring, then bytes
            out, out_lens, errs, loader = _decode(run, blocks, w, out_cap, rng)
            loaders[loader] += 1
            if dev.type == "cuda":
                expect = "ring" if w % 4 == 0 else "bytes"
                run.expect(loader == expect, it, -1, f"width {w} took the {loader} loader", b"")
            for j, (kind, mb, want, capped) in enumerate(rows):
                where = f"{kind} row at width {w}"
                if capped or want is None:
                    run.expect(errs[j] != 0, it, j, f"{where}: accepted "
                               f"{'past out_cap' if capped else 'what the judge rejects'}", mb)
                else:
                    run.expect(errs[j] == 0 and out_lens[j] == len(want)
                               and out[j, : len(want)].tobytes() == want, it, j,
                               f"{where}: err {errs[j]}, length {out_lens[j]} of {len(want)}", mb)
        run.rows += len(rows)
        run.nbytes += sum(map(len, blocks))
        it += 1
    run.extra.update(mutants=made, valid_rows=nbase, kinds=dict(kinds),
                     verdicts=dict(verdicts), loaders=dict(loaders), batches=it)
    return run.result(needs=("decode",))


def run_scalar(rows: int = DEFAULTS["scalar"], seed: int = 301, device=None,
               batch: int = 32) -> dict:
    """fuzz_host.py's fragment ladder: lengths uniform in [0, F] (row 0
    full) through K2 on every batch and K4 on every 4th, back through K1 at
    ``out_cap = F``; every 16th row also through the oracle."""
    dev = resolve_device(device)
    run = _Run("scalar", seed, dev)
    rng = np.random.default_rng(seed + 13)
    it = 0
    while run.rows < rows:
        F = SHAPES[it % len(SHAPES)]
        lengths = rng.integers(0, F + 1, batch).astype(np.int32)
        lengths[0] = F
        frags = np.zeros((batch, F), np.uint8)
        datas = []
        for r in range(batch):
            d = gen_block(rng, int(lengths[r])) if lengths[r] else b""
            datas.append(d)
            frags[r, : len(d)] = np.frombuffer(d, np.uint8)
        ft, lt = torch.from_numpy(frags).to(dev), torch.from_numpy(lengths).to(dev)
        encs = [("K2", encode_blocks_bytes(ft, lt))]
        if it % 4 == 0:
            encs.append(("K4", encode_blocks_best(ft, lt)))
        for kind, (bodies, body_lens) in encs:
            run.sync()
            bodies = bodies.to(torch.uint8).cpu().numpy()
            body_lens = body_lens.cpu().numpy()
            blocks = [write_varint(len(d)) + bodies[r, : body_lens[r]].tobytes()
                      for r, d in enumerate(datas)]
            out, out_lens, errs, _ = _decode(run, blocks, F + 4096, F, rng)
            for r, d in enumerate(datas):
                run.expect(errs[r] == 0 and out_lens[r] == len(d)
                           and out[r, : len(d)].tobytes() == d, it, r,
                           f"{kind} F={F} -> K1: err {errs[r]}", blocks[r])
                if r % 16 == 0:
                    run.expect(oracle_verdict(blocks[r]) == d, it, r, f"{kind} F={F} -> oracle",
                               blocks[r])
        run.rows += batch
        run.nbytes += int(lengths.sum())
        it += 1
    run.extra.update(batches=it, best_batches=-(-it // 4))
    return run.result(needs=("encode", "encode_best", "decode"))


@contextlib.contextmanager
def device_engine(kernel: str):
    """The facade's and the streams' device engine set to ``kernel`` for the
    span (``SNAPPIER_KERNEL``, read once per process by
    ``models.codec.default_kernel``, whose cache is cleared around it)."""
    old = os.environ.get("SNAPPIER_KERNEL")
    os.environ["SNAPPIER_KERNEL"] = kernel
    default_kernel.cache_clear()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("SNAPPIER_KERNEL", None)
        else:
            os.environ["SNAPPIER_KERNEL"] = old
        default_kernel.cache_clear()


def facade_verdict(mb: bytes, dev: torch.device):
    try:
        return st.decompress(mb, device=dev)
    except InvalidDataError:
        return None


def run_facade(iters: int = DEFAULTS["facade"], seed: int = 301, device=None) -> dict:
    """fuzz_host.py's ``run_scan`` through the port's facade on the device,
    once per device engine: ``compress`` / ``decompress`` exact, the native
    engine cross-checking every 20th iteration, and a mutant of every
    stream rejected by ``decompress`` exactly when the oracle rejects it
    (with the oracle's bytes where both accept)."""
    dev = resolve_device(device)
    by_kernel = {}
    for kernel in ("scalar", "scan"):
        run = _Run(f"facade[{kernel}]", seed, dev)
        rng = np.random.default_rng(seed + 1)
        verdicts: collections.Counter = collections.Counter()
        with device_engine(kernel):
            for i in range(iters):
                data = gen_block(rng, size_for(rng, i))
                comp = st.compress(data, device=dev)
                run.expect(st.decompress(comp, device=dev) == data, i, 0, "round trip", data)
                if i % 20 == 0 and native.available():
                    run.expect(native.decompress(comp) == data, i, 0, "native decode", comp)
                    nc = native.compress(data)
                    run.expect(st.decompress(nc, device=dev) == data, i, 0,
                               "decode of the native stream", nc)
                mb = mutate(rng, comp, pick_mutation(rng))
                want = oracle_verdict(mb)
                said = "accepted" if want is not None else "rejected"
                run.expect(facade_verdict(mb, dev) == want, i, 1,
                           f"mutant verdict differs (the oracle {said} it)", mb)
                verdicts[said] += 1
                run.sync()
                run.rows += 1
                run.nbytes += len(data)
        run.extra["mutant_verdicts"] = dict(verdicts)
        # The scan engine is tensor code: a kernel launch there means the
        # engine switch did not hold.
        if kernel == "scan" and dev.type == "cuda" and run.launches():
            raise RuntimeError(f"the scan facade launched CUDA kernels: {run.launches()}")
        by_kernel[kernel] = run.result(needs=("encode", "decode") if kernel == "scalar" else ())
    return {"campaign": "facade", "device": dev.type, "seed": seed,
            "rows": sum(r["rows"] for r in by_kernel.values()),
            "bytes": sum(r["bytes"] for r in by_kernel.values()),
            "seconds": sum(r["seconds"] for r in by_kernel.values()),
            "launches": dict(sum((collections.Counter(r["launches"]) for r in by_kernel.values()),
                                 collections.Counter())),
            "by_kernel": by_kernel}


def chunk_table(s: bytes) -> list:
    """[(header offset, type, payload length)] of a framed stream's chunks."""
    recs, pos = [], 0
    while pos + 4 <= len(s):
        plen = int.from_bytes(s[pos + 1 : pos + 4], "little")
        recs.append((pos, s[pos], plen))
        pos += 4 + plen
    return recs


def literal_byte(block: bytes) -> int | None:
    """Offset of the first byte of literal data in a valid block, or None."""
    ip = _preamble_end(block)
    while ip < len(block):
        tag = block[ip]
        if tag & 3 == 0:
            l6 = tag >> 2
            hdr = 1 if l6 < 60 else 1 + l6 - 59
            return ip + hdr if ip + hdr < len(block) else None
        ip += (2, 3, 5)[(tag & 3) - 1]
    return None


def framed_mutants(rng: np.random.Generator, s: bytes, n: int) -> list:
    """Up to ``n`` mutants of the framed stream ``s``, drawn from the
    targeted set of tests/test_stream_mutation_parity.py (each chunk's type
    swept, its length and CRC bytes and a payload byte flipped, cuts
    mid-header, mid-CRC, mid-payload and at its start) plus, for each
    compressed chunk, a flipped literal byte: its block stays valid, so only
    the CRC can reject it. Returns [(kind, stream, chunk type)]."""
    arr = np.frombuffer(s, np.uint8)
    out, literal = [], []

    def flipped(at: int, x: int) -> bytes:
        m = arr.copy()
        m[at] ^= x
        return m.tobytes()

    for off, t, plen in chunk_table(s):
        for nt in (0x00, 0x01, 0x02, 0x50, 0x7F, 0x80, 0xFE, 0xFF):
            if nt != t:
                out.append(("type", flipped(off, t ^ nt), t))
        for k in range(1, 4):
            out.append(("length", flipped(off + k, int(rng.integers(1, 256))), t))
        if t in (0x00, 0x01) and plen >= 4:
            for k in range(4):
                out.append(("crc", flipped(off + 4 + k, int(rng.integers(1, 256))), t))
        if plen > 4:
            j = off + 8 + int(rng.integers(0, plen - 4))
            out.append(("payload", flipped(j, int(rng.integers(1, 256))), t))
        for cut in (off + 2, off + 5, off + 4 + plen // 2, off):
            if 0 < cut < len(s):
                out.append(("truncate", s[:cut], t))
        if t == 0x00 and plen > 4:
            at = literal_byte(s[off + 8 : off + 4 + plen])
            if at is not None:
                literal.append(("literal", flipped(off + 8 + at, int(rng.integers(1, 256))), t))
    if len(out) > n:
        out = [out[k] for k in sorted(rng.choice(len(out), n, replace=False))]
    return literal + out


def stream_verdict(mb: bytes, engine: str, dev: torch.device):
    try:
        if engine == "native":
            return native.stream_decompress(mb)
        return pstream.stream_decompress(mb, engine=engine, device=dev)
    except InvalidDataError:
        return None


def run_device_stream(iters: int = DEFAULTS["device-stream"], seed: int = 301, device=None,
                      mutants_per_iter: int = 48) -> dict:
    """fuzz_host.py's ``run_stream_device`` on the device engine, and framed
    mutants of each stream judged alike by the device, native and oracle
    engines (``framed_mutants``). A literal-byte flip must be rejected; on
    the card its rejection is K3's CRC of the decoded chunk."""
    dev = resolve_device(device)
    run = _Run("device-stream", seed, dev)
    rng = np.random.default_rng(seed + 7)
    engines = ("cuda", "native", "oracle") if native.available() else ("cuda", "oracle")
    kinds: collections.Counter = collections.Counter()
    crc_caught = 0
    for i in range(iters):
        parts = [gen_block(rng, int(rng.integers(1, 65537)))
                 for _ in range(int(rng.integers(1, 6)))]
        data = b"".join(parts)
        sink = io.BytesIO()
        w = st.SnappyWriter(sink, engine="cuda", device=dev, leave_open=True)
        for p in parts:
            w.write(p)
            if rng.random() < 0.5:
                w.flush()
        w.close()
        framed = sink.getvalue()
        if rng.random() < 0.5:  # legal padding and skippable chunks after the header
            pad = bytes([0xFE]) + (3).to_bytes(3, "little") + b"xyz"
            skip = bytes([int(rng.integers(0x80, 0xFE))]) + (2).to_bytes(3, "little") + b"ab"
            framed = framed[:10] + pad + skip + framed[10:]
        run.expect(framed.startswith(STREAM_HEADER), i, 0, "stream header", framed)
        run.expect(stream_verdict(framed, "cuda", dev) == data, i, 0, "device round trip",
                   framed)
        if i % 10 == 0:
            run.expect(stream_verdict(framed, "oracle", dev) == data, i, 0, "device -> oracle",
                       framed)
        for j, (kind, mb, _) in enumerate(framed_mutants(rng, framed, mutants_per_iter)):
            got = {e: stream_verdict(mb, e, dev) for e in engines}
            run.expect(len(set(got.values())) == 1, i, j + 1,
                       f"{kind} mutant: verdicts differ "
                       f"({ {e: v is not None for e, v in got.items()} })", mb)
            if kind == "literal":
                run.expect(got["cuda"] is None, i, j + 1, "a flipped literal byte passed", mb)
                crc_caught += 1
            kinds[kind] += 1
        run.sync()
        run.rows += 1
        run.nbytes += len(data)
    run.extra.update(mutants=sum(kinds.values()), kinds=dict(kinds), crc_caught=crc_caught)
    return run.result(needs=("encode", "crc32c", "decode"))


# ---------------------------------------------------------------------------
# Host campaigns
# ---------------------------------------------------------------------------


def _need_native(name: str, seed: int) -> dict | None:
    if native.available():
        return None
    print(f"{name}: the native engine is not built; campaign skipped")
    return {"campaign": name, "device": "host", "seed": seed, "rows": 0, "bytes": 0,
            "seconds": 0.0, "launches": {}, "skipped": "no native engine"}


def run_native(iters: int = DEFAULTS["native"], seed: int = 301, device=None) -> dict:
    """fuzz_host.py's ``run_native``: C++ round trips, the oracle decoding
    every 100th stream."""
    skipped = _need_native("native", seed)
    if skipped:
        return skipped
    run = _Run("native", seed, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    for i in range(iters):
        data = gen_block(rng, size_for(rng, i))
        comp = native.compress(data)
        run.expect(native.decompress(comp) == data, i, 0, "native round trip", data)
        if i % 100 == 0:
            run.expect(oracle_verdict(comp) == data, i, 0, "oracle decode", comp)
        run.rows += 1
        run.nbytes += len(data)
    return run.result()


def run_stream(iters: int = DEFAULTS["stream"], seed: int = 301, device=None) -> dict:
    """fuzz_host.py's ``run_stream``: the C++ framing pipeline against the
    Python chunk machine both ways, and a mutant of each stream given the
    same verdict (and bytes) by both."""
    skipped = _need_native("stream", seed)
    if skipped:
        return skipped
    run = _Run("stream", seed, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    for i in range(iters):
        data = gen_block(rng, size_for(rng, i))
        nf = native.stream_compress(data)
        run.expect(native.stream_decompress(nf) == data, i, 0, "native stream", data)
        pf = pstream.stream_compress(data, engine="oracle")
        run.expect(native.stream_decompress(pf) == data, i, 0, "python -> native", pf)
        if i % 20 == 0:
            run.expect(pstream.stream_decompress(nf, engine="oracle") == data, i, 0,
                       "native -> python", nf)
        mut = bytearray(nf)
        kind = int(rng.integers(0, 3))
        if kind == 0 and mut:
            for _ in range(int(rng.integers(1, 6))):
                mut[int(rng.integers(0, len(mut)))] ^= 1 << int(rng.integers(0, 8))
        elif kind == 1:
            mut = mut[: int(rng.integers(0, len(mut) + 1))]
        else:
            mut = bytearray(rng.integers(0, 256, int(rng.integers(0, 400)), np.uint8))
        mb = bytes(mut)
        run.expect(stream_verdict(mb, "native", run.dev) == stream_verdict(mb, "oracle", run.dev),
                   i, 1, "native and python chunk machines differ", mb)
        run.rows += 1
        run.nbytes += len(data)
    return run.result()


RUNNERS = {"roundtrip": run_roundtrip, "corrupt": run_corrupt, "scalar": run_scalar,
           "facade": run_facade, "device-stream": run_device_stream, "native": run_native,
           "stream": run_stream}


def bigbatch(B: int = 2048, seed: int = 301, device=None) -> dict:
    """tools/repro_bigbatch.py's check at B rows of 64 KiB (2,048: 128 MiB,
    the batch a 100 MB stream picks): ``SnappyCodec(with_crc=True)``
    compresses word-mix rows with every 8th row random bytes; every body
    decodes through the native engine (the oracle without it), every CRC
    equals the host's, and ``decompress_batch`` of the native engine's
    streams of the rows is exact."""
    dev = resolve_device(device)
    run = _Run("bigbatch", seed, dev)
    rng = np.random.default_rng(seed)
    words = [b"<html>", b"<body>", b"<div class=", b"the", b"snappy", b"corpus", b"fallback",
             b"</div>", b'href="/a/b"', b"\n"]
    mix = np.frombuffer(b" ".join(words[i] for i in rng.integers(0, len(words), 1 << 19)),
                        np.uint8)
    starts = rng.integers(0, len(mix) - BLOCK_SIZE, B)
    rows = np.stack([mix[s : s + BLOCK_SIZE] for s in starts])
    rows[::8] = rng.integers(0, 256, (len(rows[::8]), BLOCK_SIZE), dtype=np.uint8)
    lens = np.full(B, BLOCK_SIZE, np.int32)
    codec = SnappyCodec(with_crc=True, device=dev)
    bodies, body_lens, crcs = codec.compress_batch(torch.from_numpy(rows).to(dev),
                                                   torch.from_numpy(lens).to(dev))
    run.sync()
    bodies = bodies.to(torch.uint8).cpu().numpy()
    body_lens = body_lens.cpu().numpy()
    crcs = crcs.cpu().numpy().view(np.uint32)
    host_decode = native.decompress if native.available() else oracle.decompress
    host_crc = native.crc32c if native.available() else crc32c
    pre = write_varint(BLOCK_SIZE)
    for i in range(B):
        blk = pre + bodies[i, : body_lens[i]].tobytes()
        row = rows[i].tobytes()
        run.expect(host_decode(blk) == row, 0, i, "body does not decode to its row", blk)
        run.expect(int(crcs[i]) == host_crc(row), 0, i, "CRC differs from the host's", row)
    comps = [native.compress(rows[i].tobytes()) if native.available()
             else oracle.compress(rows[i]) for i in range(B)]
    comp, comp_lens = _rows_tensor(comps, _round16(max(map(len, comps))), rng, dev)
    outs, out_lens, errs = codec.decompress_batch(comp, comp_lens, out_cap=BLOCK_SIZE)
    run.sync()
    outs, out_lens, errs = outs.cpu().numpy(), out_lens.cpu().numpy(), errs.cpu().numpy()
    for i in range(B):
        run.expect(errs[i] == 0 and out_lens[i] == BLOCK_SIZE and (outs[i] == rows[i]).all(),
                   1, i, f"decompress_batch of the host stream: err {errs[i]}", comps[i])
    run.rows, run.nbytes = B, B * BLOCK_SIZE
    run.extra["ratio"] = float(body_lens.sum()) / (B * BLOCK_SIZE)
    return run.result(needs=("encode", "crc32c", "decode"))


def summary_line(r: dict) -> str:
    extra = {k: r[k] for k in ("mutants", "oracle_judged", "verdicts", "loaders", "crc_caught")
             if k in r}
    return (f"{r['campaign']}: {r['rows']} rows, {r['bytes'] / 1e6:.1f} MB, "
            f"{r['seconds']:.1f} s, launches {r['launches']}"
            + (f", {extra}" if extra else "") + " - all exact")


def run_campaigns(names, volumes: dict, seed: int, device) -> list:
    """Run the named campaigns at ``volumes``, printing a line for each."""
    results = []
    for name in names:
        r = RUNNERS[name](volumes[name], seed, device)
        print(summary_line(r), flush=True)
        for k, sub in r.get("by_kernel", {}).items():
            print("  " + summary_line(sub), flush=True)
        results.append(r)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=301)
    ap.add_argument("--campaigns", default=",".join(CAMPAIGNS),
                    help="comma-separated subset of " + ", ".join(CAMPAIGNS))
    ap.add_argument("--quick", action="store_true", help="the reduced volumes of chip_smoke.py")
    ap.add_argument("--bigbatch", action="store_true", help="also the B=2,048 codec check")
    for name in CAMPAIGNS:
        ap.add_argument(f"--{name}", type=int, default=None, metavar="N",
                        help=f"volume (default {DEFAULTS[name]}, quick {QUICK[name]})")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    names = [n for n in args.campaigns.split(",") if n]
    unknown = [n for n in names if n not in RUNNERS]
    if unknown:
        ap.error(f"unknown campaigns {unknown}")
    volumes = dict(QUICK if args.quick else DEFAULTS)
    for name in CAMPAIGNS:
        v = getattr(args, name.replace("-", "_"))
        if v is not None:
            volumes[name] = v
    if dev.type == "cuda":
        import chip_smoke

        print(chip_smoke.card_line())
        _build.build_all()
    try:
        results = run_campaigns(names, volumes, args.seed, dev)
        if args.bigbatch:
            results.append(bigbatch(seed=args.seed, device=dev))
            print(summary_line(results[-1]), flush=True)
    except Mismatch as m:
        print(f"MISMATCH {m}", flush=True)
        print(f"input written to {write_failure(m)}", flush=True)
        return 1
    print(json.dumps({"fuzz": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
