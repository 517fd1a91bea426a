#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``snappier_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` (the kernels are built from ``snappier_tpu_torch/csrc`` into
``build/`` at first use) and no network. Phases, each of which raises on
failure:

1. the card's name and power limit (``nvidia-smi``); build the kernels;
2. each kernel against its plain version on the same inputs, with edge and
   corrupt rows (exact equality: the kernels compute bytes and bits);
3. the main path at full size: ``SnappyCodec(with_crc=True)`` compresses
   512 blocks of 64 KiB of markup-like text (bench.py's seeded word mix),
   ``decompress_batch`` decodes them back, and the result is held against
   the input, the host CRC32C and the host oracle decoder; every kernel of
   the path must have launched; ``frame_batch`` and ``roundtrip_step`` run
   once;
4. timings with CUDA events (warm-up, best of 3 passes).

The line before the last is a JSON object listing each kernel with its
launches on the main path, its time, its bound and its plain version's
time; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

B = 512  # blocks per call, as bench.py (32 MiB per call)
BLOCK = 65536
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores (data sheet)

KERNELS = {  # launch-counter name -> (reported name, source, TPU kernel it replaces)
    "decode": ("decode_blocks_scalar", "snappier_tpu_torch/csrc/decode.cu",
               "snappier_tpu/ops/pallas/scalar_codec.py:167"),
    "encode": ("encode_blocks_scalar", "snappier_tpu_torch/csrc/encode.cu",
               "snappier_tpu/ops/pallas/scalar_codec.py:765"),
    "crc32c": ("crc32c_blocks", "snappier_tpu_torch/csrc/crc32c.cu",
               "snappier_tpu/ops/pallas/crc32c.py:43"),
}


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def word_mix() -> bytes:
    """bench.py's seeded stand-in for the html corpus (bench.py:49-55)."""
    rng = np.random.default_rng(7)
    words = [b"<html>", b"<body>", b"the", b"snappy", b"corpus", b"fallback"]
    return b" ".join(words[i] for i in rng.integers(0, len(words), 40000))


def markup(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    words = [b"<html>", b"<body>", b"<div class=", b"the", b"snappy", b"corpus",
             b"fallback", b"</div>", b'href="/a/b"', b"\n"]
    s = b" ".join(words[i] for i in rng.integers(0, len(words), n // 2 + 8))
    return np.frombuffer(s[:n], np.uint8)


def cuda_ms(fn, iters: int = 5, passes: int = 3) -> float:
    """Best per-call milliseconds over ``passes`` runs of ``iters`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(passes):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def max_abs_err(pairs) -> int:
    """Largest |a - b| over (kernel, plain) integer arrays of equal shape."""
    err = 0
    for a, b in pairs:
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        if a.shape != b.shape:
            raise AssertionError(f"shape {a.shape} != {b.shape}")
        if a.size:
            err = max(err, int(np.abs(a - b).max()))
    return err


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def encode_rows(rng):
    """Markup, random, all-zero, period-1..7 and short rows of 64 KiB with
    random garbage past each length."""
    lens = [BLOCK, BLOCK - 5, BLOCK, BLOCK] + [BLOCK - 3 * p for p in range(1, 8)]
    lens += [1, 15, 16, 17, 100]
    frags = rng.integers(0, 256, (len(lens), BLOCK), dtype=np.uint8)
    frags[0] = markup(BLOCK, 1)
    frags[1, : BLOCK - 5] = markup(BLOCK - 5, 2)
    frags[3] = 0
    for p in range(1, 8):
        r = 3 + p
        frags[r, : lens[r]] = np.tile(rng.integers(0, 256, p, dtype=np.uint8), BLOCK)[: lens[r]]
    for r in range(11, len(lens)):
        frags[r, : lens[r]] = markup(lens[r], r)
    return frags, np.array(lens, np.int32)


def corrupt_streams():
    """An empty row, a truncated tag, offset 0, offset > op, a bad
    preamble, a length mismatch and other malformed blocks."""
    lit4 = bytes([(4 - 1) << 2]) + b"abcd"
    return [
        b"",
        b"\xff\xff\xff\xff\xff",
        bytes([10, 3 << 2]) + b"ab",
        bytes([8]) + lit4 + bytes([2 | (3 << 2), 4]),
        bytes([8]) + lit4 + bytes([1, 0]),
        bytes([8]) + lit4 + bytes([1, 5]),
        bytes([9]) + lit4 + bytes([1, 4]),
        bytes([8]) + lit4 + bytes([3 | (3 << 2), 4, 0, 0, 0]),
        bytes([64, 0xFC, 0xFF, 0xFF, 0xFF, 0xFF]) + b"x" * 64,
        bytes([0x80, 0x80, 0x04]) + b"",  # claims 65536 + 0 bytes
        bytes([0x81, 0x80, 0x04]),  # claims 65537 > out_cap
    ]


def phase_kernels(torch, sc, crc, oracle, write_varint):
    """Each kernel against its plain version; returns max_abs_err per kernel."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    errs = {}

    frags, lens = encode_rows(rng)
    f_h, l_h = torch.from_numpy(frags), torch.from_numpy(lens)
    bodies, body_lens = sc.encode_blocks_bytes(f_h.to(dev), l_h.to(dev))
    torch.cuda.synchronize()
    p_bodies, p_lens = sc.encode_blocks_plain(f_h, l_h, sc.HASH_BITS, 32)
    bodies, body_lens = bodies.cpu().numpy(), body_lens.cpu().numpy()
    p_bodies, p_lens = p_bodies.numpy(), p_lens.numpy()
    check((body_lens == p_lens).all(), f"encode lengths differ: {body_lens} vs {p_lens}")
    errs["encode"] = max_abs_err(
        [(body_lens, p_lens)] + [(bodies[i, :n], p_bodies[i, :n]) for i, n in enumerate(p_lens)]
    )
    for i, n in enumerate(lens):
        blk = write_varint(int(n)) + bodies[i, : body_lens[i]].tobytes()
        check(oracle.decompress(blk) == frags[i, :n].tobytes(), f"encode row {i} round trip")
    print(f"encode kernel == plain on {len(lens)} rows, max_abs_err {errs['encode']}")

    streams = corrupt_streams() + [
        write_varint(int(n)) + bodies[i, : body_lens[i]].tobytes() for i, n in enumerate(lens)
    ]
    cc = 68608
    comp = rng.integers(0, 256, (len(streams), cc), dtype=np.uint8)
    clens = np.zeros(len(streams), np.int32)
    for i, s in enumerate(streams):
        comp[i, : len(s)] = np.frombuffer(s, np.uint8)
        clens[i] = len(s)
    c_h, cl_h = torch.from_numpy(comp), torch.from_numpy(clens)
    out, out_lens, derr = sc.decode_blocks_bytes(c_h.to(dev), cl_h.to(dev), BLOCK)
    torch.cuda.synchronize()
    p_out, p_olens, p_derr = (x.numpy() for x in sc.decode_blocks_plain(c_h, cl_h, BLOCK))
    out, out_lens, derr = out.cpu().numpy(), out_lens.cpu().numpy(), derr.cpu().numpy()
    check((derr == p_derr).all(), f"decode errors differ: {derr} vs {p_derr}")
    check((out_lens == p_olens).all(), f"decode lengths differ: {out_lens} vs {p_olens}")
    errs["decode"] = max_abs_err(
        [(derr, p_derr), (out_lens, p_olens)]
        + [(out[i, :n], p_out[i, :n]) for i, n in enumerate(p_olens)]
    )
    n_bad = len(corrupt_streams())
    check((derr[1:n_bad] != 0).sum() >= n_bad - 3 and derr[0] == 8, f"corrupt rows: {derr}")
    check((derr[n_bad:] == 0).all(), "encoded rows must decode")
    print(f"decode kernel == plain on {len(streams)} rows (errors {derr[:n_bad].tolist()}),"
          f" max_abs_err {errs['decode']}")

    clen = np.array([0, 1, 15, 16, 17, 4095, 57344, BLOCK - 3, BLOCK], np.int32)
    rows = rng.integers(0, 256, (len(clen), BLOCK), dtype=np.uint8)
    r_h, rl_h = torch.from_numpy(rows), torch.from_numpy(clen)
    got = crc.crc32c_blocks(r_h.to(dev), rl_h.to(dev))
    torch.cuda.synchronize()
    want = crc.crc32c_blocks_plain(r_h, rl_h).numpy()
    got = got.cpu().numpy()
    check((got == want).all(), f"crc32c differs: {got} vs {want}")
    errs["crc32c"] = max_abs_err([(got.view(np.uint32), want.view(np.uint32))])
    print(f"crc32c kernel == plain on {len(clen)} rows, max_abs_err {errs['crc32c']}")
    return errs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2

    from snappier_tpu_torch import SnappyCodec
    from snappier_tpu_torch.format import oracle
    from snappier_tpu_torch.format.crc32c import crc32c, mask_crc
    from snappier_tpu_torch.format.varint import write_varint
    from snappier_tpu_torch.ops.cuda import _build
    from snappier_tpu_torch.ops.cuda import crc32c as crc
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc

    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built {sorted(_build.SOURCES)} in {time.perf_counter() - t0:.2f} s")

    # --- 2. each kernel against its plain version ------------------------
    errs = phase_kernels(torch, sc, crc, oracle, write_varint)

    # --- 3. the main path at full size ------------------------------------
    dev = torch.device("cuda")
    html = word_mix()
    reps = -(-B * BLOCK // len(html))
    data = np.frombuffer((html * reps)[: B * BLOCK], np.uint8).reshape(B, BLOCK)
    frags = torch.from_numpy(data.copy()).to(dev)
    lengths = torch.full((B,), BLOCK, dtype=torch.int32, device=dev)
    codec = SnappyCodec(with_crc=True)
    torch.cuda.synchronize()

    _build.reset_launches()
    bodies, body_lens, crcs = codec.compress_batch(frags, lengths)
    pre = torch.tensor([0x80, 0x80, 0x04], dtype=torch.uint8, device=dev).expand(B, 3)
    blocks = torch.cat([pre, bodies.to(torch.uint8)], dim=1)
    blocks = torch.nn.functional.pad(blocks, (0, (-blocks.shape[1]) % 1024))
    block_lens = body_lens + 3
    outs, out_lens, derrs = codec.decompress_batch(blocks, block_lens, out_cap=BLOCK)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"main path launches: {launches}")
    for k in KERNELS:
        check(launches.get(k, 0) > 0, f"kernel {k} did not launch on the main path")

    check(outs.shape == (B, BLOCK) and outs.dtype == torch.int32, "decode output shape")
    check(bool((derrs == 0).all()), "main-path decode errors")
    check(bool((out_lens == BLOCK).all()), "main-path decode lengths")
    check(bool((outs == frags.to(torch.int32)).all()), "main-path round trip differs")
    bl = body_lens.cpu().numpy()
    body_bytes = bodies.to(torch.uint8).cpu().numpy()
    crc_h = crcs.cpu().numpy().view(np.uint32)
    for i in np.linspace(0, B - 1, 8).astype(int):
        check(int(crc_h[i]) == crc32c(data[i]), f"CRC of row {i}")
        blk = write_varint(BLOCK) + body_bytes[i, : bl[i]].tobytes()
        check(oracle.decompress(blk) == data[i].tobytes(), f"oracle decode of row {i}")
    ratio = float(bl.sum()) / (B * BLOCK)
    print(f"main path: {B} x {BLOCK} B round trip exact, ratio {ratio:.4f}")

    framed, flens = codec.frame_batch(frags, lengths)
    fl = flens.cpu().numpy()
    fr = framed.cpu().numpy()
    for i in (0, B - 1):
        row = fr[i, : fl[i]]
        check(row[0] == 0 and int.from_bytes(row[1:4].tobytes(), "little") == fl[i] - 4,
              f"frame header of row {i}")
        check(int.from_bytes(row[4:8].tobytes(), "little") == mask_crc(crc32c(data[i])),
              f"frame CRC of row {i}")
        check(oracle.decompress(row[8:].tobytes()) == data[i].tobytes(), f"frame payload {i}")
    _, _, _, ok = codec.roundtrip_step(frags, lengths)
    check(bool(ok), "roundtrip_step not ok")
    print("frame_batch and roundtrip_step ok")

    # --- 4. timings -----------------------------------------------------------
    plain_codec = SnappyCodec(with_crc=False)
    t_c = cuda_ms(lambda: plain_codec.compress_batch(frags, lengths))
    t_cc = cuda_ms(lambda: codec.compress_batch(frags, lengths))
    t_d = cuda_ms(lambda: codec.decompress_batch(blocks, block_lens, out_cap=BLOCK))
    comp_u8 = blocks.contiguous()
    ms = {
        "encode": cuda_ms(lambda: sc.encode_blocks_bytes(frags, lengths)),
        "decode": cuda_ms(lambda: sc.decode_blocks_bytes(comp_u8, block_lens, BLOCK)),
        "crc32c": cuda_ms(lambda: crc.crc32c_blocks(frags, lengths)),
    }
    # bench.py's metric: 2 * uncompressed bytes / (compress + decompress),
    # CRC32C not timed inside compress (bench.py:98-103, :156-160).
    gb = B * BLOCK / 1e9
    combined = 2 * gb / ((t_c + t_d) / 1e3)
    print(json.dumps({
        "card": card, "compress_ms": t_c, "compress_with_crc_ms": t_cc,
        "decompress_ms": t_d, "crc_ms": ms["crc32c"], "combined_gbps": combined,
        "compress_gbps": gb / (t_c / 1e3), "decompress_gbps": gb / (t_d / 1e3),
        "ratio": ratio, "blocks": B,
    }))
    f1, l1 = torch.from_numpy(data[:1].copy()), torch.from_numpy(np.array([BLOCK], np.int32))
    c1 = torch.from_numpy(comp_u8[:1].cpu().numpy())
    cl1 = block_lens[:1].cpu()
    plain_ms = {
        "encode": host_ms(lambda: sc.encode_blocks_plain(f1, l1, sc.HASH_BITS, 32)),
        "decode": host_ms(lambda: sc.decode_blocks_plain(c1, cl1, BLOCK)),
        "crc32c": host_ms(lambda: crc.crc32c_blocks_plain(f1, l1)),
    }
    n_in = B * BLOCK
    n_body = int(bl.sum())
    moved = {  # bytes each kernel must read once and write once at these shapes
        "encode": n_in + 4 * B + n_body + 4 * B,  # fragments, lengths -> bodies, lengths
        "decode": n_body + 3 * B + 4 * B + n_in + 8 * B,  # blocks, lengths -> bytes, len, err
        "crc32c": n_in + 4 * B + 4 * B,  # fragments, lengths -> CRCs
    }
    # Operations: at least one 32-bit integer step per input byte (a hash
    # or table step; a decoded byte's store), at the card's 32-bit
    # non-tensor peak. The byte term is the larger one for all three.
    ops = {"encode": n_in, "decode": n_in, "crc32c": n_in}
    rows = []
    for k, (kname, source, replaces) in KERNELS.items():
        t_bytes = moved[k] / HBM_BYTES_PER_S * 1e3
        t_ops = ops[k] / INT32_OPS_PER_S * 1e3
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[k], "max_abs_err": errs[k], "ms": ms[k],
            "plain_ms": plain_ms[k], "plain_rows": 1, "plain_device": "cpu",
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": moved[k], "bound_ops": ops[k], "library_ms": None,
        })
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
