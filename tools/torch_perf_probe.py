#!/usr/bin/env python3
"""Decode-walk ablation probe for the PyTorch/CUDA port (run on an NVIDIA
GPU; port of ``tools/perf_probe.py``).

Variants of the block decode walk, timed on B x 64 KiB blocks with CUDA
events (warm-up, best of 3 passes of 5 calls), each checked first: error
words all zero and, for the variants that move payload, the first and last
block equal to the input.

Usage, from the repository root: python3 tools/torch_perf_probe.py [-B N] [variant ...]
Variants (the TPU probe's names; on the card each is the production
kernel's batched walk over the ablation's tag source, with the knob that
stands for the TPU one: csrc/decode_variants.cu):
  v0      the production kernel (csrc/decode.cu), the baseline
  v1      every round of a batch's step stored whole (the TPU's fixed
          16-byte move a tag)
  v1nock  v1 without the checks that do not guard an access (what the
          checks cost)
  v1nocp  v1's parsing warp alone, nothing written (the walk's floor)
  v2      each batch's bytes written up to its end
  v4      each batch's last round stored whole (the TPU's words stored past
          the frontier)
  v3      v2's kernel (the TPU's one image and one source address: the
          writing warp reads every byte through one source word already)
  scan    the parallel-scan engine's decoder (tensor code, no walk)

The blocks are the seeded word mix that ``chip_smoke.py`` drives
(``word_mix``), compressed by the port's oracle, at the tight row width
(the longest block rounded up to 1 KiB), as the TPU probe stages them. The
first line is the card's name and power limit; the second the batch, the
tag count of block 0 and its tag mix, which explains the times: literals
and copies of at most 16 bytes take a variant's short path, the others its
loop, and copies with an offset below 8 the pattern path. Then one line per
variant: ms per call, us per block, GB/s of output and ns per tag, where a
block's time is the call's time over the waves of blocks the card runs
(``blocks_in_flight``: the SMs times the blocks an SM holds, from the
kernel's layout query; the scan engine has no waves and gets the call's
time over B).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

BLOCK_SIZE = 65536
VARIANT_NAMES = ("v0", "v1", "v1nock", "v1nocp", "v2", "v3", "v4", "scan")
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_PER_SM = 233472  # bytes of shared memory an SM can give its blocks (228 KB)
SMEM_PER_BLOCK_RESERVED = 1024  # what CUDA reserves of each block's allocation


def tag_mix(block: bytes):
    """(tag count, histogram) of one compressed block: literals and copies
    by length (at most 16 bytes or more) and copies with an offset below 8."""
    from snappier_tpu_torch.format.varint import read_varint

    _, pos = read_varint(np.frombuffer(block, np.uint8))
    ntags = 0
    hist = {"le16": 0, "gt16": 0, "copy_le16": 0, "copy_gt16": 0, "off_lt8": 0}
    while pos < len(block):
        t = block[pos]
        tt = t & 3
        if tt == 0:
            l6 = t >> 2
            if l6 < 60:
                ln = l6 + 1
                pos += 1 + ln
            else:
                e = l6 - 59
                ln = int.from_bytes(block[pos + 1 : pos + 1 + e], "little") + 1
                pos += 1 + e + ln
            hist["le16" if ln <= 16 else "gt16"] += 1
        else:
            if tt == 1:
                ln = ((t >> 2) & 7) + 4
                off = ((t >> 5) << 8) | block[pos + 1]
                pos += 2
            elif tt == 2:
                ln = (t >> 2) + 1
                off = int.from_bytes(block[pos + 1 : pos + 3], "little")
                pos += 3
            else:
                ln = (t >> 2) + 1
                off = int.from_bytes(block[pos + 1 : pos + 5], "little")
                pos += 5
            hist["copy_le16" if ln <= 16 else "copy_gt16"] += 1
            if off < 8:
                hist["off_lt8"] += 1
        ntags += 1
    return ntags, hist


def build_blocks(B: int = 128):
    """B blocks of 64 KiB of the word mix and their compressed forms:
    (frags uint8 [B, 65536], comp uint8 [B, cap], lens int32 [B], tag count
    of block 0, its tag mix); cap is the longest block rounded up to 1 KiB."""
    import chip_smoke
    from snappier_tpu_torch.format import oracle

    html = chip_smoke.word_mix()
    reps = -(-B * BLOCK_SIZE // len(html))
    frags = np.frombuffer((html * reps)[: B * BLOCK_SIZE], np.uint8).reshape(B, BLOCK_SIZE)
    blocks = [bytes(oracle.compress(frags[i])) for i in range(B)]
    lens = np.array([len(x) for x in blocks], np.int32)
    cap = -(-(int(lens.max()) + 8) // 1024) * 1024
    comp = np.zeros((B, cap), np.uint8)
    for i, x in enumerate(blocks):
        comp[i, : len(x)] = np.frombuffer(x, np.uint8)
    ntags, hist = tag_mix(blocks[0])
    return frags, comp, lens, ntags, hist


def timeit(fn, iters: int = 5, passes: int = 3) -> float:
    """Best seconds per call over ``passes`` runs of ``iters`` calls, by CUDA
    events around the runs."""
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
        best = min(best, start.elapsed_time(end) / iters / 1e3)
    return best


def blocks_in_flight(smem_bytes: int) -> int:
    """How many one-warp blocks with that much dynamic shared memory the
    card runs at once."""
    per_sm = max(1, SMEM_PER_SM // (smem_bytes + SMEM_PER_BLOCK_RESERVED))
    return SMS * min(per_sm, 32)


def variant_fn(name: str, comp_d, lens_d):
    """(the call to time, its kernel's layout or None for tensor code)."""
    from snappier_tpu_torch.ops.cuda import decode_variants as dv
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc
    from snappier_tpu_torch.ops.decode import decode_blocks_scan

    if name == "v0":
        return (lambda: sc.decode_blocks_bytes(comp_d, lens_d, BLOCK_SIZE)), sc.decode_layout(
            comp_d, BLOCK_SIZE)
    if name == "scan":
        return (lambda: decode_blocks_scan(comp_d, lens_d, BLOCK_SIZE)), None
    if name in ("v2", "v3", "v4"):
        fn = getattr(dv, f"decode_{name}")
        call = lambda: fn(comp_d, lens_d, BLOCK_SIZE)  # noqa: E731
    else:
        call = lambda: dv.decode_variant(comp_d, lens_d, BLOCK_SIZE, name)  # noqa: E731
    return call, dv.decode_variant_layout(comp_d, BLOCK_SIZE, name)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-B", "--blocks", type=int, default=128)
    ap.add_argument("variants", nargs="*", default=list(VARIANT_NAMES))
    args = ap.parse_args()
    unknown = [v for v in args.variants if v not in VARIANT_NAMES]
    if unknown:
        ap.error(f"unknown variants {unknown}: choose from {VARIANT_NAMES}")
    if not torch.cuda.is_available():
        print("torch_perf_probe: no CUDA device; the probe times kernels on a GPU",
              file=sys.stderr)
        return 2

    import chip_smoke

    print(chip_smoke.card_line())
    B = args.blocks
    frags, comp, lens, ntags, hist = build_blocks(B)
    comp_d = torch.from_numpy(comp).cuda()
    lens_d = torch.from_numpy(lens).cuda()
    gb = B * BLOCK_SIZE / 1e9
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"B={B} blocks, row width {comp.shape[1]}, {ntags} tags/block, mix={hist}")

    for v in args.variants:
        fn, layout = variant_fn(v, comp_d, lens_d)
        outs, out_lens, errs = fn()
        torch.cuda.synchronize()
        ok = int(errs.max()) == 0
        if ok and v != "v1nocp":
            for b in (0, B - 1):
                ok = ok and bool((outs[b].cpu().numpy().astype(np.uint8) == frags[b]).all())
        t = timeit(fn)
        if layout is None:
            waves, in_flight = 1, B
            per_block = t / B
        else:
            in_flight = sms * layout["blocks_per_sm"]
            waves = -(-B // in_flight)
            per_block = t / waves
        print(
            f"{v}: {'OK ' if ok else 'BAD'} {t * 1e3:.3f} ms total, "
            f"{per_block * 1e6:.0f} us/block, {gb / t:.3f} GB/s, "
            f"{per_block / ntags * 1e9:.0f} ns/tag "
            f"(blocks_in_flight {in_flight}, waves {waves})",
            flush=True,
        )
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
