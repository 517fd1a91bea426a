#!/usr/bin/env python3
"""Encode-walk ablation probe for the PyTorch/CUDA port (run on an NVIDIA
GPU; port of ``tools/perf_probe_enc.py``).

Variants of the greedy encode walk, timed on B x 64 KiB blocks with CUDA
events (warm-up, best of 3 passes of 5 calls), each checked first: the first
and last block decoded by the oracle to the input, unless the variant emits
nothing.

Usage, from the repository root: python3 tools/torch_perf_probe_enc.py [-B N] [variant ...]
Variants:
  e0    the production kernel (csrc/encode.cu, 15 hash bits), the baseline
  e1    seeding merged into the extension loop (14 hash bits from here on)
  e2    e1 + the tail of up to 3 bytes from one XOR of two windows
  e3    e2 + a copy tag that always stores 3 bytes
  e4    e3 without emission (walk and extension only)
  eb, ec, ebc   the unmerged walk with the branch-free tail, copy tag, both
  e6    stride-8 extension, branch-free tail and copy tag
  e6a   e6 + a miss advances by the probe width
  e7    e6a + an eight-wide probe; e7n, e6n: e7, e6a without emission
  e9    e3 with 2 table stores per probe; e10: e3 at 13 hash bits;
  e11   e3 at 12 hash bits with 2 stores
  edma  no walk: one read of each fragment and the launch alone
Any other name is read as a flag tuple joined by commas (merged,btail,st2).

The blocks are the seeded word mix that ``chip_smoke.py`` drives. The first
line is the card's name and power limit. Then one line per variant: ms per
call, us per block, GB/s of input and the compression ratio, where a block's
time is the call's time over the waves of blocks the card runs
(``blocks_in_flight``: the SMs times the blocks an SM holds, the occupancy
the launch reports, ``encode_variants.encode_variant_layout`` and, for e0,
``scalar_codec.encode_layout``; every variant keeps the match table alone
in shared memory, as e0 does, so 14 hash bits let six blocks share an SM
and 15 three).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

BLOCK_SIZE = 65536


def build_blocks(B: int = 128):
    """B blocks of 64 KiB of the word mix: (frags uint8 [B, 65536], lengths
    int32 [B])."""
    import chip_smoke

    html = chip_smoke.word_mix()
    reps = -(-B * BLOCK_SIZE // len(html))
    frags = np.frombuffer((html * reps)[: B * BLOCK_SIZE], np.uint8).reshape(B, BLOCK_SIZE)
    return frags.copy(), np.full(B, BLOCK_SIZE, np.int32)


def variant_fn(name: str, frags_d, lens_d):
    """(the call to time, its launch layout, whether it emits tags)."""
    from snappier_tpu_torch.ops.cuda import encode_variants as ev
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc

    if name == "e0":
        return (lambda: sc.encode_blocks_bytes(frags_d, lens_d)), sc.encode_layout(frags_d), True
    flags = ev.VARIANT_FLAGS.get(name) or tuple(f for f in name.split(",") if f)
    return ((lambda: ev.encode_variant(frags_d, lens_d, flags)),
            ev.encode_variant_layout(frags_d, flags), "noemit" not in flags)


def main() -> int:
    import torch

    import chip_smoke
    import torch_perf_probe as base
    from snappier_tpu_torch.format import oracle

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-B", "--blocks", type=int, default=128)
    ap.add_argument("variants", nargs="*", default=["e0", "e1", "e2", "e3", "e4"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_perf_probe_enc: no CUDA device; the probe times kernels on a GPU",
              file=sys.stderr)
        return 2

    print(chip_smoke.card_line())
    B = args.blocks
    frags, lengths = build_blocks(B)
    frags_d, lens_d = torch.from_numpy(frags).cuda(), torch.from_numpy(lengths).cuda()
    gb = B * BLOCK_SIZE / 1e9
    pre = bytes([0x80, 0x80, 0x04])  # varint 65536

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for v in args.variants:
        fn, layout, emits = variant_fn(v, frags_d, lens_d)
        bodies, body_lens = fn()
        torch.cuda.synchronize()
        bl = body_lens.cpu().numpy()
        ok = True
        if emits:
            for b in (0, B - 1):
                body = bodies[b, : bl[b]].cpu().numpy().tobytes()
                ok = ok and oracle.decompress(np.frombuffer(pre + body, np.uint8)) == \
                    frags[b].tobytes()
        t = base.timeit(fn)
        in_flight = sms * layout["blocks_per_sm"]
        waves = -(-B // in_flight)
        print(
            f"{v}: {'OK ' if ok else 'BAD'} {t * 1e3:.3f} ms total, "
            f"{t / waves * 1e6:.0f} us/block, {gb / t:.3f} GB/s, "
            f"ratio {bl.sum() / (B * BLOCK_SIZE):.4f} "
            f"(blocks_in_flight {in_flight}, waves {waves})",
            flush=True,
        )
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
