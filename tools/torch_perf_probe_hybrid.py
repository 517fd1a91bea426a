#!/usr/bin/env python3
"""Descriptor-driven decode probe for the PyTorch/CUDA port (run on an
NVIDIA GPU; port of the decode probes of ``tools/perf_probe_hybrid.py``).

A tensor pre-pass decodes the tag at every byte position into a descriptor;
the walk reads one descriptor per tag (``ops/cuda/decode_hybrid.py``,
``csrc/decode_hybrid.cu``). Each form is checked first (error words all
zero, blocks 0, 1, B/2 and B-1 equal to the input), then timed with CUDA
events (warm-up, best of 3 passes of 5 calls), pre-pass included.

Usage, from the repository root:
    python3 tools/torch_perf_probe_hybrid.py [-B N] [probe ...]
Probes:
  v5       spec_from_comp (one int32 descriptor per byte) + the walk
  v5parts  the same, the pre-pass and the walk (decode_v5_spec) timed apart
  v6       spec_from_words (the descriptor from the word image) + v5's walk
  v7       spec2_from_words (two arrays, one validity test per tag) + its walk
  v7u      v7 with two tags per loop iteration

The JAX tool's other probes (chain, chainrec, vcopy2d, vcopy3d, coissueN,
iso:MODE, bprobeN, cliff:MODE, bitonic) are not ported yet: naming one is an
error. The blocks are ``tools/torch_perf_probe.py::build_blocks`` (the seeded
word mix that ``chip_smoke.py`` drives, at the tight row width). The first
line is the card's name and power limit; the second the batch, the row
width, the tag count of block 0 and its tag mix. Then one line per probe:
ms per call, us per block, GB/s of output and ns per tag, where a block's
time is the call's time over the waves of blocks the card runs at once.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

BLOCK_SIZE = 65536
PROBES = ("v5", "v5parts", "v6", "v7", "v7u")
NOT_PORTED = ("chain", "chainrec", "vcopy2d", "vcopy3d", "coissue", "iso:", "bprobe", "cliff:",
              "bitonic")


def check_probe(name: str) -> None:
    """Raise for a probe of the JAX tool that has no port yet; argparse
    refuses any other unknown name."""
    if name not in PROBES and name.startswith(NOT_PORTED):
        raise NotImplementedError(f"probe {name!r} of tools/perf_probe_hybrid.py is not ported "
                                  f"yet: this tool runs {', '.join(PROBES)}")


def form_fn(name: str, comp_d, lens_d):
    """The call that decodes the batch by one form, pre-pass included."""
    from snappier_tpu_torch.ops.cuda import decode_hybrid as dh

    if name in ("v5", "v5parts"):
        return lambda: dh.decode_v5(comp_d, lens_d, BLOCK_SIZE)
    if name == "v6":
        return lambda: dh.decode_v6(comp_d, lens_d, BLOCK_SIZE)
    return lambda: dh.decode_v7(comp_d, lens_d, BLOCK_SIZE, unroll2=name == "v7u")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-B", "--blocks", type=int, default=128)
    ap.add_argument("probes", nargs="*", default=list(PROBES))
    args = ap.parse_args()
    for p in args.probes:
        check_probe(p)
    unknown = [p for p in args.probes if p not in PROBES]
    if unknown:
        ap.error(f"unknown probes {unknown}: choose from {PROBES}")

    import torch

    if not torch.cuda.is_available():
        print("torch_perf_probe_hybrid: no CUDA device; the probe times kernels on a GPU",
              file=sys.stderr)
        return 2

    import chip_smoke
    from torch_perf_probe import blocks_in_flight, build_blocks, timeit

    from snappier_tpu_torch.ops.cuda import decode_hybrid as dh

    print(chip_smoke.card_line())
    B = args.blocks
    frags, comp, lens, ntags, hist = build_blocks(B)
    comp_d = torch.from_numpy(comp).cuda()
    lens_d = torch.from_numpy(lens).cuda()
    cc = comp.shape[1]
    in_flight = blocks_in_flight(dh.smem_bytes(cc, BLOCK_SIZE))
    waves = -(-B // in_flight)
    gb = B * BLOCK_SIZE / 1e9
    print(f"B={B} blocks, row width {cc}, {ntags} tags/block, mix={hist}, "
          f"blocks_in_flight {in_flight}, waves {waves}")

    def report(label: str, t: float, ok: bool | None = None) -> None:
        per_block = t / waves
        verdict = "" if ok is None else ("OK  " if ok else "BAD ")
        print(f"{label}: {verdict}{t * 1e3:.3f} ms, {per_block * 1e6:.0f} us/block, "
              f"{gb / t:.3f} GB/s, {per_block / ntags * 1e9:.0f} ns/tag", flush=True)

    bad = False
    for p in args.probes:
        fn = form_fn(p, comp_d, lens_d)
        outs, out_lens, errs = fn()
        torch.cuda.synchronize()
        ok = int(errs.max()) == 0
        for b in (0, 1, B // 2, B - 1):
            ok = ok and bool((outs[b].cpu().numpy() == frags[b]).all())
        bad = bad or not ok
        if p != "v5parts":
            report(p, timeit(fn), ok)
            continue
        # The pre-pass alone (descriptors and the word image, as the JAX
        # tool's `pre`), then the kernel alone on its result.
        t_pre = timeit(lambda: (dh.spec_from_comp(comp_d), dh.pack_words(comp_d)))
        print(f"v5 pre-pass alone: {t_pre * 1e3:.3f} ms ({t_pre / B * 1e6:.1f} us/block)",
              flush=True)
        words, spec = dh.pack_words(comp_d), dh.spec_from_comp(comp_d)
        k_out, k_lens, k_errs = dh.decode_v5_spec(words, spec, lens_d, BLOCK_SIZE)
        torch.cuda.synchronize()
        k_ok = int(k_errs.max()) == 0 and bool((k_out == outs).all())
        bad = bad or not k_ok
        report("v5 kernel alone", timeit(lambda: dh.decode_v5_spec(words, spec, lens_d,
                                                                    BLOCK_SIZE)), k_ok)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
