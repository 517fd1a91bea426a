#!/usr/bin/env python3
"""Descriptor-driven decode probe and hybrid micro-probes for the
PyTorch/CUDA port (run on an NVIDIA GPU; port of ``tools/perf_probe_hybrid.py``
but for its isolation, branch, cliff and sort probes).

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
Micro-probes (``ops/cuda/hybrid_probes.py``, ``csrc/hybrid_probes.cu``) on
block 0:
  chain     200 walks ip += adv[ip] over the block's advance array
  chainrec  the same walk storing a packed record per step
  vcopy2d   the per-record vector copy body, 2 x the block's tags records
  vcopy3d   the same in the 3d body (tile-aligned rows)
  coissueN  the scalar chain beside N tile updates a step (N: 0, 1, 2, 8)

The JAX tool's other probes (iso:MODE, bprobeN, cliff:MODE, bitonic) are not
ported yet: naming one is an error. The blocks are
``tools/torch_perf_probe.py::build_blocks`` (the seeded word mix that
``chip_smoke.py`` drives, at the tight row width). The first line is the
card's name and power limit. For the decode probes, the next gives the
batch, the row width, the tag count of block 0 and its tag mix; then one
line per probe: ms per call, us per block, GB/s of output and ns per tag,
where a block's time is the call's time over the waves of blocks the card
runs at once. Each micro-probe is held to its plain version (checksum and
records, image or tile), then its kernel alone is timed and the JAX tool's
line printed: ms for R walks and ns per step; ms and ns per record; ms and
ns per iteration.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

BLOCK_SIZE = 65536
DECODE_PROBES = ("v5", "v5parts", "v6", "v7", "v7u")
MICRO_PROBES = ("chain", "chainrec", "vcopy2d", "vcopy3d", "coissue0", "coissue1", "coissue2",
                "coissue8")
PROBES = DECODE_PROBES + MICRO_PROBES
NOT_PORTED = ("iso:", "bprobe", "cliff:", "bitonic")


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


def run_micro(names) -> bool:
    """Each micro-probe on block 0: held to its plain version, then timed;
    prints the JAX tool's line. Returns False if one differs."""
    if not names:
        return True
    import torch
    from torch_perf_probe import build_blocks, timeit

    from snappier_tpu_torch.ops.cuda import hybrid_probes as hp

    _, comp, lens, _, _ = build_blocks(1)
    block = comp[0, : lens[0]].tobytes()
    adv, n, ntags = hp.chain_inputs(block)
    rec = hp.vcopy_records(hp.tags_from_block(block)[1])
    count = int(rec[hp.COUNT_AT])
    img = np.arange(hp.IMAGE_WORDS, dtype=np.int32)
    adv_d, rec_d, img_d = (torch.from_numpy(x).cuda() for x in (adv, rec, img))
    fill = torch.full(hp.TILE, hp.FILL, dtype=torch.int32, device="cuda")
    R = hp.CHAIN_R
    ok = True
    for p in names:
        if p.startswith("chain"):
            wr = p == "chainrec"
            got = hp.chain(adv_d, n, 3, R, wr)
            want = hp.chain_plain(torch.from_numpy(adv), n, 3, R, wr)
            fn = lambda wr=wr: hp.launch_chain(adv_d, n, 3, R, wr)  # noqa: E731
        elif p.startswith("vcopy"):
            mode = p[-2:]
            got = hp.vcopy(rec_d, img_d, mode)
            want = hp.vcopy_plain(torch.from_numpy(rec), torch.from_numpy(img), mode)
            fn = lambda mode=mode: hp.launch_vcopy(rec_d, img_d, mode)  # noqa: E731
        else:
            nvec = int(p[len("coissue"):])
            got = hp.coissue(3, nvec, fill)
            want = hp.coissue_plain(3, nvec)
            fn = lambda nvec=nvec: hp.launch_coissue(3, nvec, fill)  # noqa: E731
        same = all(bool((a.cpu() == b).all()) for a, b in zip(got, want))
        if not same:
            print(f"{p}: kernel differs from its plain version", file=sys.stderr)
            ok = False
            continue
        t = timeit(fn)
        if p.startswith("chain"):
            print(f"{p}: {t * 1e3:.3f} ms for {R} walks of {ntags} tags "
                  f"-> {t / R / ntags * 1e9:.1f} ns/tag", flush=True)
        elif p.startswith("vcopy"):
            print(f"vcopy[{mode}]: {t * 1e3:.3f} ms for {count} records "
                  f"-> {t / count * 1e9:.1f} ns/record", flush=True)
        else:
            print(f"coissue[nvec={nvec}]: {t * 1e3:.3f} ms for {hp.COISSUE_ITERS} iters "
                  f"-> {t / hp.COISSUE_ITERS * 1e9:.1f} ns/iter", flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-B", "--blocks", type=int, default=128)
    ap.add_argument("probes", nargs="*", default=list(DECODE_PROBES) + [
        p for p in MICRO_PROBES if p not in ("coissue1", "coissue2")])
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
    bad = not run_micro([p for p in args.probes if p in MICRO_PROBES])
    decode = [p for p in args.probes if p in DECODE_PROBES]
    if not decode:
        return 1 if bad else 0
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

    for p in decode:
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
