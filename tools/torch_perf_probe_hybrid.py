#!/usr/bin/env python3
"""Descriptor-driven decode probe and hybrid micro-probes for the
PyTorch/CUDA port (run on an NVIDIA GPU; port of ``tools/perf_probe_hybrid.py``).

A pre-pass kernel decodes the tag at every byte position into a
descriptor; the walk reads one descriptor per tag (``ops/cuda/decode_hybrid.py``,
``csrc/decode_hybrid.cu``). Each form is checked first (error words all
zero, blocks 0, 1, B/2 and B-1 equal to the input), then timed with CUDA
events (warm-up, best of 3 passes of 5 calls), pre-pass included.

Usage, from the repository root:
    python3 tools/torch_perf_probe_hybrid.py [-B N] [probe ...]
Probes:
  v5       prepass_v5 (one int32 descriptor per byte, the rows read a byte at
           a time) + the decode kernel's batched walk over the descriptors
  v5parts  the same, the pre-pass and the walk (decode_v5_spec) timed apart
  v6       prepass_v6 (the same descriptor, word rows read as words) + v5's walk
  v7       prepass_v7 (two arrays, one validity test per tag) + the same walk
  v7u      v7 with two batches per loop iteration
Micro-probes (``ops/cuda/hybrid_probes.py``, ``csrc/hybrid_probes.cu``,
``csrc/bitonic_probe.cu``) on block 0:
  chain       200 walks ip += adv[ip] over the block's advance array
  chainrec    the same walk storing a packed record per step
  vcopy2d     the per-record vector copy body, 2 x the block's tags records
  vcopy3d     the same in the 3d body (tile-aligned rows)
  coissueN    the scalar chain beside N tile updates a step (N: 0, 1, 2, 8)
  coissuevec  the tile warps at 8 updates a step and no chain (the vector stream alone)
  iso:MODE    one part of the copy body alone, 20 x the block's tags records
              (MODE: scalar, dynload, dynload8, statroll, dynroll, full)
  bprobeN     524,288 iterations of a mix and N conditional stores (N: 0, 1,
              2, 3, 4, 8; 0 is three select-stores)
  bfloor      bprobe's mix alone over the same iterations: the floor of its
              chain
  cliff:MODE  chain's 200 walks with a body per tag into an image (MODE:
              when1, when2, fori, store4, load4)
  chase       cliff's walk with no body: the latency floor of a walk step
  bitonic     one merge pass (16 stages) of a bitonic network over 65,536
              keys and their indices, beside torch.sort (a full stable sort:
              not the same function)

The blocks are ``tools/torch_perf_probe.py::build_blocks`` (the seeded word
mix that ``chip_smoke.py`` drives, at the tight row width). The first line
is the card's name and power limit. For the decode probes, the next gives
the batch, the row width, the tag count of block 0 and its tag mix; then one
line per probe: ms per call, us per block, GB/s of output and ns per tag,
where a block's time is the call's time over the waves of blocks the card
runs at once (as ``decode_hybrid_layout`` gives it). Each
micro-probe is held to its plain version (checksum and records, image,
tile, scratch or indices), then its kernel alone is timed and the JAX
tool's line printed.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from snappier_tpu_torch.ops.cuda import hybrid_probes as hp  # noqa: E402

BLOCK_SIZE = 65536
DECODE_PROBES = ("v5", "v5parts", "v6", "v7", "v7u")
MICRO_PROBES = ("chain", "chainrec", "vcopy2d", "vcopy3d", "coissue0", "coissue1", "coissue2",
                "coissue8", "coissuevec", *(f"iso:{m}" for m in hp.ISO_MODES),
                *(f"bprobe{n}" for n in hp.BPROBE_NWHEN), "bfloor",
                *(f"cliff:{m}" for m in hp.CLIFF_MODES),
                "chase", "bitonic")
PROBES = DECODE_PROBES + MICRO_PROBES
DEFAULT = DECODE_PROBES + ("chain", "chainrec", "vcopy2d", "vcopy3d", "coissue0", "coissue8")


def check_probe(name: str) -> None:
    """Raise ValueError for a name this tool does not run."""
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}: choose from {', '.join(PROBES)}")


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

    _, comp, lens, _, _ = build_blocks(1)
    block = comp[0, : lens[0]].tobytes()
    adv, n, ntags = hp.chain_inputs(block)
    recs = hp.tags_from_block(block)[1]
    rec, irec = hp.vcopy_records(recs), hp.iso_records(recs)
    count = int(rec[hp.COUNT_AT])
    img = np.arange(hp.IMAGE_WORDS, dtype=np.int32)
    keys = np.random.default_rng(5).integers(-(2**31), 2**31 - 1, hp.SORT_SHAPE,
                                             np.int64).astype(np.int32)  # the JAX tool's
    host = {k: torch.from_numpy(v) for k, v in
            dict(adv=adv, rec=rec, irec=irec, img=img, keys=keys).items()}
    d = {k: v.cuda() for k, v in host.items()}
    fill = torch.full(hp.TILE, hp.FILL, dtype=torch.int32, device="cuda")
    dev = torch.device("cuda")
    R = hp.CHAIN_R
    staged = hp.cliff_staged_words(host["adv"], n, 3)
    ok = True
    for p in names:
        if p.startswith("chain"):
            wr = p == "chainrec"
            got = hp.chain(d["adv"], n, 3, R, wr)
            want = hp.chain_plain(host["adv"], n, 3, R, wr)
            fn = lambda wr=wr: hp.launch_chain(d["adv"], n, 3, R, wr, staged)  # noqa: E731
            line = lambda t: (f"{p}: {t * 1e3:.3f} ms for {R} walks of {ntags} tags "  # noqa: E731
                              f"-> {t / R / ntags * 1e9:.1f} ns/tag")
        elif p.startswith("vcopy"):
            mode = p[-2:]
            got = hp.vcopy(d["rec"], d["img"], mode)
            want = hp.vcopy_plain(host["rec"], host["img"], mode)
            fn = lambda mode=mode: hp.launch_vcopy(d["rec"], d["img"], mode)  # noqa: E731
            line = lambda t: (f"vcopy[{mode}]: {t * 1e3:.3f} ms for {count} records "  # noqa: E731
                              f"-> {t / count * 1e9:.1f} ns/record")
        elif p == "coissuevec":
            got = hp.coissue_vec(fill)
            want = hp.coissue_vec_plain()
            fn = lambda: hp.launch_coissue_vec(fill)  # noqa: E731
            line = lambda t: (f"coissue vector stream alone: {t * 1e3:.3f} ms for "  # noqa: E731
                              f"{hp.COISSUE_ITERS} iters -> "
                              f"{t / hp.COISSUE_ITERS * 1e9:.1f} ns/iter")
        elif p.startswith("coissue"):
            nvec = int(p[len("coissue"):])
            got = hp.coissue(3, nvec, fill)
            want = hp.coissue_plain(3, nvec)
            fn = lambda nvec=nvec: hp.launch_coissue(3, nvec, fill)  # noqa: E731
            line = lambda t: (f"coissue[nvec={nvec}]: {t * 1e3:.3f} ms for "  # noqa: E731
                              f"{hp.COISSUE_ITERS} iters -> "
                              f"{t / hp.COISSUE_ITERS * 1e9:.1f} ns/iter")
        elif p.startswith("iso:"):
            mode = p[len("iso:"):]
            got = hp.iso(d["irec"], d["img"], mode)
            want = hp.iso_plain(host["irec"], host["img"], mode)
            fn = lambda mode=mode: hp.launch_iso(d["irec"], d["img"], mode)  # noqa: E731
            line = lambda t: (f"iso[{mode}]: {t * 1e3:.3f} ms for "  # noqa: E731
                              f"{hp.ISO_PASSES}x{ntags} records -> "
                              f"{t / hp.ISO_PASSES / ntags * 1e9:.1f} ns/record")
        elif p.startswith("bprobe"):
            nwhen = int(p[len("bprobe"):])
            got = hp.bprobe(nwhen)
            want = hp.bprobe_plain(nwhen)
            fn = lambda nwhen=nwhen: hp.launch_bprobe(nwhen, 3, dev)  # noqa: E731
            line = lambda t: (f"bprobe[nwhen={nwhen}]: "  # noqa: E731
                              f"{t / hp.BPROBE_ITERS * 1e9:.1f} ns/iter")
        elif p == "bfloor":
            got = (hp.bprobe_floor(3, dev),)
            want = (hp.bprobe_floor_plain(3),)
            fn = lambda: hp.launch_bprobe_floor(3, dev)  # noqa: E731
            line = lambda t: f"bprobe floor: {t / hp.BPROBE_ITERS * 1e9:.1f} ns/iter"  # noqa: E731
        elif p.startswith("cliff:"):
            mode = p[len("cliff:"):]
            got = hp.cliff(d["adv"], n, mode, 3, R)
            want = hp.cliff_plain(host["adv"], n, mode, 3, R)
            fn = lambda mode=mode: hp.launch_cliff(d["adv"], n, mode, 3, R, staged)  # noqa: E731
            line = lambda t: f"cliff[{mode}]: {t / R / ntags * 1e9:.1f} ns/tag"  # noqa: E731
        elif p == "chase":
            got = (hp.chase(d["adv"], n, 3, R),)
            want = (hp.chain_plain(host["adv"], n, 3, R)[0],)
            fn = lambda: hp.launch_chase(d["adv"], n, 3, R, staged)  # noqa: E731
            line = lambda t: f"chase: {t / R / ntags * 1e9:.1f} ns/tag"  # noqa: E731
        else:  # bitonic, beside the library's full sort of the same keys
            got = hp.bitonic(d["keys"])
            want = hp.bitonic_plain(host["keys"])
            fn = lambda: hp.launch_bitonic(d["keys"])  # noqa: E731
            flat = d["keys"].reshape(-1)
            srt = torch.sort(flat, stable=True)
            ok_s = bool((srt.values.cpu().numpy() == np.sort(keys.reshape(-1))).all())
            t_s = timeit(lambda: torch.sort(flat, stable=True))
            line = lambda t: (f"bitonic 64K merge pass (16 of 136 stages): "  # noqa: E731
                              f"{t * 1e6:.0f} us; torch.sort (key+val, a full sort, not the same function): "
                              f"{'OK' if ok_s else 'BAD'} {t_s * 1e6:.0f} us")
        same = all(bool((a.cpu() == b).all()) for a, b in zip(got, want))
        if not same:
            print(f"{p}: kernel differs from its plain version", file=sys.stderr)
            ok = False
            continue
        print(line(timeit(fn)), flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-B", "--blocks", type=int, default=128)
    ap.add_argument("probes", nargs="*", default=list(DEFAULT))
    args = ap.parse_args()
    for p in args.probes:
        try:
            check_probe(p)
        except ValueError as e:
            ap.error(str(e))

    import torch

    if not torch.cuda.is_available():
        print("torch_perf_probe_hybrid: no CUDA device; the probe times kernels on a GPU",
              file=sys.stderr)
        return 2

    import chip_smoke
    from torch_perf_probe import build_blocks, timeit

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
    in_flight = {f: 132 * dh.decode_hybrid_layout(comp_d, BLOCK_SIZE, f[:2])["blocks_per_sm"]
                 for f in DECODE_PROBES}
    waves = {f: -(-B // n) for f, n in in_flight.items()}
    gb = B * BLOCK_SIZE / 1e9
    print(f"B={B} blocks, row width {cc}, {ntags} tags/block, mix={hist}, "
          f"blocks_in_flight {in_flight}, waves {waves}")

    def report(label: str, t: float, ok: bool | None = None) -> None:
        per_block = t / waves[label.split()[0]]
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
        t_pre = timeit(lambda: (dh.prepass_v5(comp_d), dh.pack_words(comp_d)))
        print(f"v5 pre-pass alone: {t_pre * 1e3:.3f} ms ({t_pre / B * 1e6:.1f} us/block)",
              flush=True)
        words, spec = dh.pack_words(comp_d), dh.prepass_v5(comp_d)
        k_out, k_lens, k_errs = dh.decode_v5_spec(words, spec, lens_d, BLOCK_SIZE)
        torch.cuda.synchronize()
        k_ok = int(k_errs.max()) == 0 and bool((k_out == outs).all())
        bad = bad or not k_ok
        report("v5 kernel alone", timeit(lambda: dh.decode_v5_spec(words, spec, lens_d,
                                                                    BLOCK_SIZE)), k_ok)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
