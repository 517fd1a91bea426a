#!/usr/bin/env python3
"""Pipelined-decode and encode-restructuring probe for the PyTorch/CUDA port
(run on an NVIDIA GPU; port of ``tools/perf_probe_r4.py``).

Decode: the TPU tool's pipelined walks, each on the production kernel's
batched walk (``csrc/decode_pipe.cu``): ``pipe`` is the production
function, ``pipe2`` takes a literal of no bytes and carries the tool's
knobs as their counterparts there. Encode: the production walk in named
restructurings. Each variant is checked against the production kernels
every run, then timed with CUDA events (warm-up, best of 3 passes of 5
calls).

Usage, from the repository root: python3 tools/torch_perf_probe_r4.py [B] [variant ...]
Decode variants (default: base pipe):
  base       the production kernel (csrc/decode.cu)
  pipe       decode_pipe: the production walk and function in csrc/decode_pipe.cu
  pipe2u1..pipe2u4   decode_pipe2, 1 to 4 batches parsed a loop iteration
  pipe2unc   pipe2u2 with each batch's last round of output stored whole
  pipe2unc2  pipe2u2 with every round left in that step stored whole too
  pipe2dma   pipe2unc with the finished row drained by a bulk asynchronous copy
  denoemit   pipe2u2 handing no batch on (the walk's floor; only errors are checked)
Encode variants: encbase (csrc/encode.cu) and the names of
``snappier_tpu_torch.ops.cuda.encode_variants.R4_VARIANTS``. A variant that
gives the production encoder's bytes is held to them on every block; one
that is another valid encoding is decoded by the decode kernel and reports
its size as a share of production's; ``encnoemit`` is held to the lengths
of the walk it counts; ``encdmaonly`` is only timed.
``encstats`` (csrc/encode_stats.cu) prints the JAX tool's line, the
encoder's budget per block on average (miss iterations, hits, extension
iterations, matched bytes), after holding block 0 to the plain walk, and
then its time.

The blocks are the seeded word mix that ``chip_smoke.py`` drives. The first
line is the card's name and power limit, the second the batch and the tag
count of block 0. Decode lines: ms per call, us per block, ns per tag, MB/s;
a block's time is the call's time over the waves of blocks the card runs.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

BLOCK_SIZE = 65536
DECODE_VARIANTS = {
    "pipe2u1": dict(unroll=1), "pipe2u2": dict(unroll=2), "pipe2u3": dict(unroll=3),
    "pipe2u4": dict(unroll=4), "pipe2unc": dict(unroll=2, unc=1),
    "pipe2unc2": dict(unroll=2, unc=2), "pipe2dma": dict(unroll=2, unc=1, dma_pipe=True),
    "denoemit": dict(unroll=2, emit=False),
}


def _html_blocks(B: int):
    """B blocks of 64 KiB of the word mix: (frags uint8 [B, 65536], lengths
    int32 [B])."""
    import torch_perf_probe_enc

    return torch_perf_probe_enc.build_blocks(B)


def main() -> int:
    import torch

    import chip_smoke
    import torch_perf_probe as base
    from snappier_tpu_torch.ops.cuda import decode_variants as dv
    from snappier_tpu_torch.ops.cuda import encode_variants as ev
    from snappier_tpu_torch.ops.cuda import scalar_codec as sc

    argv = sys.argv[1:]
    B = int(argv.pop(0)) if argv and argv[0].isdigit() else 512
    variants = argv or ["base", "pipe"]
    known = {"base", "pipe", "encbase", "encstats", *DECODE_VARIANTS, *ev.R4_VARIANTS}
    unknown = [v for v in variants if v not in known]
    if unknown:
        print(f"unknown variants {unknown}: choose from {sorted(known)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_perf_probe_r4: no CUDA device; the probe times kernels on a GPU",
              file=sys.stderr)
        return 2

    print(chip_smoke.card_line())
    frags, lengths = _html_blocks(B)
    fd, ld = torch.from_numpy(frags).cuda(), torch.from_numpy(lengths).cuda()
    bodies, blens = sc.encode_blocks_bytes(fd, ld)
    pre = torch.tensor([0x80, 0x80, 0x04], dtype=torch.uint8, device="cuda").expand(B, 3)

    def as_blocks(bodies, body_lens):
        """Bodies under a varint(65536) preamble, at the tight row width."""
        width = -(-(int(body_lens.max()) + 3 + 8) // 1024) * 1024
        rows = torch.cat([pre, bodies], dim=1)[:, :width].contiguous()
        return rows, body_lens + 3

    bd, bl = as_blocks(bodies, blens)
    one = bd[0, : int(bl[0])].cpu().numpy().tobytes()
    tags, _ = base.tag_mix(one)
    print(f"B={B}, row width {bd.shape[1]}, tags/block={tags}")

    # K2, encode_stats and the named walks keep the table alone in shared
    # memory: the occupancy each launch reports.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stats_in_flight = sms * ev.encode_stats_layout(fd)["blocks_per_sm"]
    k2_in_flight = sms * sc.encode_layout(fd)["blocks_per_sm"]
    if "encstats" in variants:
        st = ev.encode_stats(fd, ld)
        want = ev.encode_stats_plain(fd[:1].cpu(), ld[:1].cpu())
        assert bool((st[:1].cpu() == want).all()), "encstats differs from its plain walk"
        tot = st.sum(dim=0).double().cpu().numpy() / B
        print(f"encstats (per block avg): miss_iters={tot[0]:.0f} hits={tot[1]:.0f} "
              f"ext_iters={tot[2]:.0f} match_bytes={tot[3]:.0f} "
              f"(ext iters/hit={tot[2] / max(tot[1], 1):.2f}, "
              f"match len avg={tot[3] / max(tot[1], 1):.1f})")
        t = base.timeit(lambda: ev.encode_stats(fd, ld))
        print(f"encstats: {t * 1e3:.3f} ms/batch, {t / -(-B // stats_in_flight) * 1e6:.1f} "
              f"us/block", flush=True)
        variants = [x for x in variants if x != "encstats"]
    for v in [x for x in variants if x.startswith("enc")]:
        if v == "encbase":
            efn = lambda: sc.encode_blocks_bytes(fd, ld)  # noqa: E731
        else:
            efn = lambda v=v: ev.encode_r4(fd, ld, v)  # noqa: E731
        eb, el = efn()
        torch.cuda.synchronize()
        note = ""
        if v == "encdmaonly":
            note = " (one read of each fragment and the launch alone, no walk)"
        elif v == "encnoemit":
            _, want = ev.encode_r4(fd, ld, "enccopywhen")
            assert bool((el == want).all()), f"{v} body_lens mismatch"
        elif v == "encbase" or v in ev.R4_PRODUCTION_BYTES:
            assert bool((el == blens).all()), f"{v} body_lens mismatch"
            keep = torch.arange(eb.shape[1], device="cuda")[None, :] < el[:, None]
            assert bool(((eb == bodies[:, : eb.shape[1]]) | ~keep).all()), f"{v} bytes mismatch"
        else:
            # Another valid encoding: decode it and report its size.
            rows, rl = as_blocks(eb, el)
            dout, dol, derr = sc.decode_blocks_bytes(rows, rl, BLOCK_SIZE)
            assert int(derr.max()) == 0, f"{v} decode err"
            assert bool((dout == fd).all()), f"{v} roundtrip mismatch"
            note = f", size {float(el.sum()) / float(blens.sum()) * 100:.2f}% of base"
        t = base.timeit(efn)
        waves = -(-B // (k2_in_flight if v == "encbase"
                         else sms * ev.encode_r4_layout(fd, v)["blocks_per_sm"]))
        print(f"{v}: {t * 1e3:.3f} ms/batch, {t / waves * 1e6:.1f} us/block, "
              f"{B * BLOCK_SIZE / t / 1e6:.1f} MB/s{note}", flush=True)

    ref_out = None
    for v in [x for x in variants if not x.startswith("enc")]:
        if v == "base":
            fn = lambda: sc.decode_blocks_bytes(bd, bl, BLOCK_SIZE)  # noqa: E731
            layout = sc.decode_layout(bd, BLOCK_SIZE)
        elif v == "pipe":
            fn = lambda: dv.decode_pipe(bd, bl, BLOCK_SIZE)  # noqa: E731
            layout = dv.decode_pipe_layout(bd, BLOCK_SIZE, fold=False)
        else:
            kw = DECODE_VARIANTS[v]
            fn = lambda kw=kw: dv.decode_pipe2(bd, bl, BLOCK_SIZE, **kw)  # noqa: E731
            layout = dv.decode_pipe_layout(bd, BLOCK_SIZE, **kw)
        out, olens, errs = fn()
        torch.cuda.synchronize()
        assert int(errs.max()) == 0, v
        if v != "denoemit":  # no payload stores: the rows are unspecified
            assert bool((out == fd).all()), f"{v} output mismatch"
            if ref_out is None:
                ref_out = out
            else:
                assert bool((out == ref_out).all()), f"{v} output mismatch"
        t = base.timeit(fn)
        in_flight = sms * layout["blocks_per_sm"]
        per_block = t / -(-B // in_flight)
        print(f"{v}: {t * 1e3:.3f} ms/batch, {per_block * 1e6:.1f} us/block, "
              f"{per_block / tags * 1e9:.1f} ns/tag, {B * BLOCK_SIZE / t / 1e6:.1f} MB/s "
              f"(blocks_in_flight {in_flight})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
