#!/usr/bin/env python3
"""Where the card's time goes inside the port's one-shot stream calls.

Run from the repository root on a machine with one CUDA card:

    python3 tools/torch_stream_profile.py [MiB] [--kernel scalar|scan]

``--kernel`` sets ``SNAPPIER_KERNEL`` before the port reads it, so the same
trace can be taken of the stream calls on the parallel-scan engine (tensor
code: many small device operations instead of two kernels per sub-batch);
the default is the port's own choice. It makes the seeded buffer of ``chip_smoke.py`` phase 6 (64 KiB chunks of
the word mix, every eighth of random bytes; 128 MiB unless told otherwise),
warms ``snappier_tpu_torch.stream_compress`` / ``stream_decompress`` up,
then runs each once under ``torch.profiler`` and prints one JSON line per
call: host wall-clock, the summed device time of kernels and copies, their
share of the wall-clock (the rest is the card idle while the host works),
and the device time by kernel name; then once more under ``cProfile`` and
prints the host functions with the most time of their own. It prints the
card's name and power limit first. If the profiler records no device time
(no CUPTI access), it says so and exits 3; CUDA-event times are in
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pathlib
import pstats
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mib", nargs="?", type=int, default=128)
    ap.add_argument("--kernel", choices=("scalar", "scan"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stream_profile: no CUDA device", file=sys.stderr)
        return 2
    if args.kernel:
        os.environ["SNAPPIER_KERNEL"] = args.kernel  # read once, at the first stream call
    import chip_smoke
    import snappier_tpu_torch as st
    from snappier_tpu_torch.models.codec import default_kernel

    mib = args.mib
    print(chip_smoke.card_line())
    print(json.dumps({"kernel": default_kernel(), "MiB": mib}))
    raw = chip_smoke.stream_bytes(mib * 16)
    framed = st.stream_compress(raw)
    if st.stream_decompress(framed) != raw:
        raise AssertionError("stream round trip differs")
    for name, fn in (("stream_compress", lambda: st.stream_compress(raw)),
                     ("stream_decompress", lambda: st.stream_decompress(framed))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name = {}
        for e in prof.key_averages():
            # Device activities only (kernels, copies): a host operator's
            # entry repeats the device time of the kernels it launched.
            if "CUDA" not in str(getattr(e, "device_type", "CUDA")):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
        device_ms = sum(by_name.values())
        if device_ms == 0:
            print("the profiler recorded no device time", file=sys.stderr)
            return 3
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
        print(json.dumps({
            "call": name, "bytes": len(raw), "wall_ms_under_profiler": wall_ms,
            "device_ms": device_ms, "device_share_of_wall": device_ms / wall_ms,
            "device_ms_by_name": top,
        }))
        host = cProfile.Profile()
        t0 = time.perf_counter()
        host.runcall(fn)
        wall_ms = (time.perf_counter() - t0) * 1e3
        stats = pstats.Stats(host).stats  # (file, line, name) -> (cc, nc, tottime, cumtime, ...)
        own = sorted(((v[2] * 1e3, f"{pathlib.Path(k[0]).name}:{k[1]}({k[2]})", v[1])
                      for k, v in stats.items()), reverse=True)[:6]
        print(json.dumps({
            "call": name, "wall_ms_under_cprofile": wall_ms,
            "host_own_ms": [{"function": f, "ms": ms, "calls": n} for ms, f, n in own],
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
