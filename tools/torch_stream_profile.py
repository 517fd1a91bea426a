#!/usr/bin/env python3
"""Where the card's time goes inside the port's one-shot stream calls.

Run from the repository root on a machine with one CUDA card:

    python3 tools/torch_stream_profile.py [MiB]

It makes the seeded buffer of ``chip_smoke.py`` phase 6 (64 KiB chunks of
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

import cProfile
import json
import pathlib
import pstats
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_stream_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import snappier_tpu_torch as st

    mib = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    print(chip_smoke.card_line())
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
