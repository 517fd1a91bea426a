"""Device time per call of every kernel that is not one of the program's
own CUDA kernels (``portbench/own_kernels.json``): the library's sorts,
scatters and elementwise kernels of the candidate search."""


def read(rec):
    ph = [p for p in rec.phases if p["kind"] == "compress" and p.get("kernels") is not None]
    if not ph:
        return None
    foreign = sum(s for p in ph for name, s in p["kernels"].items() if not rec.is_own_kernel(name))
    return 1e3 * foreign / sum(p["calls"] for p in ph)
