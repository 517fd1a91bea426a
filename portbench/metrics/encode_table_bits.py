"""The match table's width in hash bits at which the greedy encode kernel
ran, over the run's launches of it (the program's count of launches by
table width, ``ENCODE_TABLE_BITS``). The table decides how far back a walk
finds its matches, and so the compressed size. It reads nothing from a
program that keeps no such count or launched no encode kernel."""


def read(rec):
    from snappier_tpu_torch.ops.cuda import _build

    counts = getattr(_build, "ENCODE_TABLE_BITS", None)
    n = sum(counts.values()) if counts else 0
    if not n:
        return None
    return sum(bits * k for bits, k in counts.items()) / n
