"""Per call: its wall time less the device-busy time inside it, averaged
over the traced window's calls; the facade's host work (fragmenting, the
copy to the card, the fetch and the join) and the waits between."""


def read(rec):
    ph = [p for p in rec.phases if p["kind"] == "compress" and p.get("busy_s") is not None]
    if not ph:
        return None
    host = sum((p["t1_trace"] - p["t0_trace"]) - p["busy_s"] for p in ph)
    return 1e3 * host / sum(p["calls"] for p in ph)
