"""All compressed bytes the window's compress phases produced, each row's
or stream's varint preamble included, over the bytes they took."""


def read(rec):
    ph = [p for p in rec.phases if p["kind"] == "compress"]
    n = sum(p["bytes_in"] for p in ph)
    return sum(p["bytes_out"] for p in ph) / n if n else None
