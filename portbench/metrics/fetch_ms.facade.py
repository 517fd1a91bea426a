"""Host milliseconds per facade call inside the program's span
``block.fetch``: the fetch of the bodies: packed and compacted on the
card, copied to the host and split into rows."""

from portbench import spans


def read(rec):
    return spans.host_ms(rec, "block.fetch", "compress")
