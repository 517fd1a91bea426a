"""Host milliseconds per facade call inside the program's span
``block.fragment``: the host cutting the object into zero-padded 64 KiB
rows (``_fragment_rows``)."""

from portbench import spans


def read(rec):
    return spans.host_ms(rec, "block.fragment", "compress")
