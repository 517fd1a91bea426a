"""Device milliseconds per facade call inside the program's span
``best.candidates``: the candidate search (the fingerprints, and a sort and
a scatter a width) on the card's stream, timed by the span's CUDA events."""

from portbench import spans


def read(rec):
    return spans.device_ms(rec, "best.candidates", "compress")
