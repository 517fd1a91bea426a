"""Device milliseconds per decompress call inside the program's span
``codec.decode``: the decode walk's launch on the card's stream, timed by
the span's CUDA events."""

from portbench import spans


def read(rec):
    return spans.device_ms(rec, "codec.decode", "decompress")
