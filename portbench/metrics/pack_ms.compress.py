"""Device milliseconds per compress call inside the program's span
``codec.pack``: ``compress_batch_packed``'s copy of the bodies into
word-packed rows, on the card's stream, timed by the span's CUDA events."""

from portbench import spans


def read(rec):
    return spans.device_ms(rec, "codec.pack", "compress")
