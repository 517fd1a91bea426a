"""Device milliseconds per compress call inside the program's span
``codec.encode``: the greedy encode walk (and the CRC where the codec takes
one) on the card's stream, timed by the span's CUDA events."""

from portbench import spans


def read(rec):
    return spans.device_ms(rec, "codec.encode", "compress")
