"""Host milliseconds per facade call inside the program's span
``block.wait``: the host blocked until the body lengths come back from the
card, behind the candidate search and the encode walk, and their check."""

from portbench import spans


def read(rec):
    return spans.host_ms(rec, "block.wait", "compress")
