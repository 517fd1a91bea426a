"""Host milliseconds per facade call inside the program's span
``block.copy_in``: the copy of the rows and their lengths from pageable
host memory to the card."""

from portbench import spans


def read(rec):
    return spans.host_ms(rec, "block.copy_in", "compress")
