"""Host milliseconds per facade call inside the program's span
``block.join``: the preamble and the fetched bodies joined into the
returned ``bytes``."""

from portbench import spans


def read(rec):
    return spans.host_ms(rec, "block.join", "compress")
