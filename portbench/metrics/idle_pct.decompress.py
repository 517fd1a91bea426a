"""The share of the decompress phases' wall time in which the card ran
nothing."""

from portbench import roofline


def read(rec):
    return roofline.idle_pct(rec, "decompress")
