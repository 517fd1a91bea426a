"""The share of the facade calls' wall time in which the card ran
nothing: the host's part of each call and the waits between."""

from portbench import roofline


def read(rec):
    return roofline.idle_pct(rec, "compress")
