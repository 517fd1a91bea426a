"""The greedy encode walk's share of its byte roofline over the compress
phases: true input bytes read once and compressed bytes written once over
3.35 TB/s, divided by the phases' device-busy time (the union of all
device activity, whatever kernel ran it)."""

from portbench import roofline


def read(rec):
    return roofline.phases_share(rec, "compress")
