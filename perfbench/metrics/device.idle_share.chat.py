"""Share of the traced sub-window in which no operation ran on the device:
1 - (union of device operations) / window."""
from harness import readers


def read(run):
    return readers.idle_share(run)
