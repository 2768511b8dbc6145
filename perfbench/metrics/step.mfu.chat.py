"""Model FLOPs of the whole window (every prompt pass and every decode
step, attention at each length) over the window at the card's published
bf16 peak, in percent."""
from harness import readers


def read(run):
    return readers.step_mfu_pct(run)
