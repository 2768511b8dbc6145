"""Generated tokens delivered in the window (first tokens included), over
the window's length."""
from harness import readers


def read(run):
    return readers.tokens_in_window(run) / (run.w1 - run.w0)
