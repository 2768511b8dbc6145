"""Share of the window's prompt blocks resumed from the prefix cache
(``PrefillStats.reused_blocks / total_blocks``)."""
from harness import readers


def read(run):
    total = readers.stat_delta(run, "total_blocks")
    if total <= 0:
        return None
    return readers.stat_delta(run, "reused_blocks") / total
