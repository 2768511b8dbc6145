"""Mean milliseconds of a decode engine's step that ran the model, from
its call to its return (which follows the argmax's copy to the host)."""
from harness import readers


def read(run):
    return readers.mean_ms(readers.spans_in_window(run, "decode"))
