"""K1, the dense decode-attention kernel (``dense_split_kernel``): its
byte bound over the traced decode steps, as a percentage of its device
time.  Bytes: the K and V below each row's length, q, the output and the
lengths, read or written once, at the card's published bandwidth."""
from harness import readers, work


def read(run):
    return readers.roofline_pct(
        run, "dense_split_kernel",
        lambda lengths: work.decode_attention_bytes(
            run.arch.attention_widths(run.model), lengths))
