"""K2, the paged decode-attention kernel (``paged_split_kernel``): as K1's,
over the keys below each row's length, plus the page-table entries that
map them."""
from harness import readers, work


def read(run):
    block = 16
    return readers.roofline_pct(
        run, "paged_split_kernel",
        lambda lengths: work.decode_attention_bytes(
            run.arch.attention_widths(run.model), lengths)
        + work.page_table_bytes(lengths, block))
