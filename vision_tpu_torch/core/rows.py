"""Packed table rows: one indexing fetches every column a lane reads.

The JAX package fetches a table's columns for a lane through one fused
fetch (`vision_tpu/core/gather.py` `fetch_rows`): the columns are stacked
into one float32 matrix, ids and flags included (exact below 2^24). The
port keeps that layout, so a shading step pays one gather launch for a
row instead of one per column.
"""
from __future__ import annotations

import torch


def gather_rows(table, idx):
    """table[idx] along the leading axis. A 1-D index goes through
    index_select, whose backward adds into the table with index_add (atomic
    adds on the card) where indexing's backward first sorts the indices:
    with 262,144 lanes reading a table of a few rows, that sort-based
    kernel took 99% of a gradient step's device time on an H100. The same
    one gather in the forward."""
    if idx.dim() == 1:
        return table.index_select(0, idx)
    return table[idx]


class PackedRows:
    """`spec` = ((column name, width), ...) of `table` (a record, or a dict
    of columns), stacked in that order into `rows` [N, C] float32."""

    def __init__(self, table, spec):
        cols = {k: table[k] if isinstance(table, dict) else getattr(table, k)
                for k, _ in spec}
        n = cols[spec[0][0]].shape[0]
        self.rows = torch.cat([cols[k].reshape(n, -1).to(torch.float32)
                               for k, _ in spec], dim=1)
        self.slices, o = {}, 0
        for k, w in spec:
            self.slices[k] = (o, o + w, w == 1)
            o += w

    def fetch(self, idx):
        """Rows `idx` [...] -> a reader: col(name) is [...] for a width-1
        column, else [..., width] (float32; cast ids back)."""
        g = gather_rows(self.rows, idx)

        def col(k):
            lo, hi, scalar = self.slices[k]
            return g[..., lo] if scalar else g[..., lo:hi]
        return col
