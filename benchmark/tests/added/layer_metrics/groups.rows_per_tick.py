"""``groups.rows_per_tick``: delta rows of the window's applied writes
over the ticks that committed them."""


def read(run):
    rows = sum(w.info["rows"] for w in run.in_window)
    return rows / run.ticks if run.ticks and rows else None
