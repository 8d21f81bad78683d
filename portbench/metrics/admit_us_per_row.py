"""admit_us_per_row: the program's span ``mirror.bookkeep`` (the
mirror's per-row bookkeeping) summed over set-up, over the rows
admitted there, in microseconds a row."""


def read(r):
    total = r.spans.get("mirror.bookkeep")
    if not total:
        return None
    return total / int(r.config["rows"]) * 1e6
