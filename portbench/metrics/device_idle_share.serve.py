"""Device, in a serving cell: the share of the traced window in which no
operation ran on the card, in %."""


def read(seen):
    if seen.records.get("kind") != "serve" or not seen.busy_s:
        return None
    return (1 - seen.busy_s / seen.trace_window_s) * 100
