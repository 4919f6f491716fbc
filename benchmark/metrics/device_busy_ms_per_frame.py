"""Milliseconds in which the card ran a kernel, copy or memset (the union
of their intervals in the window), per frame posed in the window."""


def read(td):
    if td.frames <= 0 or not td.busy:
        return None
    return 1e3 * td.busy_s / td.frames
