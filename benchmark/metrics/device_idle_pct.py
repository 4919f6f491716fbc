"""Share of the window in which no kernel, copy or memset ran on the card
(the union of their intervals from the profiler's trace), in percent."""


def read(td):
    if td.window_s <= 0 or not td.busy:
        return None
    return 100.0 * (1.0 - td.busy_s / td.window_s)
