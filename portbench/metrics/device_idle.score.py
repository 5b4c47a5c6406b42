"""device_idle.score: the share of the traced scoring window in which no
operation ran on the card, in percent (the profiler's trace)."""


def read(run):
    tr = run["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
