"""Share of the traced window in which no device operation ran: 1 - the
union of kernel, copy and fill intervals over the window, in %."""


def read(run):
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
