"""Mean host ms of a frame call in the window (no synchronise around it:
the time the host spends in the program's frame, waits it makes included)."""


def read(run):
    return sum(run.host_ms) / len(run.host_ms)
