"""Host seconds from the start of run.py to the first timed frame: the
program's kernels loaded (built in a checkout's first run), the scene
loaded and built, the entry's set-up and the warm-up frames."""


def read(run):
    return run.setup_s
