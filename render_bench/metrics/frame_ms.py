"""Wall time of the window (ending in a device synchronise) over the frames
completed in it."""


def read(run):
    return run.window_s / run.n_frames * 1e3
