"""Metric readers, one file a metric (dots in its name become underscores):
``read(run) -> float | None``. None leaves the metric out of the run's
line: a reader that finds nothing to read returns it, never 0."""


def per_frame(run, value):
    """A traced burst's total over its frames."""
    return value / run.trace["frames"]


def kernel_seconds(run, fragment: str) -> float:
    """Device seconds of the burst's kernels whose name holds ``fragment``."""
    return sum(s for name, s in run.trace["kernel_s"].items() if fragment in name)
