"""pipeline.autotune_pair_caps over the seed's path, host seconds ending in a device synchronise."""


def read(run):
    return run.setup_parts.get("caps_tune_s")
