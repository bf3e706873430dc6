"""The program's asset load and scene build (io/load,
io/build.build_buffers), host seconds ending in a device synchronise."""


def read(run):
    return run.setup_parts.get("scene_build_s")
