"""raytrace.build_scene_bvh, host seconds ending in a device synchronise."""


def read(run):
    return run.setup_parts.get("bvh_build_s")
