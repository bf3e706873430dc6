"""Scene file dispatch — the `arctic <scene>` load path (main.cpp:18-22);
port of arctic_tpu/io/load.py."""

from __future__ import annotations

import os

import numpy as np

from arctic_tpu_torch.io.images import load_hdr
from arctic_tpu_torch.io.procedural import gradient_environment


def load_scene_file(path: str, env_path: str | None = None):
    """-> (meshes, objects, materials, environment).

    The reference hard-codes its HDRI (renderer.cpp:113, not shipped with
    it); the environment is ``env_path``, else the first ``.hdr`` in sorted
    order next to the scene, else the procedural sky."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".gltf", ".glb"):
        from arctic_tpu_torch.io.gltf import load_gltf

        meshes, objects, materials = load_gltf(path)
    elif ext == ".obj":
        from arctic_tpu_torch.io.obj import load_obj

        meshes, objects, materials = load_obj(path)
    else:
        raise ValueError(f"unsupported scene format: {path}")

    env = None
    if env_path:
        env = load_hdr(env_path)
    else:
        folder = os.path.dirname(os.path.abspath(path))
        for cand in sorted(os.listdir(folder)):
            if cand.lower().endswith(".hdr"):
                env = load_hdr(os.path.join(folder, cand))
                break
    if env is None:
        env = gradient_environment(256, 512)
    return meshes, objects, materials, np.asarray(env, np.float32)
