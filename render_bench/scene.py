"""A configuration's scene: generated, written once per checkout as the
asset a user would load (GLB + Radiance .hdr under build/render_bench/),
and loaded back through the program's loader on every run. The reference
takes the generator's arrays and reads the .hdr itself."""

from __future__ import annotations

import os

from render_bench.cell import ROOT

ASSET_DIR = ROOT / "build" / "render_bench"


def asset_paths(cfg: dict):
    folder = ASSET_DIR / cfg["name"]
    return folder / "scene.glb", folder / "env.hdr"


def triangles(meshes, objects) -> int:
    """Triangles of the scene's object instances."""
    return sum(len(meshes[mesh].indices) for _, mesh in objects)


def generate(cfg: dict):
    """(meshes, objects, materials, environment) as the configuration's
    generator makes them."""
    from arctic_tpu_torch.io import procedural

    spec = cfg["scene"]
    return getattr(procedural, spec["generator"])(**spec.get("args", {}))


def write_asset(cfg: dict) -> None:
    """The configuration's scene as GLB + HDR, written under temporary
    names and renamed, so that a run cut short leaves no half file."""
    from arctic_tpu_torch.io.gltf_export import save_glb
    from arctic_tpu_torch.io.images import save_hdr

    spec = cfg["scene"]
    meshes, objects, materials, env = generate(cfg)
    glb, hdr = asset_paths(cfg)
    glb.parent.mkdir(parents=True, exist_ok=True)
    save_glb(str(glb) + ".part", meshes, objects, materials)
    save_hdr(str(hdr) + ".part", env)
    os.replace(str(hdr) + ".part", hdr)
    os.replace(str(glb) + ".part", glb)
    n_tris = triangles(meshes, objects)
    if n_tris != spec["triangles"]:
        raise RuntimeError(f"{spec['generator']} made {n_tris} triangles, the configuration "
                           f"states {spec['triangles']}")


def load(cfg: dict):
    """(meshes, objects, materials, environment) as the program's loader
    reads the asset; the asset is written first where it is missing."""
    from arctic_tpu_torch.io.load import load_scene_file

    glb, hdr = asset_paths(cfg)
    if not (glb.exists() and hdr.exists()):
        write_asset(cfg)
    scene = load_scene_file(str(glb), env_path=str(hdr))
    n_tris = triangles(scene[0], scene[1])
    if n_tris != cfg["scene"]["triangles"]:
        raise RuntimeError(f"{glb} holds {n_tris} triangles, the configuration states "
                           f"{cfg['scene']['triangles']}")
    return scene


def reference_scene(cfg: dict, device):
    """The reference's scene, made apart from the program's loader: the
    generator's arrays (what the asset's float32 accessors and lossless
    PNGs hold) and the environment read from the asset's .hdr by the
    reference's own reader."""
    from render_bench import reference

    meshes, objects, materials, _ = generate(cfg)
    _, hdr = asset_paths(cfg)
    return reference.Scene(meshes, objects, materials, reference.read_hdr(hdr), device=device)
