"""Fixtures shared by the benchmark's CPU tests (a test module imports
them): a small configuration and mix of each kind, on the Cornell scene
(446 triangles), run on the CPU through the program's plain torch
versions."""

from __future__ import annotations

import copy

import pytest


@pytest.fixture(scope="session", autouse=True)
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def small_assets(tmp_path_factory):
    """Scene assets of the small configurations in a folder of their own."""
    from render_bench import scene

    folder = tmp_path_factory.mktemp("assets")
    old = scene.ASSET_DIR
    scene.ASSET_DIR = folder
    yield folder
    scene.ASSET_DIR = old


@pytest.fixture(scope="session")
def small_cell(small_assets):
    """The helpers ``(small, run_small)``; the check reads 2 frames of
    2,048 pixels."""
    from render_bench import check

    old = check.FRAMES, check.PIXELS
    check.FRAMES, check.PIXELS = 2, 2048
    yield small, run_small
    check.FRAMES, check.PIXELS = old


def small(kind: str):
    """(configuration, mix) of a small cell of ``kind`` (a traffic name):
    the Cornell scene at 96 x 64, its path seen from above the boxes, each
    stop a visible step from the last."""
    from render_bench import cell

    cfg = copy.deepcopy(cell.config("sponza_rt_1080p"))
    if kind in ("sun_moving", "sun_static"):
        cfg.update(mode="raster", shadow_size=128)
    cfg.update(name=f"cornell_{cfg['mode']}", resolution=[96, 64], static_point_lights=1,
               scene={"generator": "cornell_like_scene", "triangles": 446},
               lights=[[[0.0, 4.0, -5.0], [400.0, 400.0, 400.0]]], far_share_max=0.01)
    mix = copy.deepcopy(cell.traffic(kind))
    mix.update(start=[0.0, 4.0, 3.0], step=[0.4, 0.0, 0.0], pitch=-25.0, yaw=-90.0,
               yaw_step=4.0, viewpoints=4)
    return cfg, mix


def run_small(kind: str, seconds: float = 1.5, seed: int = 2**31 + 11, plant=None):
    """One CPU run of a small cell, with the plant of render_bench/plant.py
    named ``plant`` under the timed path."""
    import time

    import torch

    from render_bench import cell
    from render_bench import plant as plants
    from render_bench import run as harness

    cfg, mix = small(kind)
    metrics = cell.benchmark()["end_to_end"]
    run = harness.Run(cfg, mix, seed, torch.device("cpu"), t0=time.perf_counter())
    with plants.planted(plant):
        return harness.run_cell(run, seconds, False, metrics)
