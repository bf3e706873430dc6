"""The check's reference and its failures on the CPU: the reference stands
alone, the control (the reference in bfloat16 in the program's place)
fails the check, and so does a run whose timed path is broken."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from render_bench import reference
from render_bench.tests.small import one_torch_thread, small_assets, small_cell  # noqa: F401

BENCH_DIR = Path(__file__).resolve().parents[1]


def test_reference_imports_nothing_of_the_program():
    tree = ast.parse((BENCH_DIR / "reference.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "math", "numpy", "torch"}
    code = ("import sys; import render_bench.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'arctic_tpu', 'arctic_tpu_torch', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=BENCH_DIR.parent, check=True)
    assert out.stdout.strip() == "[]"


def test_the_reference_reads_the_hdr_the_program_writes(tmp_path):
    import numpy as np

    from arctic_tpu_torch.io.images import load_hdr_np, save_hdr

    env = np.random.default_rng(3).random((5, 7, 3)).astype(np.float32) * 40.0
    env[0, 0] = 0.0
    save_hdr(str(tmp_path / "env.hdr"), env)
    got = reference.read_hdr(tmp_path / "env.hdr")
    assert got.shape == (5, 7, 3)
    assert np.array_equal(got, load_hdr_np(str(tmp_path / "env.hdr")))
    assert np.all(np.abs(got - env) <= env.max(axis=-1, keepdims=True) * 2 ** -7)


@pytest.mark.parametrize("kind", ["sun_moving", "fly"])
def test_the_control_fails_the_check(kind, small_cell):
    """The bfloat16 reference in the program's place, through the run."""
    _, run_small = small_cell
    out = run_small(kind, plant="control")
    assert out["correct"] is False
    far = out["checks"]["far_px_share"]
    assert far["value"] > 3 * far["max"]


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("kind", ["sun_moving", "fly"])
def test_a_broken_timed_path_is_not_correct(kind, fault, small_cell):
    _, run_small = small_cell
    out = run_small(kind, plant=fault)
    assert out["correct"] is False
    far = out["checks"]["far_px_share"]
    assert far["value"] > far["max"]


def test_frames_without_the_light_shadow_rays_are_not_correct(small_cell):
    _, run_small = small_cell
    out = run_small("light_shadows", plant="no_light_shadows")
    assert out["correct"] is False
    far = out["checks"]["far_px_share"]
    assert far["value"] > far["max"]
