"""The port's app layer on the CPU: `python -m arctic_tpu_torch.app.cli
render` (``--device cpu``), the state files, FlyCamera, FrameStats, the
shared dict -> RenderConfig rule and the render guard.

The CLI's PNG must equal the port's in-process frame of the same scene and
config bit for bit, and be >= 40 dB against the port's f64 oracle
(test_golden_psnr's gate). Frames are 96x64 with a 96^2 shadow map; no JAX
frame is rendered (the JAX package is compared with only where no frame is
needed: state files, FlyCamera, FrameStats).
"""

import dataclasses
import json
import re
import time

import numpy as np
import pytest
import torch

from arctic_tpu.app.camera import FlyCamera as JFlyCamera
from arctic_tpu.core.scene import default_scene_params as j_default_params
from arctic_tpu.utils import serialize as jserialize
from arctic_tpu.utils.profiling import FrameStats as JFrameStats
from arctic_tpu_torch.app.camera import FlyCamera
from arctic_tpu_torch.app.cli import main
from arctic_tpu_torch.core.config import RenderConfig, config_from_dict
from arctic_tpu_torch.core.scene import (
    PointLights,
    default_scene_params,
    default_settings,
    make_camera,
)
from arctic_tpu_torch.io import build, gltf_export, images, load, procedural
from arctic_tpu_torch.models import golden, pipeline
from arctic_tpu_torch.utils import kernels, profiling, serialize
from arctic_tpu_torch.utils.errors import (
    RenderError,
    debug_checks_enabled,
    enable_debug_checks,
    render_guard,
)

W, H, SHADOW = 96, 64, 96
EYE, ROT = [0.0, 4.0, 3.0], [-25.0, -90.0]
BASE = ["render", "--width", str(W), "--height", str(H), "--shadow-size", str(SHADOW),
        "--camera=0,4,3,-25,-90", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The suite runs test files in several processes at once; an
    oversubscribed torch thread pool slows these small CPU frames by orders
    of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _render(argv, out):
    """Run the CLI; the RGB of its PNG (None when it wrote one per frame)."""
    assert main(BASE + argv + ["--out", str(out)]) == 0
    return None if "--frames" in argv else images.load_ldr(str(out))[..., :3]


def _in_process(scene, config=None, tm=0, lights=None):
    """The port's frame of ``scene`` as the CLI renders it: tuned pair
    caps and the light count static (not under force_bruteforce);
    ``lights``: a PointLights bank in place of the default one."""
    meshes, objects, materials, env = scene
    bufs = build.build_buffers(meshes, objects, materials, env, device="cpu")
    params = default_scene_params(aspect=W / H)
    params.camera = make_camera(EYE, ROT, W / H)
    if lights is not None:
        params.point_lights = lights
    settings = default_settings()
    settings.tm_method = tm
    config = config or RenderConfig(width=W, height=H, shadow_size=SHADOW)
    if not config.force_bruteforce:
        config = pipeline.autotune_pair_caps(bufs, params, config)
        config = dataclasses.replace(config, static_point_lights=params.point_lights.count)
    img, stats = pipeline.make_renderer_stats(config, "cpu")(bufs, params, settings)
    pipeline.check_stats(stats)
    return img.numpy(), params, settings


def _oracle_db(img, scene, params, settings):
    meshes, objects, materials, env = scene
    tris, mats = golden.golden_scene(meshes, objects, materials)
    c, s, pl = params.camera, params.sun, params.point_lights
    gold = golden.render(
        tris, mats, env.astype(np.float64),
        dict(eye=c.eye.tolist(), rotation=c.rotation.tolist(), aspect=float(c.aspect),
             fov_y=float(c.fov_y), z_near=float(c.z_near), z_far=float(c.z_far)),
        dict(position=s.position.tolist(), rotation=s.rotation.tolist(), color=s.color.tolist()),
        [(pl.position[i].tolist(), pl.color[i].tolist()) for i in range(pl.count)],
        ambient=float(params.ambient),
        settings=dict(tm_method=settings.tm_method, gamma=float(settings.gamma),
                      exposure=float(settings.exposure)),
        width=W, height=H, shadow_size=SHADOW,
    )
    return golden.psnr(img, gold)


@pytest.mark.parametrize("source", ["procedural", "glb"])
def test_cli_renders_cornell(tmp_path, source):
    """Cornell, built in or exported to a GLB with its environment as an
    .hdr beside it: the CLI's PNG is the in-process frame of the same
    (loaded) scene, and >= 40 dB against the f64 oracle."""
    if source == "procedural":
        scene = procedural.cornell_like_scene()
        argv = ["--procedural", "cornell"]
    else:
        meshes, objects, materials, env = procedural.cornell_like_scene()
        glb = tmp_path / "cornell.glb"
        gltf_export.save_glb(str(glb), meshes, objects, materials)
        images.save_hdr(str(tmp_path / "env.hdr"), env)
        scene = load.load_scene_file(str(glb))
        argv = [str(glb)]
    img = _render(argv, tmp_path / "f.png")
    want, params, settings = _in_process(scene)
    assert img.shape == (H, W, 3) and img.std() > 10
    np.testing.assert_array_equal(img, want)
    db = _oracle_db(img, scene, params, settings)
    assert db >= 40.0, f"CLI frame PSNR {db:.2f} dB < 40 dB"


def test_cli_config_shadow_tile_and_ignored_fields(tmp_path):
    """A --config holding the JAX package's raster_chunk / select_chunk /
    tiles_per_step (which change no pixel) and its default shadow tile
    renders the default config's frame, bit for bit, and so does one with a
    128-wide, 32-high shadow tile; a tile the JAX package refuses raises
    before the scene is built."""
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(dict(raster_chunk=64, select_chunk=32, tiles_per_step=4,
                                   shadow_tile=64, shadow_tile_h=None, fused_shade=True)))
    base = _render(["--procedural", "cornell"], tmp_path / "a.png")
    tuned = _render(["--procedural", "cornell", "--config", str(cfg)], tmp_path / "b.png")
    np.testing.assert_array_equal(tuned, base)
    cfg.write_text(json.dumps(dict(shadow_tile=128, shadow_tile_h=32)))
    tiled = _render(["--procedural", "cornell", "--config", str(cfg)], tmp_path / "c.png")
    np.testing.assert_array_equal(tiled, base)
    cfg.write_text(json.dumps(dict(shadow_tile=24)))
    with pytest.raises(RenderError, match="shadow tile .* 128-pixel rows"):
        main(["render", str(tmp_path / "missing.glb"), "--device", "cpu", "--config", str(cfg)])


@pytest.fixture
def debug_checks_off():
    enable_debug_checks(False)
    yield
    enable_debug_checks(False)


@pytest.mark.parametrize("argv", [
    ["--devices", "2"], ["--debug-checks"],
], ids=lambda a: a[0])
def test_cli_sharding_and_debug_flags_render(tmp_path, argv, debug_checks_off):
    """--devices 2 (two gloo processes on the CPU, rank 0 writing the PNG)
    and --debug-checks render the in-process frame of the default config,
    bit for bit; --debug-checks leaves the checks on."""
    img = _render(["--procedural", "cornell"] + argv, tmp_path / "f.png")
    want, _, _ = _in_process(procedural.cornell_like_scene())
    assert img.shape == (H, W, 3) and img.std() > 10
    np.testing.assert_array_equal(img, want)
    assert debug_checks_enabled() == (argv[0] == "--debug-checks")


def test_cli_devices_on_cuda_needs_the_cards(tmp_path, monkeypatch):
    """--devices N on cuda with fewer cards raises RenderError naming both
    counts before the scene is read (no CPU or gloo stand-in)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RenderError, match="3 ranks on cuda need 3 CUDA devices; this machine has 1"):
        main(["render", str(tmp_path / "missing.glb"), "--devices", "3", "--device", "cuda"])


# A spotlight over the Cornell boxes aimed down (tests/test_spotlights.py:29).
SPOT = ((0.0, 6.0, -5.0), (120.0, 120.0, 120.0), ((0.0, -1.0, 0.0), 20.0, 35.0))
SPOT_ARG = "0,6,-5,120,120,120,0,-1,0,20,35"


@pytest.mark.parametrize("flag", ["--bruteforce", "--ibl", "--spot"])
def test_cli_ported_flags_render(tmp_path, flag):
    """--bruteforce, --ibl and --spot render on the CPU: the PNG equals the
    in-process frame of the config the flag asks for (brute force with no
    pair-cap tuning; the spotlight appended to the default light as a cone
    row), the brute-force run calls no kernel wrapper, and the opt-ins
    change the default frame."""
    scene = procedural.cornell_like_scene()
    argv = ["--procedural", "cornell", flag] + ([SPOT_ARG] if flag == "--spot" else [])
    with kernels.record_calls() as calls:
        img = _render(argv, tmp_path / "f.png")
    base = RenderConfig(width=W, height=H, shadow_size=SHADOW)
    lights = None
    if flag == "--bruteforce":
        config = dataclasses.replace(base, force_bruteforce=True)
        assert calls == {}
    elif flag == "--ibl":
        config = dataclasses.replace(base, ibl_specular=True)
    else:
        config = dataclasses.replace(base, spotlights=True)
        lights = PointLights.from_list([((0.0, 1.0, 0.0), (10.0, 0.0, 0.0)), SPOT], spots=True)
    want, _, _ = _in_process(scene, config, lights=lights)
    assert img.shape == (H, W, 3) and img.std() > 10
    np.testing.assert_array_equal(img, want)
    if flag != "--bruteforce":
        assert set(calls) >= {"raster_tiles", "pack_shade_rows", "select_interp", "tap_resolve"}
        default, _, _ = _in_process(scene)
        assert np.abs(img.astype(int) - default.astype(int)).max() > 2


@pytest.mark.parametrize(
    "field", ["force_bruteforce", "fused_shade", "ibl_specular", "spotlights", "debug_overflow",
              "rt_light_shadows", "hdr_half_round", "sun_frustum_cull"]
)
def test_config_ported_fields(field):
    """Each field ported with the deferred frame, the opt-ins, the f16 HDR
    round and the sun-frustum cull reaches RenderConfig, off its JAX
    default, through config_from_dict and through convert.render_config."""
    from arctic_tpu.core.config import RenderConfig as JRenderConfig
    from arctic_tpu_torch.utils import convert

    default = getattr(JRenderConfig(), field)
    assert getattr(RenderConfig(), field) == default
    assert getattr(config_from_dict({field: not default}), field) is (not default)
    tc = convert.render_config(JRenderConfig(**{field: not default}))
    assert tc == dataclasses.replace(RenderConfig(), **{field: not default})


def test_config_tex_group_caps():
    """tex_group_caps reaches RenderConfig as a tuple of ints, from a JSON
    list (the CLI's --config) and through convert.render_config."""
    from arctic_tpu.core.config import RenderConfig as JRenderConfig
    from arctic_tpu_torch.utils import convert

    assert RenderConfig().tex_group_caps is None is JRenderConfig().tex_group_caps
    assert config_from_dict({"tex_group_caps": [64, 32, 96]}).tex_group_caps == (64, 32, 96)
    tc = convert.render_config(JRenderConfig(tex_group_caps=(64, 32, 96)))
    assert tc == dataclasses.replace(RenderConfig(), tex_group_caps=(64, 32, 96))


def test_config_tiles_and_unknown_fields():
    """The shadow tile defaults to the JAX default 64 x 64 and other tiles
    carry over; names neither package has raise."""
    assert config_from_dict(dict(shadow_tile=64, shadow_tile_h=None)) == RenderConfig()
    for tile in (dict(shadow_tile=32), dict(shadow_tile_h=32), dict(shadow_tile=64, shadow_tile_h=16)):
        assert config_from_dict(tile) == RenderConfig(**tile)
    assert (RenderConfig(shadow_tile=32).shadow_th, RenderConfig(shadow_tile_h=16).shadow_th) == (32, 16)
    with pytest.raises(RenderError, match="no field"):
        config_from_dict(dict(shadow_tiles=64))


def test_cli_cache_sun_orbit(tmp_path):
    """--cache-sun renders the shadow map once; the orbit's frames are the
    uncached frames."""
    argv = ["--procedural", "cornell", "--frames", "2", "--orbit"]
    _render(argv + ["--cache-sun"], tmp_path / "c.png")
    _render(argv, tmp_path / "u.png")
    for i in range(2):
        cached = images.load_ldr(str(tmp_path / f"c_{i:04d}.png"))
        uncached = images.load_ldr(str(tmp_path / f"u_{i:04d}.png"))
        assert cached.std() > 5
        np.testing.assert_array_equal(cached, uncached)


def test_cli_stats_excludes_png_encode(tmp_path, monkeypatch, capsys):
    """--stats times the render and the device sync only: a slow PNG
    encode does not move the measured frame times."""
    real_save, delay = images.save_png, 0.5

    def slow_save(path, img):
        time.sleep(delay)
        return real_save(path, img)

    monkeypatch.setattr(images, "save_png", slow_save)
    _render(["--procedural", "cornell", "--frames", "2", "--stats"], tmp_path / "f.png")
    summary = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.search(r"max=([0-9.]+)ms", summary)
    assert m and float(m.group(1)) < delay * 1e3, summary


def test_cli_load_state_restores_settings(tmp_path):
    """--save-state then --load-state round-trips the settings and the
    camera, and an explicit flag overrides the loaded value (as
    tests/test_app.py holds the JAX CLI)."""
    state, state2, state3 = (tmp_path / f"s{i}.json" for i in range(3))
    base = ["--procedural", "cornell"]
    _render(base + ["--tm", "aces", "--gamma", "1.8", "--exposure", "2.5",
                    "--save-state", str(state)], tmp_path / "a.png")

    def check_settings(d, tm, gamma, exposure):
        assert d["tm_method"] == tm
        assert d["gamma"] == pytest.approx(gamma, rel=1e-6)
        assert d["exposure"] == pytest.approx(exposure, rel=1e-6)

    check_settings(json.loads(state.read_text())["settings"], 2, 1.8, 2.5)
    assert main(["render", "--procedural", "cornell", "--width", str(W), "--height", str(H),
                 "--shadow-size", str(SHADOW), "--device", "cpu", "--out",
                 str(tmp_path / "b.png"), "--load-state", str(state),
                 "--save-state", str(state2)]) == 0
    saved2 = json.loads(state2.read_text())
    check_settings(saved2["settings"], 2, 1.8, 2.5)
    assert saved2["camera"]["eye"] == EYE and saved2["camera"]["rotation"] == ROT
    _render(base + ["--load-state", str(state), "--gamma", "2.4", "--save-state", str(state3)],
            tmp_path / "c.png")
    check_settings(json.loads(state3.read_text())["settings"], 2, 2.4, 2.5)


def _jax_params_equal(jp, js, tp, ts):
    for f in ("eye", "rotation", "aspect", "fov_y", "z_near", "z_far"):
        np.testing.assert_array_equal(np.asarray(getattr(jp.camera, f)),
                                      getattr(tp.camera, f).numpy(), err_msg=f)
    for f in ("position", "rotation", "color"):
        np.testing.assert_array_equal(np.asarray(getattr(jp.sun, f)),
                                      getattr(tp.sun, f).numpy(), err_msg=f)
    assert int(jp.point_lights.count) == tp.point_lights.count
    np.testing.assert_array_equal(np.asarray(jp.point_lights.position), tp.point_lights.position)
    np.testing.assert_array_equal(np.asarray(jp.point_lights.color), tp.point_lights.color)
    np.testing.assert_array_equal(np.asarray(jp.ambient), tp.ambient.numpy())
    assert int(js.tm_method) == ts.tm_method
    np.testing.assert_array_equal(np.asarray(js.gamma), ts.gamma.numpy())
    np.testing.assert_array_equal(np.asarray(js.exposure), ts.exposure.numpy())


def test_state_files_load_in_either_package(tmp_path):
    """A state saved by the port loads in the JAX package's load_state to
    equal params and settings, and the other way round; the JSON is the
    same."""
    from arctic_tpu_torch.core.scene import Settings

    params = default_scene_params(aspect=W / H)
    params.camera = make_camera([1.5, 2.25, -3.0], [-12.5, 33.3], W / H, fov_y=50.0)
    params.point_lights = PointLights.from_list([((0.0, 1.0, 0.0), (10.0, 0.0, 0.0)),
                                                 ((1.0, 2.0, 3.0), (0.1, 0.2, 0.3))])
    settings = Settings(tm_method=1, gamma=torch.tensor(1.9), exposure=torch.tensor(0.7))
    ours = tmp_path / "ours.json"
    serialize.save_state(str(ours), params, settings)
    jp, js = jserialize.load_state(str(ours))
    _jax_params_equal(jp, js, params, settings)
    theirs = tmp_path / "theirs.json"
    jserialize.save_state(str(theirs), jp, js)
    assert json.loads(theirs.read_text()) == json.loads(ours.read_text())
    tp, ts = serialize.load_state(str(theirs))
    _jax_params_equal(jp, js, tp, ts)


def test_fly_camera_equals_jax():
    jcam = j_default_params().camera
    cam = default_scene_params().camera
    jfc, fc = JFlyCamera(speed=7.5), FlyCamera(speed=7.5)
    for args in (dict(dt=1.0, forward_input=1.0), dict(dt=0.5, right_input=1.0),
                 dict(dt=0.25, forward_input=-1.0, right_input=0.5, up_input=1.0)):
        jcam, cam = jfc.move(jcam, **args), fc.move(cam, **args)
        jcam, cam = jfc.look(jcam, 10, -4), fc.look(cam, 10, -4)
        assert cam.eye.dtype == cam.rotation.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(jcam.eye), cam.eye.numpy())
        np.testing.assert_array_equal(np.asarray(jcam.rotation), cam.rotation.numpy())


def test_frame_stats_equals_jax():
    ours, theirs = profiling.FrameStats(capacity=4), JFrameStats(capacity=4)
    for dt in (0.02, 0.0, 0.015, 0.03, 0.011, 0.05):
        ours.add(dt)
        theirs.add(dt)
    assert list(ours.history) == list(theirs.history)
    assert ours.summary() == theirs.summary() and ours.fps == theirs.fps
    assert profiling.FrameStats().summary() == "no frames"
    ours.tick()
    assert ours.tick() >= 0.0


def test_render_guard_and_trace():
    with pytest.raises(RenderError, match=r"render failed \(scene x\): ValueError: boom"):
        with render_guard("scene x"):
            raise ValueError("boom")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.named_scope("pass_a"):
            torch.ones(4).sum()
    [scope] = [e for e in prof.events() if e.name == "pass_a"]
    assert "aten::sum" in {c.name for c in scope.cpu_children}


def test_named_scope_enters_no_range_with_the_profiler_off(monkeypatch):
    """Off, named_scope is one shared no-op context and enters no
    record_function (which costs host time even with no profiler on); under
    torch.profiler.profile the range is recorded."""
    entered = []
    record_function = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or record_function(name))
    with profiling.named_scope("off"):
        torch.ones(4).sum()
    assert entered == [] and profiling.named_scope("a") is profiling.named_scope("b")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.named_scope("on"):
            torch.ones(4).sum()
    assert entered == ["on"] and "on" in {e.name for e in prof.events()}
