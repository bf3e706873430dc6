"""The port's browser viewer (arctic_tpu_torch/app/viewer.py): the JAX
package's six tests/test_viewer.py tests on the port (64x48, a 64^2 shadow
map; brute force where JAX's are, the fused frame for the sun cache),
with every PNG decoded by io/images (no Pillow) and held to the port's
in-process frame of the viewer's state, bit for bit; and with_object_trs
against the JAX package's on the same Cornell geometry.
"""

import http.client
import json
import threading
from http.server import ThreadingHTTPServer
from urllib.parse import quote

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arctic_tpu.app.viewer import _object_edit_matrix as j_object_edit_matrix
from arctic_tpu.core.scene import with_object_trs as j_with_object_trs
from arctic_tpu.io import build as jbuild
from arctic_tpu.io import procedural as jproc
from arctic_tpu_torch.app import viewer
from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.core.scene import default_scene_params, default_settings, with_object_trs
from arctic_tpu_torch.io import build, images
from arctic_tpu_torch.io.procedural import cornell_like_scene
from arctic_tpu_torch.models import pipeline

W, H = 64, 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The suite runs test files in several processes at once; an
    oversubscribed torch thread pool slows these small CPU frames by orders
    of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(bruteforce=True):
    config = RenderConfig(width=W, height=H, shadow_size=64, force_bruteforce=bruteforce)
    meshes, objects, materials, env = cornell_like_scene()
    buffers = build.build_buffers(meshes, objects, materials, env, tri_bucket=256, device="cpu")
    return viewer.ViewerState(
        buffers, default_scene_params(aspect=W / H), default_settings(), config,
        pipeline.make_renderer_stats(config, "cpu"), "cpu",
    )


def _decode(png):
    assert png[:4] == b"\x89PNG"
    return images.decode_png(png)[..., :3]


def _in_process(state):
    """The port's frame of the viewer's current scene, params and settings."""
    img, _ = pipeline.render_frame_stats(state.buffers, state.params, state.settings, state.config)
    return img.numpy()


def _serve(state):
    server = ThreadingHTTPServer(("127.0.0.1", 0), viewer.make_handler(state))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)


def test_viewer_serves_frames_and_moves_camera():
    state = _state()
    server, conn = _serve(state)
    try:
        conn.request("GET", "/")
        page = conn.getresponse()
        assert page.status == 200 and b"arctic_tpu viewer" in page.read()

        eye0 = state.params.camera.eye.clone()
        conn.request("GET", "/frame?f=1&dx=20&dy=0&ambient=0.2&gamma=2.2&exposure=1&tm=2")
        frame = conn.getresponse()
        assert frame.status == 200
        img = _decode(frame.read())
        # Camera moved forward and yawed; settings applied.
        assert not torch.allclose(state.params.camera.eye, eye0)
        assert float(state.params.camera.rotation[1]) != 0.0
        assert state.settings.tm_method == 2
        np.testing.assert_array_equal(img, _in_process(state))

        conn.request("GET", "/state")
        st = conn.getresponse()
        assert st.status == 200 and b"camera" in st.read()
    finally:
        server.shutdown()
        server.server_close()


def test_viewer_lights_sun_and_stats():
    """Lights window parity: add/edit point lights + sun + camera speed via
    query params (app.cpp:454-523); X-Stats carries frame time + camera."""
    state = _state()
    server, conn = _serve(state)
    try:
        lights = [{"pos": [0, 1, 0], "color": [10, 0, 0]},
                  {"pos": [2, 3, -1], "color": [0, 5, 20]}]
        q = ("lights=" + quote(json.dumps(lights))
             + "&sun_pos=1,20,3&sun_rot=-50,30&sun_color=4,5,6"
             + "&cam_pos=0,4,3&cam_rot=-25,-90&speed=2.5&sens=0.25&znear=0.2&zfar=500")
        conn.request("GET", "/frame?" + q)
        r = conn.getresponse()
        assert r.status == 200
        stats = json.loads(r.getheader("X-Stats"))
        img = _decode(r.read())
        assert stats["ms"] > 0 and len(stats["cam"]["pos"]) == 3

        assert state.params.point_lights.count == 2
        np.testing.assert_allclose(state.params.point_lights.position[1].numpy(), [2, 3, -1])
        np.testing.assert_allclose(state.params.point_lights.color[1].numpy(), [0, 5, 20])
        np.testing.assert_allclose(state.params.sun.position.numpy(), [1, 20, 3])
        np.testing.assert_allclose(state.params.sun.rotation.numpy(), [-50, 30])
        np.testing.assert_allclose(state.params.sun.color.numpy(), [4, 5, 6])
        assert state.fly.speed == 2.5 and state.fly.sensitivity == 0.25
        assert float(state.params.camera.z_near) == np.float32(0.2)
        assert float(state.params.camera.z_far) == 500.0
        np.testing.assert_array_equal(img, _in_process(state))

        conn.request("GET", "/stats")
        s = conn.getresponse()
        assert s.status == 200 and b"fps" in s.read()

        conn.request("GET", "/")
        page = conn.getresponse().read()
        for needle in (b"addlight", b"sun pos", b"cam speed", b"plot"):
            assert needle in page, needle
        conn.request("GET", "/nowhere")
        missing = conn.getresponse()
        missing.read()
        assert missing.status == 404
    finally:
        server.shutdown()
        server.server_close()


def test_viewer_resolution_change():
    """res=WxH rebuilds the renderer (the PSO-rebuild analogue); later
    frames come at the new size with the aspect updated; bad input is
    ignored."""
    state = _state()
    png, _ = state.step({})
    assert _decode(png).shape == (48, 64, 3)
    png, _ = state.step({"res": ["96x64"]})
    img = _decode(png)
    assert img.shape == (64, 96, 3)
    assert state.config.width == 96 and state.config.height == 64
    assert abs(float(state.params.camera.aspect) - 96 / 64) < 1e-6
    np.testing.assert_array_equal(img, _in_process(state))
    png, _ = state.step({"res": ["0x0"]})
    assert _decode(png).shape == (64, 96, 3)


def test_viewer_sun_cache_reuse_and_invalidation():
    """The fused viewer renders through the sun cache: camera-only frames
    reuse it, a sun edit rebuilds it; every frame equals the uncached
    in-process frame."""
    state = _state(bruteforce=False)
    png, _ = state.step({})
    assert state.sun_cache is not None
    cache0 = state.sun_cache
    np.testing.assert_array_equal(_decode(png), _in_process(state))

    png, _ = state.step({"f": ["1"]})  # camera-only: cache object reused
    assert state.sun_cache is cache0
    np.testing.assert_array_equal(_decode(png), _in_process(state))

    png, _ = state.step({"sun_rot": ["-35,80"]})  # sun edit: rebuilt
    assert state.sun_cache is not cache0
    np.testing.assert_array_equal(_decode(png), _in_process(state))


def test_viewer_object_editor_exact():
    """Objects window: an object-TRS edit changes the frame and equals the
    frame of buffers built with the JAX viewer's composed matrix, bit for
    bit; an identity edit restores the original frame; malformed edits are
    ignored."""
    meshes, objects, materials, env = cornell_like_scene()
    state = _state()
    cam = {"cam_pos": ["0,4,3"], "cam_rot": ["-25,-90"]}
    png0, _ = state.step(cam)
    edit = {"id": 1, "dt": [0.4, 0.0, -0.2], "rot": [25.0, -10.0], "scale": 1.2}
    png1, _ = state.step({"obj_edit": [json.dumps(edit)]})
    assert png1 != png0  # the box moved
    img1 = _decode(png1)

    trs1 = j_object_edit_matrix(np.asarray(objects[1][0], np.float32), edit["dt"],
                                edit["rot"], edit["scale"])
    objects2 = list(objects)
    objects2[1] = (trs1, objects[1][1])
    bufs2 = build.build_buffers(meshes, objects2, materials, env, tri_bucket=256, device="cpu")
    img2, _ = state.render(bufs2, state.params, state.settings)
    np.testing.assert_array_equal(img1, img2.numpy())
    np.testing.assert_array_equal(state.buffers.geometry.tri_trs, bufs2.geometry.tri_trs)

    ident = {"id": 1, "dt": [0, 0, 0], "rot": [0, 0], "scale": 1.0}
    png3, _ = state.step({"obj_edit": [json.dumps(ident)]})
    assert png3 == png0
    png4, _ = state.step({"obj_edit": ["{bad json"]})
    assert png4 == png0
    png5, _ = state.step({"obj_edit": [json.dumps({"id": 99, "dt": [1, 0, 0]})]})
    assert png5 == png0


def test_viewer_object_edit_invalidates_sun_cache():
    """A geometry edit rebuilds the sun cache (moved geometry casts another
    shadow), as a sun edit does; the edited frame equals the uncached one."""
    state = _state(bruteforce=False)
    state.step({"cam_pos": ["0,4,3"], "cam_rot": ["-25,-90"]})
    cache0 = state.sun_cache
    assert cache0 is not None

    edit = {"id": 1, "dt": [0.0, 0.6, 0.0], "rot": [0, 0], "scale": 1.0}
    png, _ = state.step({"obj_edit": [json.dumps(edit)]})
    assert state.sun_cache is not cache0
    np.testing.assert_array_equal(_decode(png), _in_process(state))

    cache1 = state.sun_cache
    state.step({"f": ["1"]})  # camera-only: reused again
    assert state.sun_cache is cache1


def test_with_object_trs_equals_jax():
    """Build-time object_trs / tri_obj, each Objects-window edit's matrix
    (identity and non-unit scales included) and the edited object_trs and
    tri_trs equal the JAX package's on the same Cornell geometry, bit for
    bit; the corner positions and the static attribute rows are untouched."""
    scene = jproc.cornell_like_scene()
    jg = jbuild.build_buffers(*scene, tri_bucket=256).geometry
    g0 = build.build_buffers(*cornell_like_scene(), tri_bucket=256, device="cpu").geometry
    np.testing.assert_array_equal(g0.object_trs.numpy(), np.asarray(jg.object_trs))
    np.testing.assert_array_equal(g0.tri_obj.numpy(), np.asarray(jg.tri_obj))
    g = g0
    for obj, edit in ((2, ((0.5, -0.25, 1.0), (30.0, 12.5), 0.8)), (0, ((0, 0, 0), (0, 0), 1.0)),
                      (1, ((-1.0, 0.0, 0.0), (-90.0, 0.0), 2.0))):
        orig = np.asarray(scene[1][obj][0], np.float32)
        trs = viewer._object_edit_matrix(orig, *edit)
        jtrs = j_object_edit_matrix(orig, *edit)
        assert trs.dtype == jtrs.dtype == np.float32
        np.testing.assert_array_equal(trs, jtrs)
        if edit == ((0, 0, 0), (0, 0), 1.0):
            np.testing.assert_array_equal(trs, orig)
        jg = j_with_object_trs(jg, obj, jnp.asarray(jtrs))
        g = with_object_trs(g, obj, trs)
        np.testing.assert_array_equal(g.object_trs.numpy(), np.asarray(jg.object_trs))
        np.testing.assert_array_equal(g.tri_trs.numpy(), np.asarray(jg.tri_trs))
    assert not torch.equal(g.tri_trs, g0.tri_trs)
    for name in ("tri_corner_pos", "tri_static_attrs", "tri_matrow", "slot_static_rows"):
        assert getattr(g, name) is getattr(g0, name), name
