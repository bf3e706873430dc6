"""The f32 window-table PCF route and the window resolve of arctic_tpu_torch
(ops/shadow.py: K12 window_lut, K13 pcf_resolve) held against the JAX
package's, on the same seeded numpy inputs. JAX's Pallas kernels run in
interpret mode, as its own tests run them (tests/test_window_lut.py); the
port runs its kernels' plain versions. Each JAX table is built once per
module (seconds each in interpret mode).

Tolerances: all exact. The f32 table holds copies of map texels, so every
window equals JAX's and every route that reads it equals the runs path bit
for bit. The u16 table: the JAX package's own test allows one quantum,
since its kernel may contract the quantiser's multiply-add into an FMA;
measured on this map (as in test_torch_shadow_quant): 0 texels off, so
K13's planes are held bit-equal too (K13's dequantise is one rounded
multiply on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arctic_tpu.ops import shadow as jshadow
from arctic_tpu_torch.ops import shadow

S = 64
# Window origins of test_window_lut.py:28-29 (borders and odd phases), with
# the u16 table's y-stride phases 11, 12 and 23 of :50.
ORIGINS_Y = [0, 1, 2, 3, 5, 11, 12, 17, 23, S - 1, S]
ORIGINS_X = [0, 1, 2, 3, 8, 33, S - 1, S]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module (the suite runs several test
    processes at once; an oversubscribed pool slows small CPU ops badly)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    """A 64^2 map and 2,048 light-space points: inside the frustum, outside
    it (|x|, |y| > 1) and beyond the far plane (z > 1)."""
    rng = np.random.default_rng(7)
    smap = rng.uniform(0.1, 0.9, (S, S)).astype(np.float32)
    x, y = (rng.uniform(-1.1, 1.1, (16, 128)).astype(np.float32) for _ in range(2))
    z = rng.uniform(-0.05, 1.05, (16, 128)).astype(np.float32)
    return smap, x, y, z


@pytest.fixture(scope="module")
def jax_table(inputs):
    """JAX's blocked f32 window table of the map and its x-block count."""
    return jshadow.build_window_lut(jnp.asarray(inputs[0]))


@pytest.fixture(scope="module")
def jax_table_q(inputs):
    """JAX's blocked u16 window table of the map (built once: its kernel
    takes seconds in interpret mode) and its x-block count."""
    return jshadow.build_window_lut_q(jnp.asarray(inputs[0]))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_k12_plain_matches_jax_windows(inputs, jax_table):
    smap = inputs[0]
    jlut, xb = np.asarray(jax_table[0]), jax_table[1]
    table = shadow.window_lut(torch.from_numpy(smap), S)
    assert table.dtype == torch.float32 and table.shape == (S + 4, shadow.window_pitch(S))
    got = table.numpy()
    np.testing.assert_array_equal(got[:, : S + 4], np.pad(smap, 2, mode="wrap"))
    assert (got[:, S + 4 :] == 0).all()
    for y in ORIGINS_Y:
        for x in ORIGINS_X:
            row, k2, yoff, xoff = jshadow.window_row_index(y, x, xb)
            block = jlut[row, 64 * k2 : 64 * k2 + 64].reshape(8, 8)
            np.testing.assert_array_equal(
                got[y : y + 4, x : x + 4], block[yoff : yoff + 4, xoff : xoff + 4],
                err_msg=f"window ({y},{x})",
            )
    # A strided source (K1's padded depth buffer) is read in place.
    padded = torch.zeros((S + 32, S + 64))
    padded[:S, :S] = torch.from_numpy(smap)
    assert torch.equal(shadow.window_lut(padded[:S, :S], S), table)


def test_pcf_f32_table_matches_jax_and_runs_path(inputs, jax_table, monkeypatch):
    """Eager, as JAX's own test runs it: jitted, XLA turns the /25 into a
    reciprocal multiply and moves 6 of these 2,048 values by 1 ulp. JAX's
    route builds its table of this map inside; it gets the module's."""
    smap, x, y, z = inputs
    monkeypatch.setattr(jshadow, "build_window_lut", lambda m: jax_table)
    want = np.asarray(jshadow.pcf_shadow_proj(jnp.asarray(smap), x, y, z, use_lut=True, quant=False))
    tmap, tx, ty, tz = _t(smap, x, y, z)
    got, rows = shadow.pcf_shadow_proj(tmap, tx, ty, tz, use_lut=True, quant=False, with_rows=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), shadow.pcf_shadow_proj(tmap, tx, ty, tz).numpy())
    assert int(rows) == 0
    assert 0.0 < float(got.mean()) < 1.0 and bool((got == 0).any())


def test_k13_plain_matches_jax_pcf_resolve(inputs, jax_table_q):
    """K13 against JAX's _pcf_resolve fed the rows of its blocked table that
    the windows sit in (candidate k2 * 12 + yoff, x offset xoff)."""
    smap = inputs[0]
    rng = np.random.default_rng(8)
    n = 4096
    sy = rng.integers(0, S + 1, n).astype(np.int32)
    sx = rng.integers(0, S + 1, n).astype(np.int32)
    sy[: len(ORIGINS_Y)] = ORIGINS_Y
    sx[: len(ORIGINS_X)] = ORIGINS_X
    jlut, xb = jax_table_q
    jrow, k2, yoff, xoff = jshadow.window_row_index_q(jnp.asarray(sy), jnp.asarray(sx), xb)
    want = np.asarray(jshadow._pcf_resolve(jlut[jrow], k2 * 12 + yoff, xoff))
    lut = shadow.build_window_lut_q(torch.from_numpy(smap))
    got = shadow.pcf_resolve(lut, *_t(sy, sx))
    assert got.shape == (16, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # Plane 4r + c is window texel (r, c) of the dequantised padded map.
    deq = lut.to(torch.int32).numpy().astype(np.float32) * np.float32(shadow.DQ)
    for r, c in ((0, 0), (1, 3), (3, 2)):
        np.testing.assert_array_equal(got[4 * r + c].numpy(), deq[sy + r, sx + c])


@pytest.mark.parametrize(
    "route", [dict(row_cap=64, quant=False), dict(row_cap=64, use_lut=False), dict(use_lut=True)]
)
def test_row_cap_needs_the_quantised_table(inputs, route):
    """Classification lives on the u16 table, and the table runs only
    classified. JAX ignores row_cap on the other routes, the port refuses
    it; JAX's uncompacted u16 route equals the classified one with every
    row in its cap (test_torch_shadow_quant holds the two equal), so the
    port has only the classified one."""
    tmap, tx, ty, tz = _t(*inputs)
    with pytest.raises(ValueError, match="runs exactly when row_cap is set"):
        shadow.pcf_shadow_proj(tmap, tx, ty, tz, **route)
