"""The quantised PCF path of arctic_tpu_torch (ops/shadow.py: the window
table of K7, the min/max pyramid, the row classification and K8 through
pcf_shadow_proj) held against the JAX package's, on the same seeded
inputs. JAX's Pallas kernels run in interpret mode, as its own tests run
them (tests/test_window_lut.py); the port runs its kernels' plain versions.

Tolerances:
- window table: the JAX package's own test allows one quantum (its kernel
  may contract the quantiser's multiply-add into an FMA); measured on these
  maps: 0 texels off by one, so the tables are held equal (every window at
  every origin, through convert.window_table_q, which is stricter than the
  spread of origins of test_window_lut.py:50-51), and the port's table
  equals numpy's quantiser exactly;
- pyramid: the same one-quantum caveat; measured 0 entries off, held equal;
- classification and the PCF values: exact (bit-equal) on maps of exact
  u16 multiples, where quantisation is the identity; penumbra row counts
  equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arctic_tpu.ops import shadow as jshadow
from arctic_tpu_torch.ops import shadow
from arctic_tpu_torch.utils import convert


def _quantize(m):
    return np.floor(np.clip(m.astype(np.float32) * 65535.0 + 0.5, 0, 65535)).astype(np.int32)


# _step_map and _cluster_lsp are copies of tests/test_window_lut.py's
# generators (flat lit / shadowed regions with a noisy band, and 128-point
# light-space clusters that are lit, shadowed, penumbra or out of frustum).
def _step_map(rng, s=96):
    m = np.full((s, s), 0.9, np.float32)
    m[:, : s // 3] = 0.1
    band = slice(s // 3, 2 * s // 3)
    m[:, band] = rng.uniform(0.1, 0.9, (s, s // 3)).astype(np.float32)
    return m


def _cluster_lsp(rng, s, k=64):
    uc = rng.uniform(0.08, 0.92, k).astype(np.float32)
    vc = rng.uniform(0.08, 0.92, k).astype(np.float32)
    kind = np.arange(k) % 3  # 0 lit, 1 shadowed, 2 penumbra
    uc[kind == 0] = rng.uniform(0.05, 0.25, (kind == 0).sum())
    uc[kind == 1] = rng.uniform(0.75, 0.95, (kind == 1).sum())
    uc[kind == 2] = rng.uniform(0.40, 0.60, (kind == 2).sum())
    u = np.clip(uc[:, None] + rng.uniform(-0.02, 0.02, (k, 128)), 0.001, 0.999)
    v = np.clip(vc[:, None] + rng.uniform(-0.02, 0.02, (k, 128)), 0.001, 0.999)
    zc = np.where(kind == 0, 0.05, np.where(kind == 1, 0.95, 0.5))
    x = (u * 2.0 - 1.0).astype(np.float32)
    y = ((1.0 - v) * 2.0 - 1.0).astype(np.float32)
    z = np.broadcast_to(zc[:, None], (k, 128)).astype(np.float32).copy()
    x[0, :8] = 3.0  # out of frustum
    z[1, :8] = 1.5  # z > 1
    return x, y, z


def _u16_exact(m):
    """The map rounded to exact multiples of 1/65535 (quantisation is then
    the identity, so the quantised and the f32 paths agree bit for bit)."""
    return (np.round(m * 65535.0) / 65535.0).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("s", [64, 96])
def test_window_table_matches_jax(s):
    rng = np.random.default_rng(s)
    smap = rng.uniform(0.1, 0.9, (s, s)).astype(np.float32)
    jlut, _ = jshadow.build_window_lut_q(jnp.asarray(smap))
    port = shadow.build_window_lut_q(torch.from_numpy(smap))
    assert port.dtype == torch.uint16 and port.shape == (s + 4, shadow.lut_pitch(s))
    got = port.to(torch.int32).numpy()
    np.testing.assert_array_equal(got[:, : s + 4], _quantize(np.pad(smap, 2, mode="wrap")))
    assert (got[:, s + 4 :] == 0).all()
    # Every window of JAX's blocked table, decoded, equals the port's.
    want = convert.window_table_q(jlut, s).astype(np.int32)
    np.testing.assert_array_equal(got, want)
    for y in [0, 1, 2, 3, 5, 11, 12, 17, 23, s - 1, s]:
        for x in [0, 1, 2, 3, 8, 33, s - 1, s]:
            np.testing.assert_array_equal(got[y : y + 4, x : x + 4], want[y : y + 4, x : x + 4])


def test_window_table_y_range():
    """A banded build writes the rows that windows starting in the band
    read, equal to the full build's, and 0 elsewhere (both versions)."""
    s, lo, hi = 96, 30, 70
    rng = np.random.default_rng(1)
    smap = torch.from_numpy(rng.uniform(0.1, 0.9, (s, s)).astype(np.float32))
    full = shadow.build_window_lut_q(smap).to(torch.int32)
    part = shadow.build_window_lut_q(smap, torch.tensor([lo, hi], dtype=torch.int32)).to(torch.int32)
    assert torch.equal(part[lo : hi + 4], full[lo : hi + 4])
    assert (part[:lo] == 0).all() and (part[hi + 4 :] == 0).all()
    # The map may be a strided view (K1's padded depth buffer): read in place.
    padded = torch.zeros((s + 32, s + 32))
    padded[:s, :s] = smap
    view = padded[:s, :s]
    assert not view.is_contiguous()
    assert torch.equal(shadow.build_window_lut_q(view).to(torch.int32), full)


@pytest.mark.parametrize("s", [96, 192])
def test_pyramid_matches_jax(s):
    rng = np.random.default_rng(s)
    smap = _step_map(rng, s)
    jtable, jmeta = jshadow.build_shadow_pyramid(jnp.asarray(smap))
    table, meta = shadow.build_shadow_pyramid(torch.from_numpy(smap))
    assert meta == jmeta == shadow.pyramid_meta(s)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    # A max >= 32768 packs into a negative i32: decoded with the mask.
    mx = (table >> 16) & 0xFFFF
    assert (table < 0).any() and int(mx.max()) >= 32768


def _window_planes(s, x, y, z):
    """start_y, start_x, z as (R, 128) rows, as pcf_shadow_proj makes them."""
    u = x * 0.5 + 0.5
    v = 1.0 - (y * 0.5 + 0.5)
    wx = np.floor(u * s - 0.5).astype(np.int32) - 1
    wy = np.floor(v * s - 0.5).astype(np.int32) - 1
    outside = (z > 1.0) | (u < 0.0) | (v < 0.0) | (u > 1.0) | (v > 1.0)
    return np.clip(wy + 2, 0, s), np.clip(wx + 2, 0, s), z, ~outside


def test_classify_matches_jax():
    s = 96
    rng = np.random.default_rng(2)
    smap = _step_map(rng, s)
    x, y, z = _cluster_lsp(rng, s)
    sy, sx, zz, care = _window_planes(s, x, y, z)
    care &= rng.uniform(size=care.shape) < 0.8
    jtable, meta = jshadow.build_shadow_pyramid(jnp.asarray(smap))
    jlit, jshd = jshadow.classify_pcf_rows(jtable, meta, *(jnp.asarray(a) for a in (sy, sx, zz, care)))
    table, _ = shadow.build_shadow_pyramid(torch.from_numpy(smap))
    lit, shd = shadow.classify_pcf_rows(table, meta, *_t(sy, sx, zz, care))
    np.testing.assert_array_equal(lit.numpy(), np.asarray(jlit))
    np.testing.assert_array_equal(shd.numpy(), np.asarray(jshd))
    assert lit.any() and shd.any() and not (lit | shd).all()


@pytest.fixture(scope="module")
def clusters():
    rng = np.random.default_rng(0)
    s = 96
    return s, _u16_exact(_step_map(rng, s)), _cluster_lsp(rng, s)


@pytest.mark.parametrize("jax_row_cap", [4096, None])
def test_pcf_quant_matches_jax(clusters, jax_row_cap):
    """Bit-equal to JAX's quantised path, classified (row_cap=4096) or
    evaluating every row (row_cap=None, an uncompacted path the port does
    not have: the port classifies with every row in its cap, which the
    JAX package documents as bit-identical), with equal penumbra row
    counts where JAX classifies."""
    s, smap, (x, y, z) = clusters
    tmap, tx, ty, tz = _t(smap, x, y, z)
    want, want_rows = jshadow.pcf_shadow_proj(
        jnp.asarray(smap), x, y, z, use_lut=True, quant=True, row_cap=jax_row_cap, with_rows=True
    )
    got, rows = shadow.pcf_shadow_proj(tmap, tx, ty, tz, row_cap=x.size // 128, with_rows=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(rows) <= x.size // 128 // 2  # classification fired
    if jax_row_cap is not None:
        assert int(rows) == int(want_rows)
    # On exact u16 multiples the quantised path is the f32 runs path.
    np.testing.assert_array_equal(got.numpy(), shadow.pcf_shadow_proj(tmap, tx, ty, tz).numpy())


def test_injected_table_needs_row_cap(clusters):
    """A SunCache's table or pyramid is read only on the classified path."""
    s, smap, (x, y, z) = clusters
    tmap, tx, ty, tz = _t(smap, x, y, z)
    lut = shadow.build_window_lut_q(tmap)
    pyr, _ = shadow.build_shadow_pyramid(tmap)
    with pytest.raises(ValueError, match="needs row_cap"):
        shadow.pcf_shadow_proj(tmap, tx, ty, tz, lut=lut)
    with pytest.raises(ValueError, match="needs row_cap"):
        shadow.pcf_shadow_proj(tmap, tx, ty, tz, pyramid=pyr)
    got = shadow.pcf_shadow_proj(tmap, tx, ty, tz, row_cap=4096, lut=lut, pyramid=pyr)
    np.testing.assert_array_equal(got.numpy(), shadow.pcf_shadow_proj(tmap, tx, ty, tz).numpy())


def test_pcf_quant_care_mask(clusters):
    """care=False pixels may get any value; care=True pixels stay exact."""
    s, smap, (x, y, z) = clusters
    care = np.random.default_rng(3).uniform(size=x.shape) < 0.7
    tmap, tx, ty, tz, tc = _t(smap, x, y, z, care)
    full = shadow.pcf_shadow_proj(tmap, tx, ty, tz).numpy()
    got = shadow.pcf_shadow_proj(tmap, tx, ty, tz, care=tc, row_cap=4096).numpy()
    np.testing.assert_array_equal(got[care], full[care])


def test_pcf_quant_overflow_is_counted():
    """A too-small row_cap reports the penumbra row count, more than the
    cap: the count does not depend on the cap (the count itself is held to
    JAX's in test_pcf_quant_matches_jax)."""
    s = 96
    rng = np.random.default_rng(0)
    smap = _step_map(rng, s)
    args = _t(smap, *_cluster_lsp(rng, s, k=128))
    _, rows = shadow.pcf_shadow_proj(*args, row_cap=1, with_rows=True)
    _, full = shadow.pcf_shadow_proj(*args, row_cap=4096, with_rows=True)
    assert int(rows) == int(full) > shadow.effective_row_cap(128 * 128, 1)


def test_k8_plain_writes_zero_past_rows_used():
    """K8's rows past rows_used are 0 (whole-tensor kernel checks), and a
    listed row's counts do not depend on its place in the list."""
    s = 64
    rng = np.random.default_rng(4)
    smap = torch.from_numpy(rng.uniform(0.2, 0.8, (s, s)).astype(np.float32))
    lut = shadow.build_window_lut_q(smap)
    r = 6
    sy = torch.from_numpy(rng.integers(0, s + 1, (r, 128)).astype(np.int32))
    sx = torch.from_numpy(rng.integers(0, s + 1, (r, 128)).astype(np.int32))
    z, lx, ly = (torch.from_numpy(rng.uniform(a, b, (r, 128)).astype(np.float32))
                 for a, b in ((0.1, 0.9), (1.0, 2.0), (1.0, 2.0)))
    order = torch.tensor([4, 1, 0, 2], dtype=torch.int32)
    offs = shadow.tap_offsets(s)
    out = shadow.pcf_eval(lut, order, torch.tensor([2], dtype=torch.int32), sy, sx, z, lx, ly, offs)
    assert out.shape == (4, 128) and (out[2:] == 0).all()
    every = shadow.pcf_eval(lut, torch.arange(r, dtype=torch.int32), torch.tensor([r], dtype=torch.int32),
                            sy, sx, z, lx, ly, offs)
    assert torch.equal(out[:2], every[[4, 1]])
    assert 0 < float(every.mean()) < 25
