"""K6's and K8's plain versions on utils/synthetic.py's inputs — every quad
width, quad and special bf16 pattern of K6; K8's pitch = s + 4 map, last
column and row, every x0 % 4, repeated rows, rows_used at 0, below and at
the list's length, and lists of several grid passes (``k8_strided`` at a
small stand-in stride) — against independent numpy loops: per channel for K6,
per tap for K8 (its window read by index and its rows and columns picked
by index, not by selects). No JAX: the plain versions are held to JAX by
test_torch_shading.py and test_torch_shadow_quant.py. Exact: numpy's f32
operations round like torch's, one operation at a time; NaN positions must
agree.
"""

import numpy as np
import torch

from arctic_tpu_torch.ops import sampling, shadow
from arctic_tpu_torch.utils import synthetic

F32 = np.float32


def _k6_numpy(table, idx, tq, eq, tfx, tfy, efx, efy, c4):
    bits = table.view(torch.int16).numpy().view(np.uint16)[idx.numpy()]
    row = (bits.astype(np.uint32) << 16).view(F32)  # (n, 128) widened lanes
    n = row.shape[0]
    out = np.zeros((16, n), F32)
    pix = np.arange(n)

    def lerp(base, k, i, fx, fy):
        c00, c10, c01, c11 = (row[pix, base + q * k + i] for q in range(4))
        top = c00 + (c10 - c00) * fx
        bot = c01 + (c11 - c01) * fx
        return top + (bot - top) * fy

    c = c4 // 4
    with np.errstate(invalid="ignore", over="ignore"):  # the planted NaN / Inf lanes
        for i in range(c):
            out[i] = lerp(c4 * tq.numpy(), c, i, tfx.numpy(), tfy.numpy())
        for i in range(4):
            out[c + i] = lerp(16 * eq.numpy(), 4, i, efx.numpy(), efy.numpy())
    return out


def _k8_numpy(lut, order, rows_used, start_y, start_x, z, lx, ly, offsets):
    table = lut.view(torch.int16).numpy().view(np.uint16)
    rows = order.numpy().astype(np.int64)
    y0, x0, zz, lxx, lyy = (a.numpy()[rows].reshape(-1) for a in (start_y, start_x, z, lx, ly))
    win = np.stack([table[y0 + r, x0 + c] for r in range(4) for c in range(4)], 1)
    win = win.astype(F32) * F32(shadow.DQ)  # (pixels, 16): texel (r, c) at 4r + c
    pix = np.arange(win.shape[0])
    count = np.zeros(win.shape[0], F32)
    for oy in offsets:
        sy = lyy + F32(oy)
        iy = np.floor(sy).astype(np.int32)
        fy = sy - iy.astype(F32)
        r0 = np.where((iy == 0) | (iy == 1), iy, 2)  # the select's third branch
        for ox in offsets:
            sx = lxx + F32(ox)
            ix = np.floor(sx).astype(np.int32)
            fx = sx - ix.astype(F32)
            c0 = np.where((ix == 0) | (ix == 1), ix, 2)
            c00, c10 = win[pix, 4 * r0 + c0], win[pix, 4 * r0 + c0 + 1]
            c01, c11 = win[pix, 4 * r0 + 4 + c0], win[pix, 4 * r0 + 4 + c0 + 1]
            top = c00 + (c10 - c00) * fx
            bot = c01 + (c11 - c01) * fx
            closest = top + (bot - top) * fy
            count = count + (zz > closest).astype(F32)
    count = count.reshape(len(rows), shadow.ROW)
    count[int(rows_used[0]):] = 0.0
    return count


def test_k6_k8_plain_match_numpy_on_synthetic_inputs():
    # K6: every width the wrapper takes, every quad, every planted pattern.
    assert all(synthetic.K6_PIXELS % b for b in (32, 64, 128, 256, 512, 1024))
    for c4 in synthetic.K6_WIDTHS:
        args, kw = synthetic.k6_inputs("cpu", c4)
        table, idx, tq, eq = args[:4]
        assert set(tq.tolist()) == set(range(128 // c4)) and set(eq.tolist()) == set(range(8))
        bits = set(table.view(torch.int16)[idx.long()].numpy().view(np.uint16).ravel().tolist())
        assert set(synthetic.K6_SPECIALS) <= bits
        got = sampling.tap_resolve(*args, **kw).numpy()
        want = _k6_numpy(*args, **kw)
        assert got.shape == (16, synthetic.K6_PIXELS)
        assert np.isnan(got).any() and np.isinf(got).any()
        np.testing.assert_array_equal(got, want)  # NaN positions must match too
    # K8: the cases utils/synthetic.py lists.
    s = synthetic.K8_SIDE
    assert shadow.lut_pitch(s) == s + 4
    used_cases = set()
    stride = 6  # a small stand-in for the card's grid stride
    calls = [synthetic.k8_inputs("cpu", u) for u in synthetic.K8_ROWS_USED]
    calls += [synthetic.k8_strided("cpu", stride, case) for case in synthetic.K8_STRIDED]
    strided = [int(args[2][0]) for args, _ in calls[len(synthetic.K8_ROWS_USED):]]
    assert strided == [3 * stride - 1, 6 * stride + 1, synthetic.K8_PASSES * stride + 5]
    for args, kw in calls:
        rows_used = int(args[2][0])
        lut, order, used, start_y, start_x = args[:5]
        n = order.shape[0]
        assert lut.shape == (s + 4, s + 4) and n % 2 and len(set(order.tolist())) < n
        assert not bool((order[1:] >= order[:-1]).all())
        live = order[:rows_used].long()
        x0, y0 = start_x[live], start_y[live]
        if rows_used:
            assert set((x0 % 4).unique().tolist()) == {0, 1, 2, 3}
            assert bool((x0 == s).any()) and bool((y0 == s).any())
            offsets = torch.tensor(args[-1])
            for plane in args[6:8]:  # lx, ly: every 3-way select branch is taken
                taps = set(torch.floor(plane[live].reshape(-1, 1) + offsets).unique().tolist())
                assert {0.0, 1.0, 2.0} < taps and (min(taps) < 0 or max(taps) > 2)
        used_cases.add("zero" if rows_used == 0 else "all" if rows_used == n else "some")
        got = shadow.pcf_eval(*args, **kw).numpy()
        want = _k8_numpy(*args)
        assert got.shape == (n, shadow.ROW)
        np.testing.assert_array_equal(got, want)
        if rows_used:
            assert 0 < got[:rows_used].mean() < 25 and len(np.unique(got[:rows_used])) > 10
    assert used_cases == {"zero", "some", "all"}
