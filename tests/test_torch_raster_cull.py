"""K1's per-block pair cull: ops/raster_tiles.block_rejects, the torch
statement of the test in csrc/raster_tiles.cu (same f32 operations in the
same order), against brute force over the rectangle's pixels; and "cull,
then plain" against K1's plain version on a synthetic dense tile.

The rule is the port's own, so no JAX frame takes part: K1's plain version
is held to JAX by test_torch_raster.py::test_k1_plain_*. Nothing here has a
tolerance: the rule must never reject a rectangle in which any pixel
accepts the pair, and culling each sub-tile's list before the plain raster
must give the plain raster's zbuf and ibuf exactly.
"""

import math

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, seed, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from arctic_tpu_torch.ops import raster_tiles  # noqa: E402
from arctic_tpu_torch.utils import synthetic

F32 = np.float32
SPECIALS = (0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module (the suite runs several test
    processes at once; an oversubscribed pool slows small CPU ops badly)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _accepts(rows12, x_lo, x_hi, y_lo, y_hi):
    """(K,) bool: some pixel centre of the rectangle accepts the pair — K1's
    per-pixel test (three edges and z >= 0, z < 1.0, the first zbuf)."""
    gy, gx = torch.meshgrid(
        torch.arange(y_lo - 0.5, y_hi), torch.arange(x_lo - 0.5, x_hi), indexing="ij"
    )
    px = gx.reshape(1, -1).to(torch.float32) + 0.5
    py = gy.reshape(1, -1).to(torch.float32) + 0.5
    r = rows12

    def plane(j):
        return r[:, j : j + 1] * px + r[:, j + 1 : j + 2] * py + r[:, j + 2 : j + 3]

    z = plane(9)
    ok = (plane(0) >= 0.0) & (plane(3) >= 0.0) & (plane(6) >= 0.0) & (z >= 0.0) & (z < 1.0)
    return ok.any(dim=1)


def _check(rows, rect):
    """Assert the rule is sound on the rectangle; returns (rejected, accepted)."""
    rows12 = torch.from_numpy(np.ascontiguousarray(rows, F32))
    rejected = raster_tiles.block_rejects(rows12, *rect)
    accepted = _accepts(rows12, *rect)
    bad = torch.nonzero(rejected & accepted).reshape(-1)
    assert bad.numel() == 0, (rect, rows[bad[0].item()])
    return rejected, accepted


def _rect(x, y, w, h):
    """Pixel centres of the w x h rectangle at pixel (x, y)."""
    return (x + 0.5, x + w - 1 + 0.5, y + 0.5, y + h - 1 + 0.5)


# Planes through a point near the rectangle (so that e = 0 falls inside
# or just outside it), with coefficients from the whole f32 range and the
# special values.
_coef = st.one_of(
    st.floats(-1e6, 1e6, width=32),
    st.sampled_from(SPECIALS),
    st.floats(width=32, allow_nan=True, allow_infinity=True),
)


@st.composite
def _case(draw):
    w, h = draw(st.sampled_from([(1, 1), (16, 16), (32, 32), (64, 4), (2, 8)]))
    x = draw(st.integers(0, 4032 - w))
    y = draw(st.integers(0, 4032 - h))
    rows = np.zeros((4, 12), F32)
    for k in range(4):
        for j in (0, 3, 6, 9):
            a, b = F32(draw(_coef)), F32(draw(_coef))
            u = F32(x + draw(st.floats(-3.0, w + 3.0, width=32)))
            v = F32(y + draw(st.floats(-3.0, h + 3.0, width=32)))
            level = F32(draw(st.sampled_from([0.0, 1.0, -0.0])) if j == 9 else 0.0)
            if draw(st.booleans()):
                with np.errstate(all="ignore"):
                    c = level - (a * u + b * v)
            else:
                c = F32(draw(_coef))
            rows[k, j : j + 3] = (a, b, c)
    return rows, _rect(x, y, w, h)


@seed(20261017)
@settings(max_examples=250, deadline=None, database=None)
@given(_case())
def test_block_rejects_never_rejects_an_accepting_rectangle(case):
    _check(*case)


def _near_rects(rng, n, lo=0, hi=4032):
    """n rectangles of the shapes K1's blocks take (and 1x1), at pixel
    coordinates in [lo, hi)."""
    shapes = [(16, 16), (32, 32), (1, 1), (64, 4)]
    out = []
    for i in range(n):
        w, h = shapes[i % len(shapes)]
        out.append((int(rng.integers(lo, hi - w)), int(rng.integers(lo, hi - h)), w, h))
    return out


def _triangles(rng, case, x, y, w, h, n=128):
    """(n, 12) f32 rows of one adversarial kind around the rectangle."""
    cx = x + rng.uniform(-6.0, w + 6.0, n)
    cy = y + rng.uniform(-6.0, h + 6.0, n)
    z = rng.uniform(0.0, 1.0, (n, 3))
    if case == "sliver":  # vertex angle 1e-6 .. 1e-2 rad, long edge through the rectangle
        length = rng.uniform(4.0, 300.0, n)
        th = rng.uniform(0.0, 2.0 * np.pi, n)
        lean = length / 2 * np.tan(10.0 ** rng.uniform(-6.0, -2.0, n))
        vx = np.stack([cx - length / 2 * np.cos(th), cx + length / 2 * np.cos(th),
                       cx - lean * np.sin(th)], 1)
        vy = np.stack([cy - length / 2 * np.sin(th), cy + length / 2 * np.sin(th),
                       cy + lean * np.cos(th)], 1)
        return synthetic.edge_and_z_rows(vx, vy, z).astype(F32)
    if case == "pixel_centres":  # right triangles with vertices on pixel centres
        ox, oy = np.floor(cx) + 0.5, np.floor(cy) + 0.5
        dx = rng.integers(1, 20, n) * rng.choice([-1, 1], n)
        dy = rng.integers(1, 20, n) * rng.choice([-1, 1], n)
        vx = np.stack([ox, ox + dx, ox], 1)
        vy = np.stack([oy, oy, oy + dy], 1)
        rows = synthetic.edge_and_z_rows(vx, vy, z).astype(F32)
        rows[: n // 4, 9:12] = (0.0, 0.0, 0.0)  # z = 0 exactly on the whole plane
        return rows
    rows = synthetic.raster_rows(rng, cx, cy)
    if case == "huge":  # edge coefficients up to 1e6
        scale = 10.0 ** rng.uniform(3.0, 6.0, n) / np.maximum(np.abs(rows[:, :2]).max(1), 1e-3)
        with np.errstate(all="ignore"):
            rows[:, :9] = (rows[:, :9] * scale[:, None]).astype(F32)
    elif case == "specials":  # +-0, +-inf, NaN in random coefficients
        k = rng.integers(0, 12, (n, 2))
        vals = np.array(SPECIALS, F32)[rng.integers(0, len(SPECIALS), (n, 2))]
        rows[np.arange(n)[:, None], k] = vals
    return rows


@pytest.mark.parametrize("case", ["mix", "sliver", "huge", "pixel_centres", "specials", "far"])
def test_block_rejects_adversarial_planes(case):
    """Each kind of plane around 64 rectangles: the rule never rejects an
    accepting rectangle, and it does reject and keep some (it is not
    vacuous)."""
    rng = np.random.default_rng(["mix", "sliver", "huge", "pixel_centres", "specials",
                                 "far"].index(case))
    lo = 3800 if case == "far" else 0  # pixel coordinates up to 4032
    n_rej = n_acc = 0
    for x, y, w, h in _near_rects(rng, 64, lo=lo):
        rows = _triangles(rng, "mix" if case == "far" else case, x, y, w, h)
        rejected, accepted = _check(rows, _rect(x, y, w, h))
        n_rej += int(rejected.sum())
        n_acc += int(accepted.sum())
    assert n_rej > 0 and n_acc > 0, (n_rej, n_acc)


def _cull_then_plain(args, kw, bh, bw):
    """K1's plain version over the lists culled per bh x bw sub-tile, cut to
    the tile as K1 clips the sub-tiles on a tile's right and bottom edges:
    the buffer is cut into cells (the gcd of the tile's and the sub-tile's
    sides), each a tile of its own whose list keeps, in list order, the
    pairs of its tile that block_rejects does not reject for its sub-tile.
    Returns the plain raster of that and the kept pairs over all sub-tiles."""
    rows, lane0, sorted_slot, tile_start, tiles_x, tiles_y, th, tw = args
    gh, gw = math.gcd(th, bh), math.gcd(tw, bw)
    cells_x = tiles_x * tw // gw
    kept = [None] * (cells_x * tiles_y * th // gh)
    n_kept = 0
    for t in range(tiles_x * tiles_y):
        seg = sorted_slot[int(tile_start[t]) : int(tile_start[t + 1])]
        r12 = rows[seg.long(), lane0 : lane0 + 12]
        for y in range(0, th, bh):
            for x in range(0, tw, bw):
                x0, y0 = (t % tiles_x) * tw + x, (t // tiles_x) * th + y
                w, h = min(bw, tw - x), min(bh, th - y)
                keep = seg[~raster_tiles.block_rejects(r12, *_rect(x0, y0, w, h))]
                n_kept += keep.numel()
                for cy in range(y0 // gh, (y0 + h) // gh):
                    for cx in range(x0 // gw, (x0 + w) // gw):
                        kept[cy * cells_x + cx] = keep
    counts = torch.tensor([0] + [k.numel() for k in kept])
    new_start = torch.cumsum(counts, 0).to(torch.int32)
    new_slot = torch.cat(kept).to(torch.int32)
    out = raster_tiles.raster_tiles_plain(
        rows, lane0, new_slot, new_start, cells_x, len(kept) // cells_x, gh, gw, **kw
    )
    return out, n_kept


@pytest.fixture(scope="module")
def dense_tile():
    args, kw = synthetic.k1_dense_tile("cpu", seed=3, n_pairs=2304)
    return args, kw, raster_tiles.raster_tiles_plain(*args, **kw)


@pytest.mark.parametrize("bh,bw", [(16, 16), (32, 32), (4, 64)])
def test_cull_then_plain_equals_plain_on_dense_tile(dense_tile, bh, bw):
    """A 64 x 64 tile of 2,304 pairs (duplicate rows inside one of K1's
    128-pair chunks and across chunk boundaries, equal-z groups, z = +-0 planes, slivers,
    NaN / inf planes): culling each sub-tile's list first changes no pixel's
    depth or slot, and the synthetic tile does exercise depth ties and
    z = 0 wins."""
    args, kw, (zbuf, ibuf) = dense_tile
    (z2, i2), n_kept = _cull_then_plain(args, kw, bh, bw)
    n_pairs = int(args[3][-1])
    assert 0 < n_kept < n_pairs * (64 // bh) * (64 // bw) // 2  # the cull removes most
    assert torch.equal(z2, zbuf) and torch.equal(i2, ibuf)
    assert int((zbuf == F32(0.01)).sum()) > 50  # the equal-z group wins pixels
    assert int((zbuf == 0.0).sum()) > 10  # z = +-0 planes win pixels
    assert int((ibuf >= 0).sum()) == 64 * 64


# (tile_h, tile_w, sub-tile h, sub-tile w, depth_only): the sub-tile K1
# takes for each tile shape (raster_tiles.block_layout): those of
# utils/synthetic.K1_TILES tile their tile exactly; those of K1_NEW_TILES
# up to 8,192 pixels hang over its right or bottom edge, or both.
TILE_SHAPES = [(16, 16, 16, 16, False), (32, 32, 16, 16, False), (16, 64, 16, 16, False),
               (48, 16, 16, 16, False), (12, 64, 4, 64, False), (8, 32, 8, 32, True),
               (2, 128, 2, 128, True), (64, 64, 16, 16, True),
               (8, 16, 16, 16, False), (16, 8, 16, 16, True), (1, 128, 2, 128, False),
               (128, 1, 128, 2, True), (16, 24, 16, 16, True), (64, 128, 16, 16, False)]


@pytest.mark.parametrize("th,tw,bh,bw,depth_only", TILE_SHAPES)
def test_cull_then_plain_equals_plain_at_every_tile_shape(th, tw, bh, bw, depth_only):
    """utils/synthetic.k1_tiles' 3 x 2 grid of th x tw tiles: culling each
    sub-tile's list first, the edge sub-tiles cut to the tile, gives the
    plain raster's zbuf and ibuf exactly."""
    assert raster_tiles.block_layout(th, tw)[:2] == (bh, bw)
    args, kw = synthetic.k1_tiles("cpu", th, tw, depth_only)
    zbuf, ibuf = raster_tiles.raster_tiles_plain(*args, **kw)
    (z2, i2), n_kept = _cull_then_plain(args, kw, bh, bw)
    assert 0 < n_kept and bool((zbuf < 1.0).any()) and torch.equal(z2, zbuf)
    assert (i2 is None) == (ibuf is None) == depth_only
    assert depth_only or torch.equal(i2, ibuf)
