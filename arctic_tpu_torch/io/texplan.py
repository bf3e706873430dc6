"""Host-side material-group planning for the grouped tile route — the
port's numpy copy of arctic_tpu/io/texplan.py.

The grouped tap (ops/sampling.tile_tap_resolve_grouped) serves a 128-pixel
row that touches one material group with one compacted gather from that
group's table, a row of two groups with two, and a row of more with the
full-table fallback. plan_material_groups partitions the materials into
groups from measured row masks (pipeline.measure_tex_row_masks over a
camera path) by a simulated-annealing swap search under the JAX package's
cost model, with the same ``np.random.default_rng(seed)`` draws, so both
packages plan the same groups from the same masks. The model's ns-per-row
constants were measured on a TPU; here they only weigh dual-claim rows
against fallback rows. The rows are counted over their distinct masks
with multiplicities (the same integers, so the same plan, without a pass
over every row of every frame per step). Rebuild with
build_buffers(..., tex_groups=plan).
"""

from __future__ import annotations

import numpy as np

NS_FAST = 1.81
NS_SLOW = 9.90


def _touch_stats(masks: np.ndarray, gsets: list[int], weight: np.ndarray):
    """(uniform, dual, many) row counts for group bitsets over distinct
    row masks, each counted ``weight`` times."""
    covered = masks != 0
    touched = np.stack([(masks & gs) != 0 for gs in gsets], axis=-1)
    cnt = touched.sum(-1)
    uni = int(weight[(cnt <= 1) & covered].sum())
    dual = int(weight[cnt == 2].sum())
    many = int(weight[cnt >= 3].sum())
    return uni, dual, many


def _cost(uni, dual, many, n_frames):
    return (
        128.0 * (NS_FAST * (uni + 2 * dual) + NS_SLOW * many) / n_frames / 1e6
    )


def plan_material_groups(
    masks: np.ndarray,
    mat_rows: list[int],
    env_rows: int,
    budget_rows: int,
    iters: int = 12000,
    seed: int = 0,
):
    """Anneal a material -> group partition minimizing the dual-claim cost.

    masks: (F, R) int bitmasks from pipeline.measure_tex_row_masks;
    mat_rows: tile rows per material; env_rows / budget_rows: the env-copy
    size and per-group row budget (a group + env must stay under the
    fast-gather tier). Returns (groups list-of-lists, modeled_cost_ms).
    The rows are counted over their distinct masks, each weighted by how
    often it occurs: the same integer counts, so the same costs and plan as
    the JAX package's row-by-row count.
    """
    m = len(mat_rows)
    masks = masks.astype(np.int64)
    nf = masks.shape[0]
    masks, weight = np.unique(masks.reshape(-1), return_counts=True)

    # Greedy seed: heaviest co-occurrence first, into the best-fitting group.
    nz = masks != 0
    flat, w_flat = masks[nz], weight[nz]
    c = np.zeros((m, m), np.int64)
    for a in range(m):
        ba = (flat >> a) & 1
        for b in range(a + 1, m):
            c[a, b] = c[b, a] = int((w_flat * (ba & ((flat >> b) & 1))).sum())
    cap_rows = budget_rows - env_rows
    groups: list[list[int]] = []
    rows_of: list[int] = []
    for mi in np.argsort(-c.sum(1)):
        mi = int(mi)
        best, best_s = None, -1
        for gi, g in enumerate(groups):
            if rows_of[gi] + mat_rows[mi] > cap_rows:
                continue
            s = sum(c[mi, o] for o in g)
            if s > best_s:
                best, best_s = gi, s
        if best is None:
            groups.append([mi])
            rows_of.append(mat_rows[mi])
        else:
            groups[best].append(mi)
            rows_of[best] += mat_rows[mi]

    g_n = len(groups)
    assign = np.zeros(m, np.int64)
    for gi, g in enumerate(groups):
        for mi in g:
            assign[mi] = gi

    def gsets_of(a):
        gs = [0] * g_n
        for mi, gi in enumerate(a):
            gs[gi] |= 1 << mi
        return [np.int64(x) for x in gs]

    def score(a):
        return _cost(*_touch_stats(masks, gsets_of(a), weight), nf)

    def rows_by_group(a):
        out = [0] * g_n
        for mi, gi in enumerate(a):
            out[gi] += mat_rows[mi]
        return out

    rng = np.random.default_rng(seed)
    cur = assign.copy()
    s = score(cur)
    best, best_s = cur.copy(), s
    t0, t1 = max(s * 0.05, 0.01), 0.002
    for it in range(iters):
        t = t0 * (t1 / t0) ** (it / max(iters - 1, 1))
        a, b = rng.integers(0, m, 2)
        if cur[a] == cur[b]:
            continue
        nxt = cur.copy()
        nxt[a], nxt[b] = cur[b], cur[a]
        rg = rows_by_group(nxt)
        if max(rg) > cap_rows:
            continue
        s2 = score(nxt)
        if s2 < s or rng.random() < np.exp((s - s2) / t):
            cur, s = nxt, s2
            if s < best_s:
                best, best_s = cur.copy(), s
    plan = [
        sorted(int(mi) for mi in np.where(best == gi)[0]) for gi in range(g_n)
    ]
    return [g for g in plan if g], best_s
