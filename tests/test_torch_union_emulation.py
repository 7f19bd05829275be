"""A numpy emulation of the index logic of the SpAdd3 rows union
(``union_bounds_kernel`` and ``union_rows_kernel`` in
src/repro_torch/kernels/csrc/spadd3.cu), held against the plain versions
and the JAX package's leaves ``leaf_spadd3_rows`` and
``leaf_bcsr_spadd3_rows``.

Tasks: row g of the P·R rows gets ceil(len / 256) of them (len: its entries
in B, C and D together); task j > 0 starts, in each list, at the lower
bound of v_j, 1 + the (256 j)-th smallest column of the row, found as the
kernel finds it, by discarding: of the split tasks of one row in one warp
of 32 tasks, the first and the last search the row's whole lists and the
others only between their results (asserted equal to the definition). Units: each
task has a nominal position (a row's tasks 256 apart, rows at least 8
apart), a unit is 256 of them, and a warp merges the tasks of one unit (at
most 32), piece by piece. Entries are merged by the key (task, column) in
windows: up to 128 entries of each list are staged, and the window takes
the keys below L, the least key not staged of a list that did not fit; a
window that takes nothing is a key with more than 128 entries in one list,
summed entry by entry. The merged order comes from two merge paths, B with
C and then that with D, lane by lane as the kernel writes them (each
output written once, the result sorted by key with earlier lists first on
ties); a union entry starts where the key changes, and each task's count
is the number of them. A unit's union entries are written from out_off of
its first task on, each slot once. Values: 0 + B's entries + C's + D's of
the column, in storage order, float32, tiles element by element.

Held: coordinates exactly against the plain versions and the JAX leaves;
values bit for bit against a direct (B + C) + D sum in that order, and at
1e-6 against the plain versions and the JAX leaves (three-term sums in
another order). The pieces: chip_smoke.union_task_pieces (duplicate
columns inside a list, a row of nine tasks with equal columns at the split
values, a column of 501 entries, empty rows, three identical lists, a list
alone over two windows, an empty piece) at tiles (), (4, 4), (1, 3) and
(3, 2), and random pieces with repeats.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro_torch.kernels import _build, spadd3

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TASK, WIN = spadd3.TASK, 128            # TASK; kWin in csrc/spadd3.cu
BIAS = 1 << 31                          # kColBias


def _lower(a, lo, hi, v):
    """First index in [lo, hi) with a[i] >= v (the kernel's lower_bound)."""
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] < v:
            lo = mid + 1
        else:
            hi = mid
    return lo


def kth_column(crd, st, hi, k):
    """kth_column: the k-th smallest column (1-based) of lists t in
    [st[t], hi[t]) by discarding; st moves past discarded columns."""
    st = list(st)
    while True:
        s = max(k // 3, 1)
        best, m, take = None, 0, 0
        for t in range(3):
            n = hi[t] - st[t]
            if n > 0:
                a = 1 if k == 1 else min(s, n)
                v = int(crd[t][st[t] + a - 1])
                if best is None or v < best:
                    best, m, take = v, t, a
        if k == 1:
            return best, st
        st[m] += take
        k -= take


def split_in(crd, b, hi, k):
    """split_in: (v = 1 + the k-th smallest column of [b, hi), each list's
    lower bound of v)."""
    kth, st = kth_column(crd, b, hi, k)
    return kth + 1, [_lower(crd[t], st[t], hi[t], kth + 1) for t in range(3)]


def bounds(pos, crd):
    """union_bounds_kernel: (task_off, trow, tbeg, tend, tunit,
    n_units)."""
    P, R = pos[0].shape[0], pos[0].shape[1] - 1
    lens = sum(p[:, 1:] - p[:, :-1] for p in pos).astype(np.int64).ravel()
    n_tasks = -(-lens // TASK)
    weight = np.where(n_tasks > 0, np.maximum(
        lens, (n_tasks - 1) * TASK + spadd3.MIN_WEIGHT), 0)
    task_off = np.concatenate([[0], np.cumsum(n_tasks)])
    unit_at = np.concatenate([[0], np.cumsum(weight)])
    T = int(task_off[-1])
    n_units = -(-int(unit_at[-1]) // TASK)
    trow = np.repeat(np.arange(P * R), n_tasks)
    tbeg = np.full((T, 3), -1, np.int64)
    tend = np.full((T, 3), -1, np.int64)
    tunit = np.zeros(T, np.int64)
    rows = []                                    # (p, r, j, lo, hi, lists)
    for t in range(T):
        g = trow[t]
        p, r = divmod(g, R)
        rows.append((p, r, t - task_off[g],
                     [int(pos[s][p, r]) for s in range(3)],
                     [int(pos[s][p, r + 1]) for s in range(3)],
                     [crd[s][p] for s in range(3)]))
    found = {}                                   # t: (v_j, lower bounds)
    for w0 in range(0, T, 32):                   # a warp of 32 tasks
        group = {}
        for t in range(w0, min(T, w0 + 32)):
            if rows[t][2] > 0:
                group.setdefault(trow[t], []).append(t)
        for ts in group.values():
            for t in sorted({ts[0], ts[-1]}):    # the row's whole lists
                _, _, j, lo, hi, c = rows[t]
                found[t] = split_in(c, lo, hi, j * TASK)
            (v_lo, b_lo), (_, b_hi) = found[ts[0]], found[ts[-1]]
            for t in ts[1:-1]:                   # between the two
                _, _, j, lo, hi, c = rows[t]
                n = sum(b_lo[s] - lo[s] for s in range(3))
                found[t] = ((v_lo, b_lo) if n >= j * TASK
                            else split_in(c, b_lo, b_hi, j * TASK - n))
    for t in range(T):
        g = trow[t]
        _, _, j, lo, hi, c = rows[t]
        b = lo
        if j > 0:
            v, b = found[t]
            merged = np.sort(np.concatenate([c[s][lo[s]:hi[s]]
                                             for s in range(3)]))
            assert v == merged[j * TASK - 1] + 1      # the definition
            assert b == [_lower(c[s], lo[s], hi[s], v) for s in range(3)]
        tbeg[t] = b
        if j > 0:
            tend[t - 1] = b
        if t + 1 == task_off[g + 1]:
            tend[t] = hi
        tunit[t] = (unit_at[g] + j * TASK) // TASK
    assert (tend >= 0).all() and (tend >= tbeg).all()
    return task_off, trow, tbeg, tend, tunit, n_units


def merge_path(ka, kb, ca, cb):
    """merge_path: the codes of A and B merged, A first on equal keys, as
    the 32 lanes write them: lane l from d = l * n // 32 on, after a
    binary search along the diagonal."""
    na, nb = len(ka), len(kb)
    n = na + nb
    out = [None] * n
    for lane in range(32):
        d0, d1 = lane * n // 32, (lane + 1) * n // 32
        lo, hi = max(d0 - nb, 0), min(d0, na)
        while lo < hi:
            i = (lo + hi) >> 1
            if ka[i] <= kb[d0 - 1 - i]:
                lo = i + 1
            else:
                hi = i
        ia, ib = lo, d0 - lo
        for d in range(d0, d1):
            assert out[d] is None, "two lanes write one output"
            if ib >= nb or (ia < na and ka[ia] <= kb[ib]):
                out[d], ia = ca[ia], ia + 1
            else:
                out[d], ib = cb[ib], ib + 1
    return out


def emulate(pos, crd, vals):
    """(row_pos, crd, vals) of the union over the P·R rows, as the
    kernels compute them; ``pos``, ``crd`` and ``vals`` hold B, C, D."""
    R = pos[0].shape[1] - 1
    tile = vals[0].shape[2:]
    task_off, trow, tbeg, tend, tunit, n_units = bounds(pos, crd)
    T = trow.size
    cnt = np.zeros(T, np.int64)
    units = []                               # per unit: (t0, [(col, val)])
    for unit in range(n_units):              # union_rows_kernel
        t0 = int(np.searchsorted(tunit, unit))   # ufirst: its least task
        nk = int(sum(t0 + k < T and tunit[t0 + k] == unit
                     for k in range(32)))
        if nk == 0:
            continue                         # no task starts here
        assert t0 + nk == T or tunit[t0 + nk] != unit, \
            "a unit of more than a warp of tasks"
        tb, te = tbeg[t0:t0 + nk], tend[t0:t0 + nk]
        out = []                             # [column, value] per entry
        ta = 0
        while ta < nk:
            p = trow[t0 + ta] // R
            tz = ta + 1
            while tz < nk and trow[t0 + tz] // R == p:
                tz += 1
            c = [crd[s][p] for s in range(3)]
            v = [vals[s][p] for s in range(3)]

            def key(s, q):
                k = ta + int(np.searchsorted(tb[ta:tz, s], q, "right")) - 1
                return (k << 32) + int(c[s][q]) + BIAS

            cur = [int(tb[ta, s]) for s in range(3)]
            end = [int(te[tz - 1, s]) for s in range(3)]
            while True:
                take = [min(end[s] - cur[s], WIN) for s in range(3)]
                over = [key(s, cur[s] + WIN) for s in range(3)
                        if end[s] - cur[s] > WIN]
                if sum(take) == 0:
                    break
                w = [np.array([key(s, cur[s] + i) for i in range(take[s])],
                              np.int64) for s in range(3)]
                n = [take[s] if not over else
                     _lower(w[s], 0, take[s], min(over)) for s in range(3)]
                if sum(n) == 0:                      # > WIN entries of a key
                    L = min(over)
                    k, col = L >> 32, (L & 0xffffffff) - BIAS
                    e2 = [_lower(c[s], cur[s], max(cur[s], int(te[k, s])),
                                 col + 1) for s in range(3)]
                    acc = np.zeros(tile, np.float32)
                    for s in range(3):
                        for e in range(cur[s], e2[s]):
                            acc = (acc + v[s][e]).astype(np.float32)
                    out.append([col, acc])
                    cnt[t0 + k] += 1
                    cur = e2
                    continue
                bc = merge_path([w[0][i] for i in range(n[0])],
                                [w[1][i] for i in range(n[1])],
                                [(0, i) for i in range(n[0])],
                                [(1, i) for i in range(n[1])])
                order = merge_path([w[s][i] for s, i in bc],
                                   [w[2][i] for i in range(n[2])], bc,
                                   [(2, i) for i in range(n[2])])
                assert order == sorted(order, key=lambda c: (w[c[0]][c[1]],
                                                             c))
                for r, (s, i) in enumerate(order):
                    first = r == 0 or w[s][i] != w[order[r - 1][0]][
                        order[r - 1][1]]
                    cnt[t0 + (w[s][i] >> 32)] += first
                    if first:
                        out.append([(int(w[s][i]) & 0xffffffff) - BIAS,
                                    np.zeros(tile, np.float32)])
                    out[-1][1] = (out[-1][1] + v[s][cur[s] + i]) \
                        .astype(np.float32)
                cur = [cur[s] + n[s] for s in range(3)]
            ta = tz
        units.append((t0, out))
    out_off = np.concatenate([[0], np.cumsum(cnt)])
    U = int(out_off[-1])
    out_crd = np.zeros(U, np.int64)
    out_vals = np.zeros((U,) + tile, np.float32)
    writes = np.zeros(U, np.int64)
    for t0, out in units:                    # the fill: from out_off[t0] on
        for k, (col, acc) in enumerate(out):
            out_crd[out_off[t0] + k] = col
            out_vals[out_off[t0] + k] = acc
            writes[out_off[t0] + k] += 1
    assert (writes == 1).all(), "a union slot not written once"
    return out_off[task_off], out_crd, out_vals


def direct(pos, crd, vals):
    """The union per row by a dict, each column summed from 0 over B's
    entries, then C's, then D's, in storage order."""
    P, R = pos[0].shape[0], pos[0].shape[1] - 1
    tile = vals[0].shape[2:]
    row_pos, cols, sums = [0], [], []
    for p in range(P):
        for r in range(R):
            acc = {}
            for s in range(3):
                for e in range(pos[s][p, r], pos[s][p, r + 1]):
                    k = int(crd[s][p, e])
                    acc[k] = (acc.get(k, np.zeros(tile, np.float32))
                              + vals[s][p, e]).astype(np.float32)
            for k in sorted(acc):
                cols.append(k)
                sums.append(acc[k])
            row_pos.append(len(cols))
    return (np.array(row_pos), np.array(cols, np.int64),
            np.array(sums, np.float32).reshape((-1,) + tile))


def _check(flat):
    pos, crd, vals = flat[0::3], flat[1::3], flat[2::3]
    block = vals[0].ndim == 4
    got = emulate(pos, crd, vals)
    want = direct(pos, crd, vals)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)          # bit for bit
    before = dict(_build.LAUNCHES)
    wrapper = (spadd3.bcsr_spadd3_union_rows if block
               else spadd3.spadd3_union_rows)
    plain = [x.numpy() for x in wrapper(*(torch.from_numpy(x)
                                          for x in flat))]
    assert _build.LAUNCHES == before                  # the CPU launches none
    np.testing.assert_array_equal(got[0], plain[0])
    np.testing.assert_array_equal(got[1], plain[1])
    np.testing.assert_allclose(got[2], plain[2], atol=1e-6)
    P, R = pos[0].shape[0], pos[0].shape[1] - 1
    for p in range(P):
        lo, hi = got[0][p * R], got[0][p * R + R]
        if all(x[p, -1] == x[p, 0] for x in pos):
            assert lo == hi                           # an empty piece
            continue                                  # (the jnp leaf raises)
        args = [x[p] for x in flat]
        if block:
            rr, cc, vv, k = rref.leaf_bcsr_spadd3_rows(*args)
        else:
            rr, cc, vv, k = rref.leaf_spadd3_rows(*args, n_cols=0)
        k = int(k)
        assert k == hi - lo
        rows = np.repeat(np.arange(R), np.diff(got[0][p * R:p * R + R + 1]))
        np.testing.assert_array_equal(np.asarray(rr)[:k], rows)
        np.testing.assert_array_equal(np.asarray(cc)[:k], got[1][lo:hi])
        np.testing.assert_allclose(np.asarray(vv)[:k], got[2][lo:hi],
                                   atol=1e-6)


@pytest.mark.parametrize("tile", [(), (4, 4), (1, 3), (3, 2)])
def test_task_edge_pieces(tile):
    _check(chip_smoke.union_task_pieces(np.random.default_rng(len(tile)),
                                        tile))


@pytest.mark.parametrize("seed", range(6))
def test_random_pieces(seed):
    """Two pieces of rows whose three lists draw 0-400 columns each from a
    narrow range (so repeats inside a list and equal columns at split
    values are common), some rows empty in one or all lists, and a padding
    tail."""
    rng = np.random.default_rng(seed)
    P, R = 2, 12
    tile = ((), (2, 2))[seed % 2]
    flat = []
    for _ in range(3):
        lens = rng.integers(0, 400, (P, R)) * (rng.random((P, R)) < 0.7)
        pos = np.zeros((P, R + 1), np.int32)
        np.cumsum(lens, axis=1, out=pos[:, 1:])
        N = int(pos[:, -1].max()) + 5
        crd = np.full((P, N), 1 << 30, np.int32)
        vals = np.full((P, N) + tile, 1e30, np.float32)
        for p in range(P):
            for r in range(R):
                a, b = pos[p, r], pos[p, r + 1]
                crd[p, a:b] = np.sort(rng.integers(0, 60, b - a))
            k = int(pos[p, -1])
            vals[p, :k] = rng.standard_normal((k,) + tile)
        flat += [pos, crd, vals]
    _check(flat)
