"""Random sparse matrix generators for tests and benchmarks.

The reference has no fixtures (inputs are external row-sorted files,
README.md:29); the test strategy mandated by SURVEY.md section 4 needs
reproducible synthetic matrices covering the reference's hard cases:
empty rows (csr.cpp:115-117, csr_hw.cpp:340-347), power-law row lengths
(load balance, csr_hw.cpp:459-468), dense rows/cols, banded structure.
"""

from __future__ import annotations

import numpy as np

from .csr import CSRMatrix, INDEX_DTYPE


def random_csr(nr_rows: int, nr_cols: int, density: float = 0.01,
               dtype=np.float64, seed=0, empty_row_frac: float = 0.0,
               powerlaw: bool = False) -> CSRMatrix:
    rng = np.random.default_rng(seed)
    if powerlaw:
        raw = rng.pareto(1.2, size=nr_rows) + 1.0
        raw = raw / raw.sum() * density * nr_rows * nr_cols
        row_nnz = np.minimum(raw.astype(np.int64), nr_cols)
    else:
        lam = density * nr_cols
        row_nnz = np.minimum(rng.poisson(lam, size=nr_rows), nr_cols)
    if empty_row_frac > 0:
        row_nnz[rng.random(nr_rows) < empty_row_frac] = 0
    rows = np.repeat(np.arange(nr_rows, dtype=np.int64), row_nnz)
    # distinct columns per row
    cols = np.empty(rows.shape[0], dtype=np.int64)
    off = 0
    for r in range(nr_rows):
        k = int(row_nnz[r])
        if k:
            cols[off:off + k] = rng.choice(nr_cols, size=k, replace=False)
            off += k
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    return CSRMatrix.from_coo(rows.astype(INDEX_DTYPE),
                              cols.astype(INDEX_DTYPE), vals,
                              nr_rows, nr_cols)


def banded_csr(nr_rows: int, nr_cols: int, bandwidth: int = 16,
               dtype=np.float64, seed=0) -> CSRMatrix:
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(nr_rows):
        lo = max(0, r - bandwidth)
        hi = min(nr_cols, r + bandwidth + 1)
        if hi > lo:
            c = np.arange(lo, hi)
            rows.append(np.full(c.shape[0], r))
            cols.append(c)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    return CSRMatrix.from_coo(rows, cols, vals, nr_rows, nr_cols)


def laplace_2d(n: int, dtype=np.float64) -> CSRMatrix:
    """5-point 2D Laplacian on an n x n grid (classic SpMV benchmark and a
    symmetric positive-definite matrix for the CG solver tests)."""
    N = n * n
    idx = np.arange(N).reshape(n, n)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [np.full(N, 4.0)]
    for dr, dc in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        src = idx[max(0, -dr):n - max(0, dr), max(0, -dc):n - max(0, dc)]
        dst = idx[max(0, dr):n + min(0, dr), max(0, dc):n + min(0, dc)]
        rows.append(src.ravel())
        cols.append(dst.ravel())
        vals.append(np.full(src.size, -1.0))
    return CSRMatrix.from_coo(np.concatenate(rows), np.concatenate(cols),
                              np.concatenate(vals).astype(dtype), N, N)


def fem_poisson_3d(n: int, dtype=np.float64) -> CSRMatrix:
    """27-point (tri-quadratic FEM) 3D Poisson discretization on an
    n^3 grid — a REAL structured PDE matrix (the suite's cant/consph
    class: clustered banded blocks), generated deterministically so a
    genuine non-i.i.d. pattern can be benchmarked on an air-gapped
    machine.  SPD, rows have up to 27 nnz in
    3 clustered bands of 3 runs each."""
    idx = np.arange(n, dtype=np.int64)
    I, J, K = np.meshgrid(idx, idx, idx, indexing="ij")
    base = (I * n + J) * n + K
    rows_l, cols_l, vals_l = [], [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                ok = ((I + di >= 0) & (I + di < n)
                      & (J + dj >= 0) & (J + dj < n)
                      & (K + dk >= 0) & (K + dk < n))
                nb = ((I + di) * n + (J + dj)) * n + (K + dk)
                w = 26.0 if (di, dj, dk) == (0, 0, 0) else                     -1.0 / (abs(di) + abs(dj) + abs(dk))
                rows_l.append(base[ok].reshape(-1))
                cols_l.append(nb[ok].reshape(-1))
                vals_l.append(np.full(int(ok.sum()), w, dtype=dtype))
    return CSRMatrix.from_coo(np.concatenate(rows_l),
                              np.concatenate(cols_l),
                              np.concatenate(vals_l),
                              n ** 3, n ** 3, sum_duplicates=False)


def shell_3d(ns: int = 64, nc: int = 96, nl: int = 3, dof: int = 3,
             dtype=np.float64, seed: int = 0) -> CSRMatrix:
    """Cylindrical-shell FEM assembly (the suite's shipsec1 class,
    /root/reference/README.md:23-29 protocol inputs): nodes on an
    (ns x nc x nl) shell grid — ns length sections, nc circumferential
    positions (WRAPPING), nl thickness layers — coupled over the
    3x3x3 element neighborhood with ``dof`` unknowns per node (dense
    dof x dof blocks).  The circumferential wrap produces the two far
    off-diagonal bands that separate ship-section matrices from plain
    banded ones; generated deterministically for air-gapped protocol
    runs."""
    # circumference as the OUTER axis: the j wrap then couples node
    # blocks at opposite ends of the numbering — the far off-diagonal
    # band pair that distinguishes ship sections from banded matrices
    idx = np.arange(ns * nc * nl, dtype=np.int64).reshape(nc, ns, nl)
    rows_l, cols_l = [], []
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            for dk in (-1, 0, 1):
                si = slice(max(0, -di), ns - max(0, di))
                sk = slice(max(0, -dk), nl - max(0, dk))
                src = idx[:, si, sk]
                dst = np.roll(idx, -dj, axis=0)[
                    :, slice(max(0, di), ns + min(0, di)),
                    slice(max(0, dk), nl + min(0, dk))]
                rows_l.append(src.reshape(-1))
                cols_l.append(dst.reshape(-1))
    nr = np.concatenate(rows_l)
    nccol = np.concatenate(cols_l)
    # expand node coupling to dense dof x dof blocks
    d = np.arange(dof, dtype=np.int64)
    shp = (nr.shape[0], dof, dof)
    rr = np.broadcast_to(nr[:, None, None] * dof + d[None, :, None],
                         shp).reshape(-1)
    cc = np.broadcast_to(nccol[:, None, None] * dof + d[None, None, :],
                         shp).reshape(-1)
    n = ns * nc * nl * dof
    # value-SYMMETRIC like a real stiffness matrix (seed folds into the
    # unordered-pair hash so A[r,c] == A[c,r] by construction)
    lo = np.minimum(rr, cc).astype(np.uint64)
    hi = np.maximum(rr, cc).astype(np.uint64)
    h = (lo * np.uint64(2654435761) + hi * np.uint64(40503)
         + np.uint64(seed) * np.uint64(97)) & np.uint64(0xFFFFFFFF)
    vals = (h.astype(np.float64) / 2**31 - 1.0).astype(dtype)
    # SPD-ish dominant diagonal (solver-friendly like the original)
    vals[rr == cc] = 27.0 * dof
    return CSRMatrix.from_coo(rr, cc, vals, n, n, sum_duplicates=False)


def circuit_netlist(n: int = 170_000, dtype=np.float64,
                    seed: int = 0) -> CSRMatrix:
    """Circuit-simulation netlist graph (the suite's scircuit class):
    mostly 2-terminal local couplings along the node ordering, a sparse
    sprinkle of long-range nets, and a few high-degree hub rows (power
    rails touching thousands of nodes) — the scattered, structure-
    irregular regime the reference's VF=1 exact-nnz stream serves
    (csr_hw.cpp:108-114).  ~5-6 nnz/row, max row degree in the
    hundreds; symmetric with a unit-dominant diagonal."""
    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.int64)
    rows_l, cols_l = [i], [i]                      # diagonal
    # local routing: each node couples forward 1-3 positions
    for w, p in ((1, 0.9), (2, 0.45), (3, 0.2)):
        sel = i[:-w][rng.random(n - w) < p]
        rows_l += [sel, sel + w]
        cols_l += [sel + w, sel]
    # global nets: 12% of nodes get one uniformly random far terminal
    sel = i[rng.random(n) < 0.12]
    far = rng.integers(0, n, sel.shape[0])
    ok = far != sel
    rows_l += [sel[ok], far[ok]]
    cols_l += [far[ok], sel[ok]]
    # hub rails: a handful of nodes touch a random ~0.1-0.3% of the chip
    n_hubs = max(2, n // 40_000)
    hubs = rng.choice(n, n_hubs, replace=False)
    for h in hubs:
        deg = int(rng.integers(n // 1000, n // 300))
        t = rng.choice(n, deg, replace=False)
        t = t[t != h]
        rows_l += [np.full(t.shape[0], h, np.int64), t]
        cols_l += [t, np.full(t.shape[0], h, np.int64)]
    rr = np.concatenate(rows_l)
    cc = np.concatenate(cols_l)
    vals = rng.standard_normal(rr.shape[0]).astype(dtype) * 0.1
    vals[rr == cc] = 10.0
    return CSRMatrix.from_coo(rr, cc, vals, n, n, sum_duplicates=True)
