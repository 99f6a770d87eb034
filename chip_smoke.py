"""Smoke test of sparsetpu on one NVIDIA GPU, through the public entry points.

    python3 chip_smoke.py            # phases device, headline_f32, fem_f64,
                                     # spmm_f32, spgemm (one card)
    python3 chip_smoke.py --routes   # device + the SpMV route table and
                                     # the Triton tile sweep
    python3 chip_smoke.py --four     # device + the row-sharded path on four
                                     # cards, against one card and the gold

Each phase prints one line; any failure exits non-zero without the result
line.  The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
There is no CPU fallback: without a GPU the script fails.  Longer output
(the route table and the tile sweep as JSON) goes to chiprun_out/.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

OUT_DIR = "chiprun_out"


def _require(cond, msg) -> None:
    if not cond:
        raise RuntimeError(msg)


def _line(phase: str, **fields) -> None:
    body = "  ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body}", flush=True)


def _rel_err(y, gold) -> float:
    y = np.asarray(y, np.float64)
    return float(np.max(np.abs(y - gold)) / max(np.max(np.abs(gold)), 1e-300))


def _check(y, gold, dtype, row_nnz) -> tuple:
    """(errors, max relative error) against the gold at the dtype's
    default tolerance for each row's length."""
    from sparsetpu.formats.gold import default_tolerance, verification
    atol, rtol = default_tolerance(dtype, row_nnz)
    return verification(gold, np.asarray(y), atol, rtol), _rel_err(y, gold)


def _window_ms(fn, *args, seconds: float = 1.0) -> tuple:
    """(median ms, calls) of ``fn(*args)``, each call finished with
    block_until_ready, over a window of ``seconds`` on the host clock."""
    import jax
    times, t_end = [], time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3, len(times)


def _device_us(fn, *args, n: int = 10) -> tuple:
    """(device-busy microseconds per call, {kernel: us per call}) from a
    profiler trace of n calls: the union of the GPU stream events."""
    import glob
    import tempfile

    import jax
    from jax.profiler import ProfileData
    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(n):
                jax.block_until_ready(fn(*args))
        pd = ProfileData.from_file(
            glob.glob(f"{d}/plugins/profile/*/*.xplane.pb")[-1])
        spans, kernels = [], {}
        for plane in pd.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if "Stream" not in line.name:
                    continue
                for ev in line.events:
                    spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                    kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                        + ev.duration_ns / n / 1e3)
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / n / 1e3, kernels


def _headline():
    from sparsetpu.formats.random import random_csr
    return random_csr(200_000, 100_000, density=0.0005, seed=1,
                      dtype=np.float32)


def phase_device():
    import jax
    from sparsetpu.utils.runtime import gpu_name_and_power_limit, require_gpu
    dev = require_gpu()
    card = gpu_name_and_power_limit()
    print(card, flush=True)
    _line("device", platform=dev.platform, kind=repr(dev.device_kind),
          count=len(jax.devices()), card=repr(card))
    return dev


def phase_headline(dev):
    import jax
    from sparsetpu import SparseMatrix
    from sparsetpu.bench.harness import median_call_s, peak_hbm_bytes_s
    from sparsetpu.formats.gold import spmv_gold
    from sparsetpu.kernels.spmv_cusparse import uses_cusparse
    m = _headline()
    A = SparseMatrix(m)
    x = A.prepare_x(np.random.default_rng(0).standard_normal(m.nr_cols))
    y = jax.block_until_ready(A @ x)
    in_hlo = uses_cusparse(jax.jit(lambda a, v: a.spmv(v)).lower(
        A, x).compile().as_text())
    errors, rel = _check(y, spmv_gold(m, np.asarray(x)), np.float32,
                         m.row_nnz())
    t = median_call_s(A.spmv, x, repeats=20)
    moved = A.spmv_bytes()
    _line("headline_f32", route=A.route, cusparse_in_hlo=in_hlo,
          nnz=m.nr_nzeros, dtype=y.dtype,
          errors=errors, max_rel_err=rel, median_ms=t * 1e3,
          gnnz_s=m.nr_nzeros / t / 1e9, bytes_per_nnz=moved / m.nr_nzeros,
          peak_share=moved / peak_hbm_bytes_s(dev) / t)
    _require(y.dtype == np.float32, f"y dtype {y.dtype}")
    _require(errors == 0, f"{errors} mismatches")
    _require(in_hlo == (A.route == "cusparse"),
             f"route {A.route}, cuSPARSE custom call compiled: {in_hlo}")
    return m, A


def phase_fem_f64():
    import jax
    from sparsetpu import SparseMatrix
    from sparsetpu.formats.gold import spmv_gold
    from sparsetpu.formats.random import fem_poisson_3d
    from sparsetpu.solvers.cg import cg
    m = fem_poisson_3d(72)
    A = SparseMatrix(m)
    x = np.random.default_rng(1).standard_normal(m.nr_cols)
    y = jax.block_until_ready(A @ x)
    errors, rel = _check(y, spmv_gold(m, x), np.float64,
                         m.row_nnz())
    _require(y.dtype == np.float64, f"y dtype {y.dtype}")
    _require(errors == 0, f"{errors} mismatches (rel err {rel})")
    b = np.ones(m.nr_rows)
    solve = jax.jit(lambda a, rhs: cg(a.spmv, rhs, tol=1e-8, maxiter=5000))
    t0 = time.perf_counter()
    res = jax.block_until_ready(solve(A, b))
    t_solve = time.perf_counter() - t0
    xs = np.asarray(res.x)
    resid = np.linalg.norm(b - m.to_scipy() @ xs) / np.linalg.norm(b)
    _line("fem_f64", route=A.route, nnz=m.nr_nzeros, dtype=y.dtype,
          errors=errors, max_rel_err=rel, cg_iters=int(res.iterations),
          cg_host_rel_residual=resid, cg_s_incl_compile=t_solve)
    _require(res.x.dtype == np.float64, f"x dtype {res.x.dtype}")
    _require(resid < 1e-8 * 1.01, f"host residual {resid}")


def phase_spmm(m, A):
    import jax
    from sparsetpu.formats.gold import spmm_gold
    X = np.random.default_rng(2).standard_normal((m.nr_cols, 8))
    Y = jax.block_until_ready(A @ X)
    # float64 gold of the float32 operands the device multiplies
    G = spmm_gold(m, X.astype(np.float32).astype(np.float64))
    errors = sum(_check(Y[:, k], G[:, k], np.float32,
                        m.row_nnz())[0] for k in range(8))
    _line("spmm_f32", k=8, shape=Y.shape, dtype=Y.dtype, errors=errors,
          max_rel_err=_rel_err(Y, G))
    _require(Y.shape == (m.nr_rows, 8) and Y.dtype == np.float32,
             f"Y {Y.shape} {Y.dtype}")
    _require(errors == 0, f"{errors} mismatches")


def phase_spgemm():
    from sparsetpu import SparseMatrix
    from sparsetpu.formats.gold import spgemm_gold
    from sparsetpu.formats.random import laplace_2d
    a = laplace_2d(256)
    c = SparseMatrix(a) @ a
    g = spgemm_gold(a, a).to_scipy().tocsr()
    g.sort_indices()
    same = (np.array_equal(c.row_ptr, g.indptr)
            and np.array_equal(c.col_ind, g.indices))
    err = _rel_err(c.values, g.data) if same else float("inf")
    _line("spgemm", nnz_c=c.nr_nzeros, dtype=c.values.dtype,
          pattern_equal=same, max_rel_err=err)
    _require(same and err < 1e-12, f"pattern equal {same}, rel err {err}")


def _route_matrices():
    """(name, matrix, config) of the route table: f32 and f64, and each
    matrix again with bf16 values."""
    import ml_dtypes
    from sparsetpu.formats.random import (circuit_netlist, fem_poisson_3d,
                                          random_csr)
    from sparsetpu.formats.suitesparse import synthetic_stand_in
    from sparsetpu.utils.config import SpmvConfig
    fem = fem_poisson_3d(72)
    fem32 = type(fem)(fem.row_ptr, fem.col_ind,
                      fem.values.astype(np.float32), fem.nr_rows,
                      fem.nr_cols)
    f32 = [("headline", _headline()), ("fem72", fem32),
           ("netlist", circuit_netlist(170_000, dtype=np.float32)),
           ("webbase-1M_standin", synthetic_stand_in("webbase-1M")),
           # uniform random rows, longer than the headline's
           ("random128", random_csr(80_000, 100_000, density=0.00128,
                                    seed=2, dtype=np.float32))]
    bf16 = SpmvConfig(dtype=np.dtype(ml_dtypes.bfloat16))
    return ([(f"{n}_f32", m, SpmvConfig(dtype=np.float32)) for n, m in f32]
            + [("fem72_f64", fem, SpmvConfig(dtype=np.float64))]
            + [(f"{n}_bf16", m, bf16) for n, m in f32])


def phase_routes(dev):
    """Every SpMV route on every benchmark matrix: compile at real widths
    (memory analysis printed), check against the gold, trace the device
    time, then time end to end over a window of a second per route, in
    the route order and again in reverse."""
    import jax
    from sparsetpu import SparseMatrix
    from sparsetpu.api.api import ROUTES
    from sparsetpu.bench.harness import peak_hbm_bytes_s
    from sparsetpu.formats.gold import spmm_gold, spmv_gold
    from sparsetpu.kernels import spmv_cusparse
    from sparsetpu.utils.runtime import gpu_name_and_power_limit
    peak = peak_hbm_bytes_s(dev)
    table, failed = [], []
    # the host's floor: a trivial jitted call, synchronised
    one = jax.jit(lambda v: v + 1)
    z = jax.numpy.zeros(1)
    jax.block_until_ready(one(z))
    row = {"matrix": "trivial_call", "e2e_ms": [
        _window_ms(one, z)[0], _window_ms(one, z)[0]]}
    table.append(row)
    _line("routes", **row)
    mats = _route_matrices()
    for name, m, cfg in mats:
        x = np.random.default_rng(3).standard_normal(m.nr_cols)
        gold = spmv_gold(m, x.astype(cfg.compute_dtype))
        rn = m.row_nnz()
        rows, runs = {}, {}
        for route in ROUTES:
            row = {"matrix": name, "route": route, "nnz": m.nr_nzeros,
                   "values": cfg.dtype.name, "row_nnz_max": int(rn.max()),
                   "row_nnz_mean": float(rn.mean())}
            rows[route] = row
            try:
                A = SparseMatrix(m, cfg, backend=route)
                xd = A.prepare_x(x)
                step = jax.jit(lambda a, v: a.spmv(v))
                compiled = step.lower(A, xd).compile()
                if route == "cusparse":
                    row["cusparse_in_hlo"] = spmv_cusparse.uses_cusparse(
                        compiled.as_text())
                    _require(row["cusparse_in_hlo"], "no cuSPARSE custom call")
                print(f"  memory_analysis {name}/{route}: "
                      f"{compiled.memory_analysis()}", flush=True)
                y = jax.block_until_ready(compiled(A, xd))
                row["errors"], row["max_rel_err"] = _check(
                    y, gold, cfg.dtype, rn)
                busy_us, kernels = _device_us(compiled, A, xd)
                moved = A.spmv_bytes()
                row.update(device_us=busy_us, kernels=len(kernels),
                           bytes_per_nnz=moved / m.nr_nzeros,
                           peak_share=moved / peak / busy_us * 1e6)
                if row["errors"]:
                    failed.append(f"{name}/{route}: {row['errors']} errors")
                runs[route] = (compiled, A, xd)
            except Exception as e:  # record, finish the table, then fail
                row["error"] = f"{type(e).__name__}: {str(e)[:300]}"
                failed.append(f"{name}/{route}: {row['error']}")
        order = [r for r in ROUTES if r in runs]
        for route in order + order[::-1]:
            ms, calls = _window_ms(*runs[route])
            rows[route].setdefault("e2e_ms", []).append(ms)
            rows[route].setdefault("calls", []).append(calls)
        for route in ROUTES:
            table.append(rows[route])
            _line("routes", **rows[route])
        del runs
    # SpMM at k=8 on the headline: the XLA route against cuSPARSE's
    # csr_matmat
    from jax.experimental import sparse as jsparse
    m = _headline()
    X = np.random.default_rng(4).standard_normal((m.nr_cols, 8))
    G = spmm_gold(m, X.astype(np.float32).astype(np.float64))
    A = SparseMatrix(m, backend="xla")
    Xd = jax.numpy.asarray(X, np.float32)

    def matmat(a, v):
        return jsparse.csr_matmat(jsparse.CSR(
            (a.values, a.col_ind, a.row_ptr), shape=a.shape), v)

    fns = {"xla": jax.jit(lambda a, v: a.spmm(v)),
           "cusparse": jax.jit(matmat)}
    rows = {}
    for route, fn in fns.items():
        Y = jax.block_until_ready(fn(A, Xd))
        busy_us, _ = _device_us(fn, A, Xd)
        rows[route] = {"matrix": "headline_spmm_k8", "route": route,
                       "max_rel_err": _rel_err(Y, G), "device_us": busy_us}
    for route in list(fns) + list(fns)[::-1]:
        rows[route].setdefault("e2e_ms", []).append(
            _window_ms(fns[route], A, Xd)[0])
    for row in rows.values():
        table.append(row)
        _line("routes", **row)
    tiles = phase_tiles(mats)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "routes.json"), "w") as f:
        json.dump({"device_kind": dev.device_kind,
                   "card": gpu_name_and_power_limit(), "table": table,
                   "tiles": tiles}, f, indent=1)
    _require(not failed, "; ".join(failed))


def phase_tiles(mats):
    """The Triton kernel's tile sweep on the regular matrices of ``mats``
    (as ``_route_matrices`` gives them): widths
    8-64, 512-2048 nonzeros per step, 4 or 8 warps; device time from a
    trace, end to end over a short window.  Returns the rows."""
    import functools

    import jax
    import jax.numpy as jnp
    from sparsetpu.formats.gold import spmv_gold
    from sparsetpu.kernels import spmv_triton as st
    out = []
    for name, m, cfg in mats:
        if name not in ("headline_f32", "fem72_f32", "fem72_f64"):
            continue
        x = np.random.default_rng(3).standard_normal(m.nr_cols)
        gold = spmv_gold(m, x)
        args = (jnp.asarray(m.row_ptr), jnp.asarray(m.col_ind),
                jnp.asarray(m.values), jnp.asarray(x, m.dtype))
        best = None
        for width in (8, 16, 32, 64):
            for per_step in (512, 1024, 2048):
                for warps in (4, 8):
                    fn = jax.jit(functools.partial(
                        st.spmv_triton, nr_rows=m.nr_rows,
                        block_rows=per_step // width, width=width,
                        num_warps=warps))
                    y = jax.block_until_ready(fn(*args))
                    errors = _check(y, gold, m.dtype, m.row_nnz())[0]
                    busy_us, _ = _device_us(fn, *args)
                    row = {"matrix": name, "width": width,
                           "block_rows": per_step // width,
                           "num_warps": warps, "errors": errors,
                           "device_us": busy_us,
                           "e2e_ms": _window_ms(fn, *args,
                                                seconds=0.25)[0],
                           "default": (width == st.WIDTH
                                       and per_step // width == st.BLOCK_ROWS
                                       and warps == st.NUM_WARPS)}
                    out.append(row)
                    _require(errors == 0, f"tile {row}: {errors} errors")
                    if best is None or busy_us < best["device_us"]:
                        best = row
        default = next(r for r in out
                       if r["matrix"] == name and r["default"])
        _line("tiles", matrix=name, best=(best["width"], best["block_rows"],
                                          best["num_warps"]),
              best_device_us=best["device_us"],
              default_device_us=default["device_us"])
    return out


def phase_four():
    """shard_spmv of the headline (f32) and the FEM matrix (f64) over a
    4-GPU mesh, and CG f64 on the mesh, against one card and the gold."""
    import jax
    from sparsetpu import SparseMatrix
    from sparsetpu.dist.spmv_dist import make_mesh, shard_spmv
    from sparsetpu.formats.gold import spmv_gold
    from sparsetpu.formats.random import fem_poisson_3d
    from sparsetpu.solvers.cg import cg
    _require(len(jax.devices()) >= 4, f"{len(jax.devices())} devices")
    mesh = make_mesh(4)
    for name, m in (("headline_f32", _headline()),
                    ("fem72_f64", fem_poisson_3d(72))):
        sh = shard_spmv(m, mesh)
        n_dev = len(sh.values.sharding.device_set)
        _require(n_dev == 4, f"shards on {n_dev} devices")
        x = np.random.default_rng(5).standard_normal(m.nr_cols)
        y4 = jax.block_until_ready(sh.spmv(x))
        y1 = SparseMatrix(m) @ x
        gold = spmv_gold(m, x.astype(m.dtype))
        errors, rel = _check(y4, gold, m.dtype, m.row_nnz())
        _line("four", matrix=name, route=sh.route, shard_devices=n_dev,
              dtype=y4.dtype, errors=errors, max_rel_err_gold=rel,
              max_rel_diff_one_card=_rel_err(y4, np.asarray(y1, np.float64)))
        _require(errors == 0 and y4.dtype == m.dtype,
                 f"{errors} mismatches, dtype {y4.dtype}")
        if m.dtype == np.float64:
            b = np.ones(m.nr_rows)
            res = jax.block_until_ready(
                jax.jit(lambda s, r: cg(s.spmv, r, tol=1e-8,
                                        maxiter=5000))(sh, b))
            resid = (np.linalg.norm(b - m.to_scipy() @ np.asarray(res.x))
                     / np.linalg.norm(b))
            _line("four", matrix=name, cg_iters=int(res.iterations),
                  cg_host_rel_residual=resid, dtype=res.x.dtype)
            _require(resid < 1e-8 * 1.01, f"host residual {resid}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--routes", action="store_true",
                      help="time every SpMV route on the benchmark matrices")
    mode.add_argument("--four", action="store_true",
                      help="run only the row-sharded path on four GPUs")
    args = ap.parse_args(argv)

    from sparsetpu.utils.runtime import device_info, init_runtime
    init_runtime()
    dev = phase_device()
    if args.routes:
        phase_routes(dev)
    elif args.four:
        phase_four()
    else:
        m, A = phase_headline(dev)
        phase_fem_f64()
        phase_spmm(m, A)
        phase_spgemm()
    info = device_info()
    if args.four:
        _require(info["count"] == 4, f"device info {info}")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
