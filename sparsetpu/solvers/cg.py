"""Iterative solvers built on the SpMV kernel (flagship workloads).

The reference is a single-shot y = A x benchmark (main.cpp); real
deployments run SpMV inside iterative solvers, so the framework ships a
conjugate-gradient family whose inner loop is the packed SpMV.  Everything
is jittable and mesh-shardable: the "training step" of this framework is
one CG iteration (SpMV + axpys + dot products -> psum over the mesh).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

# Dot products at full precision: a float32 product may otherwise run in
# TF32 on the GPU.
_vdot = functools.partial(jnp.vdot, precision=jax.lax.Precision.HIGHEST)


def _setup(spmv, b, x0):
    """(b, x0, spmv) in the working dtype: the wider of b's and the
    matvec's (float64 natively when either is float64)."""
    b = jnp.asarray(b)
    dt = jnp.promote_types(b.dtype, jax.eval_shape(spmv, b).dtype)
    b = b.astype(dt)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, dt)
    return b, x, lambda v: spmv(v).astype(dt)


class CGResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array
    residual_norm: jax.Array


def cg(spmv: Callable[[jax.Array], jax.Array], b: jax.Array,
       x0: Optional[jax.Array] = None, tol: float = 1e-6,
       maxiter: int = 1000) -> CGResult:
    """Conjugate gradients for SPD A, with A given as a closure over the
    packed SpMV.  Fixed-shape lax.while_loop — compiles once, runs on
    device end-to-end."""
    b, x, spmv = _setup(spmv, b, x0)
    r = b - spmv(x)
    p = r
    rs = _vdot(r, r)
    tol2 = jnp.asarray(tol, b.dtype) ** 2 * jnp.maximum(_vdot(b, b), 1e-30)

    def cond(state):
        _, _, _, rs, k = state
        return jnp.logical_and(rs > tol2, k < maxiter)

    def body(state):
        x, r, p, rs, k = state
        ap = spmv(p)
        alpha = rs / _vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _vdot(r, r)
        p = r + (rs_new / rs) * p
        return (x, r, p, rs_new, k + 1)

    x, r, p, rs, k = jax.lax.while_loop(cond, body, (x, r, p, rs, 0))
    return CGResult(x, k, jnp.sqrt(rs))


def cg_step(spmv: Callable[[jax.Array], jax.Array]):
    """One CG iteration as a standalone jittable step function (the
    step the multi-device dry run jits)."""

    def step(x, r, p, rs):
        ap = spmv(p)
        alpha = rs / _vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _vdot(r, r)
        p = r + (rs_new / rs) * p
        return x, r, p, rs_new

    return step


def bicgstab(spmv: Callable[[jax.Array], jax.Array], b: jax.Array,
             x0: Optional[jax.Array] = None, tol: float = 1e-6,
             maxiter: int = 1000) -> CGResult:
    """BiCGSTAB for general (non-symmetric) A."""
    b, x, spmv = _setup(spmv, b, x0)
    r = b - spmv(x)
    rhat = r
    rho = alpha = omega = jnp.asarray(1.0, b.dtype)
    v = p = jnp.zeros_like(b)
    tol2 = jnp.asarray(tol, b.dtype) ** 2 * jnp.maximum(_vdot(b, b), 1e-30)

    def cond(st):
        return jnp.logical_and(_vdot(st[1], st[1]) > tol2,
                               st[-1] < maxiter)

    def body(st):
        x, r, rhat, rho, alpha, omega, v, p, k = st
        rho_new = _vdot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = spmv(p)
        alpha = rho_new / _vdot(rhat, v)
        s = r - alpha * v
        t = spmv(s)
        omega = _vdot(t, s) / jnp.maximum(_vdot(t, t), 1e-30)
        x = x + alpha * p + omega * s
        r = s - omega * t
        return (x, r, rhat, rho_new, alpha, omega, v, p, k + 1)

    st = jax.lax.while_loop(cond, body,
                            (x, r, rhat, rho, alpha, omega, v, p, 0))
    return CGResult(st[0], st[-1], jnp.linalg.norm(st[1]))


def gmres(spmv: Callable[[jax.Array], jax.Array], b: jax.Array,
          x0: Optional[jax.Array] = None, restart: int = 30,
          tol: float = 1e-6, maxiter: int = 1000) -> CGResult:
    """Restarted GMRES(m) for general A — the classic non-symmetric
    workhorse next to ``bicgstab``.  Fixed-shape Arnoldi cycle inside
    ``lax.while_loop`` (one compile, fully on device); the small
    (m+1, m) least-squares solve uses jnp.linalg.lstsq."""
    b, x, spmv = _setup(spmv, b, x0)
    n = b.shape[0]
    m = int(restart)
    bnorm = jnp.maximum(jnp.linalg.norm(b), 1e-30)

    def cycle(x):
        r = b - spmv(x)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), b.dtype)
        V = V.at[0].set(r / jnp.maximum(beta, 1e-30))
        H = jnp.zeros((m + 1, m), b.dtype)

        def arnoldi(j, carry):
            V, H = carry
            w = spmv(V[j])
            # modified Gram-Schmidt against all m+1 basis vectors
            # (rows > j are zero, so the extra dots are no-ops)
            def mgs(i, wh):
                w, H = wh
                keep = i <= j
                h = jnp.where(keep, _vdot(V[i], w), 0.0)
                return (w - h * V[i], H.at[i, j].set(h))

            w, H = jax.lax.fori_loop(0, m + 1, mgs, (w, H))
            hnext = jnp.linalg.norm(w)
            H = H.at[j + 1, j].set(hnext)
            V = V.at[j + 1].set(w / jnp.maximum(hnext, 1e-30))
            return (V, H)

        V, H = jax.lax.fori_loop(0, m, arnoldi, (V, H))
        e1 = jnp.zeros((m + 1,), b.dtype).at[0].set(beta)
        y, *_ = jnp.linalg.lstsq(H, e1)
        return x + jnp.matmul(V[:m].T, y,
                              precision=jax.lax.Precision.HIGHEST)

    def cond(st):
        x, k = st
        r = b - spmv(x)
        return jnp.logical_and(jnp.linalg.norm(r) / bnorm > tol,
                               k < maxiter)

    def body(st):
        x, k = st
        return (cycle(x), k + m)

    x, k = jax.lax.while_loop(cond, body, (x, jnp.int32(0)))
    return CGResult(x=x, iterations=k,
                    residual_norm=jnp.linalg.norm(b - spmv(x)))


def power_iteration(spmv, n, iters: int = 50, seed: int = 0):
    """Dominant eigenvalue estimate — exercises repeated SpMV."""
    v = jax.random.normal(jax.random.PRNGKey(seed), (n,))
    def body(_, v):
        w = spmv(v)
        return w / jnp.linalg.norm(w)
    v = jax.lax.fori_loop(0, iters, body, v / jnp.linalg.norm(v))
    return _vdot(v, spmv(v)), v


def pcg(spmv: Callable[[jax.Array], jax.Array], b: jax.Array,
        m_inv: Callable[[jax.Array], jax.Array],
        x0: Optional[jax.Array] = None, tol: float = 1e-6,
        maxiter: int = 1000) -> CGResult:
    """Preconditioned CG: ``m_inv`` applies the preconditioner inverse
    (e.g. ``jacobi_preconditioner(A)``).  Same fixed-shape while_loop
    structure as ``cg``."""
    b, x, spmv = _setup(spmv, b, x0)
    r = b - spmv(x)
    z = m_inv(r)
    p = z
    rz = _vdot(r, z)
    bnorm = jnp.maximum(jnp.linalg.norm(b), 1e-30)

    def cond(st):
        _, r, _, _, k = st
        return jnp.logical_and(jnp.linalg.norm(r) / bnorm > tol,
                               k < maxiter)

    def body(st):
        x, r, p, rz, k = st
        ap = spmv(p)
        alpha = rz / jnp.maximum(_vdot(p, ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = m_inv(r)
        rz_new = _vdot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return (x, r, p, rz_new, k + 1)

    x, r, _, _, k = jax.lax.while_loop(cond, body, (x, r, p, rz,
                                                    jnp.int32(0)))
    return CGResult(x=x, iterations=k, residual_norm=jnp.linalg.norm(r))


def jacobi_preconditioner(matrix) -> Callable[[jax.Array], jax.Array]:
    """Diagonal (Jacobi) preconditioner from a CSRMatrix: z = r / diag(A).

    Zero / missing diagonal entries fall back to 1 (identity on those
    rows)."""
    import numpy as np
    n = matrix.nr_rows
    diag = np.zeros(n, dtype=np.float64)
    rows = np.repeat(np.arange(n, dtype=np.int64),
                     np.diff(matrix.row_ptr).astype(np.int64))
    on_diag = rows == matrix.col_ind
    np.add.at(diag, rows[on_diag], matrix.values[on_diag])
    diag = np.where(diag == 0.0, 1.0, diag)
    inv = jnp.asarray(1.0 / diag)
    return lambda r: r * inv.astype(r.dtype)


def jacobi_iteration(spmv, matrix, b, iters: int = 100, omega: float = 1.0):
    """Weighted Jacobi relaxation x_{k+1} = x_k + omega D^-1 (b - A x_k)
    (smoother / simple stationary solver on the packed SpMV)."""
    m_inv = jacobi_preconditioner(matrix)
    b, x0, spmv = _setup(spmv, b, None)

    def body(_, x):
        return x + omega * m_inv(b - spmv(x))

    return jax.lax.fori_loop(0, iters, body, x0)
