from .cg import (CGResult, bicgstab, cg, cg_step, gmres, jacobi_iteration,
                 jacobi_preconditioner, pcg, power_iteration)

__all__ = [
    "CGResult", "bicgstab", "cg", "cg_step", "gmres", "jacobi_iteration",
    "jacobi_preconditioner", "pcg", "power_iteration",
]
