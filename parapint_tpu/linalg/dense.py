"""Dense direct solvers: the MA27/MUMPS and Scipy roles of the reference.

- :class:`DenseLDLSolver`: unpivoted blocked LDL^T with inertia read off D.
  This is the workhorse (the role of HSL MA27 / MUMPS,
  /root/reference/parapint/linalg/ma27_interface.py, mumps_interface.py) and
  runs in f64 on the device.
- :class:`DenseLUSolver`: LU factorization with optional inertia via a dense
  symmetric eigendecomposition — the "always available" test backend, the
  role of the reference's ``ScipyInterface``
  (/root/reference/parapint/linalg/scipy_interface.py:11-67), primarily
  for CPU tests.
"""

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from parapint_tpu.linalg.base import LinearSolver
from parapint_tpu.linalg.results import LinearSolverResults, LinearSolverStatus
from parapint_tpu.ops.ldl import (
    ldl_factor,
    ldl_inertia,
    ldl_solve,
    ldl_winv,
    ruiz_scale,
    winv_apply,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseLDLFactor:
    LD: object  # packed factor (npad, npad); None in explicit-inverse mode
    W: object  # L^{-1} (npad, npad) in explicit-inverse mode, else None
    d: object  # pivots (npad,) in explicit-inverse mode, else None
    s: object  # Ruiz equilibration scaling (n,), W-mode, else None
    kkt: object  # original K, kept for iterative refinement (else None)
    inertia: jax.Array  # (3,) int32: pos, neg, zero
    status: jax.Array  # () int32 LinearSolverStatus
    n: int = dataclasses.field(metadata=dict(static=True))  # logical dim


class DenseLDLSolver(LinearSolver):
    """Unpivoted blocked LDL^T (see :mod:`parapint_tpu.ops.ldl`).

    Parameters
    ----------
    block_size: panel width for the blocked factorization (use smaller
        for tiny systems).
    zero_tol: pivot threshold below which a pivot counts as zero (default
        0.0 = exact zeros only; see ops.ldl.ldl_inertia)
        (drives both the inertia's ``num_zero`` and the ``singular`` status).
    explicit_inverse: store W = L^{-1} (built with matmuls only,
        ops.ldl.ldl_winv) instead of the packed factor, turning back solves
        into two thin matmuls instead of XLA's triangular_solve.
    refine_steps: iterative-refinement passes per solve in explicit-inverse
        mode (residuals against the original K recover direct-solve
        accuracy; default 1, use >=2 with factor_dtype=float32).
    factor_dtype: cast the matrix to this dtype for factorization (e.g.
        jnp.float32 for mixed precision: fast f32 factorization, f64
        accuracy restored by the refinement passes).  None = input dtype.
    """

    def __init__(
        self,
        block_size: int = 128,
        zero_tol: float = 0.0,
        explicit_inverse: bool = False,
        refine_steps: int = 1,
        factor_dtype=None,
    ):
        self.block_size = block_size
        self.zero_tol = zero_tol
        self.explicit_inverse = explicit_inverse
        self.refine_steps = refine_steps
        self.factor_dtype = factor_dtype
        self._n: Optional[int] = None

    def symbolic(self, kkt: jax.Array) -> LinearSolverResults:
        n, m = kkt.shape[-2], kkt.shape[-1]
        if n != m:
            raise ValueError(f"matrix is not square: {kkt.shape}")
        self._n = n
        return LinearSolverResults(status=LinearSolverStatus.successful)

    def numeric(self, kkt: jax.Array) -> DenseLDLFactor:
        n = kkt.shape[-1]
        if self.explicit_inverse:
            # Ruiz-equilibrate so a lower-precision factorization keeps its
            # pivot signs (inertia) despite the barrier dynamic range
            s = ruiz_scale(kkt)
            kf = kkt * s[:, None] * s[None, :]
        else:
            s = None
            kf = kkt
        if self.factor_dtype is not None:
            kf = kf.astype(self.factor_dtype)
            s = s.astype(self.factor_dtype) if s is not None else None
        bs = min(self.block_size, max(8, n))
        LD, d = ldl_factor(kf, block_size=bs)
        pos, neg, zero = ldl_inertia(d, n=n, zero_tol=self.zero_tol)
        # successful iff every logical pivot is cleanly nonzero and finite;
        # NaN pivots fall in no bucket so pos+neg < n also maps to singular.
        ok = (pos + neg) == n
        status = jnp.where(
            ok,
            jnp.int32(LinearSolverStatus.successful),
            jnp.int32(LinearSolverStatus.singular),
        )
        inertia = jnp.stack([pos, neg, zero])
        if self.explicit_inverse:
            W, dd = ldl_winv(LD)
            return DenseLDLFactor(
                LD=None,
                W=W,
                d=dd,
                s=s,
                kkt=kkt if self.refine_steps > 0 else None,
                inertia=inertia,
                status=status,
                n=n,
            )
        return DenseLDLFactor(
            LD=LD, W=None, d=None, s=None, kkt=None, inertia=inertia,
            status=status, n=n,
        )

    def solve(self, fact: DenseLDLFactor, rhs: jax.Array) -> jax.Array:
        if fact.W is None:
            return ldl_solve(fact.LD, rhs)
        fd = fact.W.dtype

        def apply(b):
            bs_ = b.astype(fd)
            sc = fact.s if b.ndim == 1 else fact.s[:, None]
            return (winv_apply(fact.W, fact.d, bs_ * sc) * sc).astype(rhs.dtype)

        x = apply(rhs)
        for _ in range(self.refine_steps):
            r = rhs - jnp.matmul(fact.kkt, x, preferred_element_type=rhs.dtype)
            x = x + apply(r)
        return x

    def inertia(self, fact: DenseLDLFactor):
        return fact.inertia[0], fact.inertia[1], fact.inertia[2]

    def status(self, fact: DenseLDLFactor) -> jax.Array:
        return fact.status


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseLUFactor:
    lu: jax.Array
    piv: jax.Array
    inertia: jax.Array  # (3,) int32 (all zeros when compute_inertia=False)
    status: jax.Array  # () int32


@functools.partial(jax.jit, static_argnames=("compute_inertia", "zero_tol"))
def _lu_numeric(kkt: jax.Array, compute_inertia: bool, zero_tol: float):
    lu, piv = jax.scipy.linalg.lu_factor(kkt)
    u_diag = jnp.diagonal(lu)
    umax = jnp.max(jnp.abs(u_diag))
    singular = jnp.any(jnp.abs(u_diag) <= zero_tol * jnp.maximum(umax, 1.0))
    bad = jnp.logical_or(singular, jnp.any(jnp.isnan(u_diag)))
    status = jnp.where(
        bad,
        jnp.int32(LinearSolverStatus.singular),
        jnp.int32(LinearSolverStatus.successful),
    )
    if compute_inertia:
        # dense symmetric eigenvalues, +-1e-8 thresholds, mirroring the
        # reference ScipyInterface (scipy_interface.py:40-45)
        w = jnp.linalg.eigvalsh(kkt)
        pos = jnp.sum(w > 1e-8, dtype=jnp.int32)
        neg = jnp.sum(w < -1e-8, dtype=jnp.int32)
        zero = jnp.int32(w.shape[0]) - pos - neg
        inertia = jnp.stack([pos, neg, zero])
    else:
        inertia = jnp.zeros(3, dtype=jnp.int32)
    return lu, piv, inertia, status


class DenseLUSolver(LinearSolver):
    """LU with optional eigendecomposition inertia (ScipyInterface analogue).

    ``compute_inertia=True`` costs an O(n^3) symmetric eigensolve per
    factorization, exactly like the reference's dense ``eigvals`` path; use
    only for testing (that is also the reference's guidance).
    """

    def __init__(self, compute_inertia: bool = False, zero_tol: float = 1e-14):
        self.compute_inertia = compute_inertia
        self.zero_tol = zero_tol

    def symbolic(self, kkt: jax.Array) -> LinearSolverResults:
        if kkt.shape[-2] != kkt.shape[-1]:
            raise ValueError(f"matrix is not square: {kkt.shape}")
        return LinearSolverResults(status=LinearSolverStatus.successful)

    def numeric(self, kkt: jax.Array) -> DenseLUFactor:
        lu, piv, inertia, status = _lu_numeric(
            kkt, compute_inertia=self.compute_inertia, zero_tol=self.zero_tol
        )
        return DenseLUFactor(lu=lu, piv=piv, inertia=inertia, status=status)

    def solve(self, fact: DenseLUFactor, rhs: jax.Array) -> jax.Array:
        return jax.scipy.linalg.lu_solve((fact.lu, fact.piv), rhs)

    def inertia(self, fact: DenseLUFactor):
        if not self.compute_inertia:
            raise RuntimeError(
                "DenseLUSolver was constructed with compute_inertia=False"
            )
        return fact.inertia[0], fact.inertia[1], fact.inertia[2]

    def status(self, fact: DenseLUFactor) -> jax.Array:
        return fact.status
