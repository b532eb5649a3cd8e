"""Single-NLP interior-point interface (dense KKT).

The JAX counterpart of the reference ``InteriorPointInterface``
(/root/reference/parapint/interfaces/interface.py:250-679): wraps one NLP,
builds the 4x4 symmetric primal-dual KKT system and its rhs with barrier
terms, and recovers the bound-dual deltas in closed form after the solve.

Functional design: the iterate is an :class:`IPState` pytree; every method
is a pure jitted function of (state, bounds, ...) so an entire IP iteration
fuses into one XLA computation.  The KKT matrix is dense — per-problem
sparsity is XLA's concern, not an input format.

KKT layout (variable order [x, s, y_eq, y_ineq], reference interface.py:474-491)::

    [ W + Sigma_x + dw*I   0              Jeq^T    Jineq^T ]
    [ 0                    Sigma_s        0        -I      ]
    [ Jeq                  0              -dc*I    0       ]
    [ Jineq                -I             0        -dc*I   ]

rhs = -[grad_lag_x (with barrier); grad_lag_s (with barrier); c_eq; c_ineq - s]
(reference interface.py:493-528).
"""

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from parapint_tpu.interfaces import base
from parapint_tpu.interfaces.base import Bounds, ConvergenceInfo, IPState
from parapint_tpu.models.ad import NLPFunctions
from parapint_tpu.models.model import NLPModel


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KKTData:
    """Per-iteration evaluation results; regularization is applied later so
    the inertia-correction retry loop (interior_point.py:363-400) reuses
    these without re-running AD."""

    hess: jax.Array  # (n, n) Hessian of the Lagrangian
    jac_eq: jax.Array  # (m_eq, n)
    jac_ineq: jax.Array  # (m_ineq, n)
    sigma_x: jax.Array  # (n,)
    sigma_s: jax.Array  # (m_ineq,)
    rhs: jax.Array  # (nk,)


class InteriorPointInterface(base.BaseInteriorPointInterface):
    """Interface for a single :class:`NLPModel`."""

    def __init__(self, model: NLPModel, obj_factor: float = 1.0):
        self.model = model
        self.fns = NLPFunctions.from_model(model)
        self.obj_factor = obj_factor
        self.n_x = model.n_x
        self.n_eq = model.n_eq
        self.n_ineq = model.n_ineq
        self.nk = self.n_x + 2 * self.n_ineq + self.n_eq
        self._bounds_relaxation_factor = 0.0
        self._current_state = None  # updated by ip_solve
        self._set_bounds()

        self._convergence_info = jax.jit(self._convergence_info_impl)
        self._eval_kkt_data = jax.jit(self._eval_kkt_data_impl)
        self._assemble_kkt = jax.jit(self._assemble_kkt_impl)
        self._extract_deltas = jax.jit(self._extract_deltas_impl)
        self._fraction_to_the_boundary = jax.jit(self._ftb_impl)
        self._apply_step = jax.jit(self._apply_step_impl)

    # -- dims / parity accessors ------------------------------------------

    def get_state(self) -> IPState:
        """The current iterate (after ip_solve: the solution)."""
        return self._current_state

    def get_primals(self) -> jax.Array:
        return self._current_state.primals

    def get_duals_eq(self) -> jax.Array:
        return self._current_state.duals_eq

    def get_duals_ineq(self) -> jax.Array:
        return self._current_state.duals_ineq

    def evaluate_objective(self):
        return self.fns.f(self._current_state.primals)

    def get_slacks(self) -> jax.Array:
        return self._current_state.slacks

    def get_duals_primals_lb(self) -> jax.Array:
        return self._current_state.duals_primals_lb

    def get_duals_primals_ub(self) -> jax.Array:
        return self._current_state.duals_primals_ub

    def get_duals_slacks_lb(self) -> jax.Array:
        return self._current_state.duals_slacks_lb

    def get_duals_slacks_ub(self) -> jax.Array:
        return self._current_state.duals_slacks_ub

    def n_primals(self) -> int:
        return self.n_x

    def n_eq_constraints(self) -> int:
        return self.n_eq

    def n_ineq_constraints(self) -> int:
        return self.n_ineq

    @property
    def expected_neg_eig(self) -> int:
        """Target inertia: one negative eigenvalue per constraint row
        (reference interior_point.py:379-381)."""
        return self.n_eq + self.n_ineq

    @property
    def n_duals_eq(self) -> int:
        return self.n_eq

    @property
    def n_duals_ineq(self) -> int:
        return self.n_ineq

    # -- bounds -----------------------------------------------------------

    def get_bounds_relaxation_factor(self) -> float:
        return self._bounds_relaxation_factor

    def set_bounds_relaxation_factor(self, val: float) -> None:
        self._bounds_relaxation_factor = val
        self._set_bounds()

    def _set_bounds(self) -> None:
        f = self._bounds_relaxation_factor
        m = self.model
        self.bounds = Bounds(
            xl=base.relax_bounds_lower(m.xl, f),
            xu=base.relax_bounds_upper(m.xu, f),
            gl=base.relax_bounds_lower(m.gl, f),
            gu=base.relax_bounds_upper(m.gu, f),
        )

    # -- initial state (reference ip_solve init block, :433-447) ----------

    def init_state(self) -> IPState:
        m = self.model
        b = self.bounds
        base.validate_bounds(np.asarray(b.xl), np.asarray(b.xu))
        base.validate_bounds(np.asarray(b.gl), np.asarray(b.gu))
        x = base.process_init(m.x0, b.xl, b.xu)
        s0 = self.fns.c_ineq(m.x0)  # init slacks = g(x0) (interface.py:324-326)
        s = base.process_init(s0, b.gl, b.gu)
        # bound duals: warm values (default ones) masked at infinite bounds
        # (interface.py:264-282), then pushed positive (:442-447)
        zl = jnp.where(jnp.isneginf(m.xl), 0.0, m.zl0)
        zu = jnp.where(jnp.isposinf(m.xu), 0.0, m.zu0)
        zl = base.process_init_duals_lb(zl, b.xl)
        zu = base.process_init_duals_ub(zu, b.xu)
        # slack duals split from y_ineq0 by sign (interface.py:275-279)
        vl = jnp.maximum(m.y_ineq0, 0.0)
        vu = jnp.maximum(-m.y_ineq0, 0.0)
        vl = base.process_init_duals_lb(vl, b.gl)
        vu = base.process_init_duals_ub(vu, b.gu)
        return IPState(
            primals=x,
            slacks=s,
            duals_eq=m.y_eq0,
            duals_ineq=m.y_ineq0,
            duals_primals_lb=zl,
            duals_primals_ub=zu,
            duals_slacks_lb=vl,
            duals_slacks_ub=vu,
        )

    # -- convergence (reference check_convergence, interior_point.py:174-317)

    def convergence_info(self, state: IPState, barrier, error_scaling=100.0) -> ConvergenceInfo:
        return self._convergence_info(state, self.bounds, barrier, error_scaling)

    def _convergence_info_impl(self, state, bounds, barrier, error_scaling):
        fns = self.fns
        x = state.primals
        grad_obj = self.obj_factor * fns.grad_f(x)
        jac_eq = fns.jac_eq(x)
        jac_ineq = fns.jac_ineq(x)
        eq_resid = fns.c_eq(x)
        ineq_resid = fns.c_ineq(x) - state.slacks
        grad_lag_x = (
            grad_obj
            + jac_eq.T @ state.duals_eq
            + jac_ineq.T @ state.duals_ineq
            - state.duals_primals_lb
            + state.duals_primals_ub
        )
        grad_lag_s = -state.duals_ineq - state.duals_slacks_lb + state.duals_slacks_ub
        return base.convergence_metrics(
            objective=fns.f(x),
            grad_lag_primals=grad_lag_x,
            grad_lag_slacks=grad_lag_s,
            eq_resid=eq_resid,
            ineq_resid=ineq_resid,
            primals=x,
            primals_lb=bounds.xl,
            primals_ub=bounds.xu,
            duals_primals_lb=state.duals_primals_lb,
            duals_primals_ub=state.duals_primals_ub,
            slacks=state.slacks,
            ineq_lb=bounds.gl,
            ineq_ub=bounds.gu,
            duals_slacks_lb=state.duals_slacks_lb,
            duals_slacks_ub=state.duals_slacks_ub,
            duals_eq=state.duals_eq,
            duals_ineq=state.duals_ineq,
            n_duals_eq=self.n_eq,
            n_duals_ineq=self.n_ineq,
            barrier=barrier,
            error_scaling=error_scaling,
        )

    # -- KKT evaluation (reference interface.py:432-528) ------------------

    def merit_components(self, state, barrier):
        """(theta, phi) for the filter line search: theta = 1-norm of the
        constraint residuals, phi = barrier objective (values-only)."""
        fns = self.fns
        x = state.primals
        s = state.slacks
        theta = jnp.sum(jnp.abs(fns.c_eq(x))) + jnp.sum(
            jnp.abs(fns.c_ineq(x) - s)
        )
        b = self.bounds
        phi = self.obj_factor * fns.f(x) - barrier * (
            base.log_barrier_sum(x, b.xl, b.xu)
            + base.log_barrier_sum(s, b.gl, b.gu)
        )
        return theta, phi

    def eval_kkt_data(self, state: IPState, barrier) -> KKTData:
        return self._eval_kkt_data(state, self.bounds, barrier)

    def _eval_kkt_data_impl(self, state, bounds, barrier):
        fns = self.fns
        x = state.primals
        s = state.slacks
        hess = fns.hess_lag(x, state.duals_eq, state.duals_ineq, self.obj_factor)
        jac_eq = fns.jac_eq(x)
        jac_ineq = fns.jac_ineq(x)
        sigma_x = base.barrier_hessian_diag(
            x, bounds.xl, bounds.xu, state.duals_primals_lb, state.duals_primals_ub
        )
        sigma_s = base.barrier_hessian_diag(
            s, bounds.gl, bounds.gu, state.duals_slacks_lb, state.duals_slacks_ub
        )
        grad_lag_x = (
            self.obj_factor * fns.grad_f(x)
            + jac_eq.T @ state.duals_eq
            + jac_ineq.T @ state.duals_ineq
            + base.barrier_grad_term(x, bounds.xl, bounds.xu, barrier)
        )
        grad_lag_s = -state.duals_ineq + base.barrier_grad_term(
            s, bounds.gl, bounds.gu, barrier
        )
        rhs = -jnp.concatenate(
            [grad_lag_x, grad_lag_s, fns.c_eq(x), fns.c_ineq(x) - s]
        )
        return KKTData(
            hess=hess,
            jac_eq=jac_eq,
            jac_ineq=jac_ineq,
            sigma_x=sigma_x,
            sigma_s=sigma_s,
            rhs=rhs,
        )

    def assemble_kkt(self, data: KKTData, w_reg, c_reg) -> jax.Array:
        """Dense KKT with regularization applied.

        ``w_reg`` is the (accumulated) Hessian regularization; ``c_reg`` the
        current constraint-diagonal regularization — the accumulate-vs-set
        distinction matches the reference exactly (regularize_hessian *adds*,
        regularize_equality_gradient *sets*; interface.py:590-619).
        """
        return self._assemble_kkt(data, jnp.asarray(w_reg), jnp.asarray(c_reg))

    def _assemble_kkt_impl(self, data, w_reg, c_reg):
        n, me, mi = self.n_x, self.n_eq, self.n_ineq
        dt = data.hess.dtype
        h_blk = data.hess + jnp.diag(data.sigma_x + w_reg)
        eye_mi = jnp.eye(mi, dtype=dt)
        z = jnp.zeros
        row_x = jnp.concatenate(
            [h_blk, z((n, mi), dt), data.jac_eq.T, data.jac_ineq.T], axis=1
        )
        row_s = jnp.concatenate(
            [z((mi, n), dt), jnp.diag(data.sigma_s), z((mi, me), dt), -eye_mi],
            axis=1,
        )
        row_yeq = jnp.concatenate(
            [
                data.jac_eq,
                z((me, mi), dt),
                -c_reg * jnp.eye(me, dtype=dt),
                z((me, mi), dt),
            ],
            axis=1,
        )
        row_yineq = jnp.concatenate(
            [data.jac_ineq, -eye_mi, z((mi, me), dt), -c_reg * eye_mi], axis=1
        )
        return jnp.concatenate([row_x, row_s, row_yeq, row_yineq], axis=0)

    def kkt_rhs(self, data: KKTData) -> jax.Array:
        return data.rhs

    # -- delta extraction (reference interface.py:530-570) ----------------

    def extract_deltas(self, state: IPState, sol: jax.Array, barrier) -> IPState:
        return self._extract_deltas(state, self.bounds, sol, barrier)

    def _extract_deltas_impl(self, state, bounds, sol, barrier):
        n, me, mi = self.n_x, self.n_eq, self.n_ineq
        dx = sol[:n]
        ds = sol[n : n + mi]
        dyeq = sol[n + mi : n + mi + me]
        dyineq = sol[n + mi + me : n + 2 * mi + me]
        dzl = base.delta_duals_lb(
            barrier, state.duals_primals_lb, dx, state.primals, bounds.xl
        )
        dzu = base.delta_duals_ub(
            barrier, state.duals_primals_ub, dx, state.primals, bounds.xu
        )
        dvl = base.delta_duals_lb(
            barrier, state.duals_slacks_lb, ds, state.slacks, bounds.gl
        )
        dvu = base.delta_duals_ub(
            barrier, state.duals_slacks_ub, ds, state.slacks, bounds.gu
        )
        return IPState(
            primals=dx,
            slacks=ds,
            duals_eq=dyeq,
            duals_ineq=dyineq,
            duals_primals_lb=dzl,
            duals_primals_ub=dzu,
            duals_slacks_lb=dvl,
            duals_slacks_ub=dvu,
        )

    # -- fraction to the boundary (reference interior_point.py:677-758) ---

    def fraction_to_the_boundary(self, state, deltas, tau) -> Tuple[jax.Array, jax.Array]:
        return self._fraction_to_the_boundary(state, deltas, self.bounds, tau)

    def _ftb_impl(self, state, deltas, bounds, tau):
        a_p = jnp.minimum(
            jnp.minimum(
                base.ftb_lb(tau, state.primals, deltas.primals, bounds.xl),
                base.ftb_ub(tau, state.primals, deltas.primals, bounds.xu),
            ),
            jnp.minimum(
                base.ftb_lb(tau, state.slacks, deltas.slacks, bounds.gl),
                base.ftb_ub(tau, state.slacks, deltas.slacks, bounds.gu),
            ),
        )
        a_d = jnp.minimum(
            jnp.minimum(
                base.ftb_duals(tau, state.duals_primals_lb, deltas.duals_primals_lb),
                base.ftb_duals(tau, state.duals_primals_ub, deltas.duals_primals_ub),
            ),
            jnp.minimum(
                base.ftb_duals(tau, state.duals_slacks_lb, deltas.duals_slacks_lb),
                base.ftb_duals(tau, state.duals_slacks_ub, deltas.duals_slacks_ub),
            ),
        )
        return a_p, a_d

    # -- step update (reference interior_point.py:587-626) ----------------

    def apply_step(self, state, deltas, alpha_primal, alpha_dual, alpha=1.0) -> IPState:
        return self._apply_step(state, deltas, alpha_primal, alpha_dual, alpha)

    def _apply_step_impl(self, state, deltas, a_p, a_d, alpha):
        ap = alpha * a_p
        ad = alpha * a_d
        return IPState(
            primals=state.primals + ap * deltas.primals,
            slacks=state.slacks + ap * deltas.slacks,
            duals_eq=state.duals_eq + ad * deltas.duals_eq,
            duals_ineq=state.duals_ineq + ad * deltas.duals_ineq,
            duals_primals_lb=state.duals_primals_lb + ad * deltas.duals_primals_lb,
            duals_primals_ub=state.duals_primals_ub + ad * deltas.duals_primals_ub,
            duals_slacks_lb=state.duals_slacks_lb + ad * deltas.duals_slacks_lb,
            duals_slacks_ub=state.duals_slacks_ub + ad * deltas.duals_slacks_ub,
        )
