"""Fully device-side interior-point solve.

Same algorithm as :func:`parapint_tpu.algorithms.ip_solve` (reference
semantics, /root/reference/parapint/algorithms/interior_point.py:405-631)
but with the ENTIRE solve — outer iteration loop, barrier update,
inertia-correction retry loop, convergence tests — expressed as
``lax.while_loop``s so the whole solve is one XLA computation: one dispatch,
one result readback.  This is the production path: no host<->device
round trip per iteration; the Python-loop ``ip_solve`` remains the debuggable/loggable variant with identical
numerics.

Differences from the Python loop (both documented, both benign):
- No per-iteration log table (use ``ip_solve`` when you want the trace).
- Failure to correct inertia or factorize sets status=error and stops the
  loop instead of raising.
"""

import dataclasses
import enum
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from parapint_tpu.algorithms.interior_point import (
    InteriorPointStatus,
    check_precision_compat,
)
from parapint_tpu.linalg.results import LinearSolverStatus
from parapint_tpu.options import IPOptions


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FusedResult:
    state: object  # final IPState
    status: jax.Array  # int32: 0 optimal, 1 error/max_iter
    iterations: jax.Array  # int32
    barrier: jax.Array
    primal_inf: jax.Array
    dual_inf: jax.Array
    compl_inf: jax.Array


def make_fused_ip_solve(interface, options: Optional[IPOptions] = None):
    """Build a jitted function ``solve(state0) -> FusedResult``.

    ``options.linalg.solver`` must be set; options are baked in as static
    configuration (rebuild for different options).
    """
    if options is None:
        options = IPOptions()
    options.validate()
    solver = options.linalg.solver
    if solver is None:
        raise ValueError("options.linalg.solver must be set")
    check_precision_compat(interface, solver)
    do_ls = not options.line_search.disable
    if do_ls and not hasattr(interface, "merit_components"):
        raise NotImplementedError(
            "line search requires an interface with merit_components"
        )

    tol = options.tol
    mu_min = options.minimum_barrier_parameter
    mu_decrease_gate = options.barrier_decrease
    ic = options.inertia_correction
    expected_neg = interface.expected_neg_eig
    error_scaling = options.error_scaling
    use_ic = options.use_inertia_correction

    SUCCESS = jnp.int32(LinearSolverStatus.successful)

    def factor_with_inertia_correction(data, inertia_coef):
        """Returns (fact, ok, used_coef).  Reference :337-402."""
        kkt = interface.assemble_kkt(data, 0.0, 0.0)
        fact = solver.numeric(kkt)

        def is_ok(fact):
            pos, neg, zero = solver.inertia(fact)
            status_ok = solver.status(fact) == SUCCESS
            if not use_ic:
                return status_ok
            return jnp.logical_and(
                status_ok,
                jnp.logical_and(neg == expected_neg, zero == 0),
            )

        if not use_ic:
            return fact, is_ok(fact), jnp.asarray(0.0)

        def cond(carry):
            fact, ok, w_cum, coef, used = carry
            return jnp.logical_and(jnp.logical_not(ok), used <= ic.max_coef)

        def body(carry):
            fact, ok, w_cum, coef, used = carry
            # hessian reg accumulates, constraint reg is set
            # (reference :385-386 + interface.py:590-619)
            w_cum = w_cum + coef
            kkt = interface.assemble_kkt(data, w_cum, coef)
            fact = solver.numeric(kkt)
            return fact, is_ok(fact), w_cum, coef * ic.factor_increase, coef

        fact, ok, _, _, used = lax.while_loop(
            cond,
            body,
            (fact, is_ok(fact), jnp.asarray(0.0), jnp.asarray(inertia_coef), jnp.asarray(0.0)),
        )
        return fact, ok, used

    # interfaces exposing eval_ad share one AD sweep between the convergence
    # check and the KKT assembly (saves a full gradient+Jacobian evaluation
    # per iteration)
    shared_ad = hasattr(interface, "eval_ad")

    # -- filter line search (device-side) ----------------------------------
    # IPOPT-style filter acceptance (Waechter & Biegler) run entirely on
    # device: the filter is a fixed-capacity pair of arrays in the solve
    # carry; each trial costs one values-only merit evaluation
    # (interface.merit_components), no AD.  The reference's line search is
    # an unimplemented stub (interior_point.py:320-334); this honors its
    # LineSearchOptions: up to ``max_iter`` halvings, ``step_anyway`` takes
    # the full step when no trial is acceptable, else the iteration fails.
    FCAP = min(options.max_iter, 256)
    GAMMA = 1e-5  # filter margins gamma_theta = gamma_phi
    FAR = 1e300  # empty-slot sentinel: accepts everything

    def empty_filter():
        if not do_ls:
            return ()
        return (
            jnp.full(FCAP, FAR),
            jnp.full(FCAP, FAR),
            jnp.int32(0),
        )

    def filter_line_search(state, deltas, a_p, a_d, mu, filt):
        """Returns (alpha, ls_ok, new_filter)."""
        ls = options.line_search
        theta_f, phi_f, fcount = filt
        theta0, phi0 = interface.merit_components(state, mu)

        def acceptable(th, ph):
            ok_entries = jnp.all(
                jnp.logical_or(
                    th <= (1.0 - GAMMA) * theta_f,
                    ph <= phi_f - GAMMA * theta_f,
                )
            )
            ok_current = jnp.logical_or(
                th <= (1.0 - GAMMA) * theta0, ph <= phi0 - GAMMA * theta0
            )
            finite = jnp.logical_and(jnp.isfinite(th), jnp.isfinite(ph))
            return jnp.logical_and(jnp.logical_and(ok_entries, ok_current), finite)

        def cond(c):
            k, alpha, found = c
            return jnp.logical_and(
                jnp.logical_not(found), k < max(1, ls.max_iter)
            )

        def body(c):
            k, alpha, found = c
            trial = interface.apply_step(state, deltas, a_p, a_d, alpha)
            th, ph = interface.merit_components(trial, mu)
            ok = acceptable(th, ph)
            return k + 1, jnp.where(ok, alpha, 0.5 * alpha), jnp.logical_or(found, ok)

        _, alpha, found = lax.while_loop(
            cond, body, (jnp.int32(0), jnp.asarray(1.0), jnp.asarray(False))
        )
        if ls.step_anyway:
            alpha = jnp.where(found, alpha, 1.0)
            ls_ok = jnp.asarray(True)
        else:
            ls_ok = found
        # augment the filter with the (margin-shrunk) incumbent
        idx = jnp.minimum(fcount, FCAP - 1)
        theta_f = theta_f.at[idx].set((1.0 - GAMMA) * theta0)
        phi_f = phi_f.at[idx].set(phi0 - GAMMA * theta0)
        return alpha, ls_ok, (theta_f, phi_f, jnp.minimum(fcount + 1, FCAP))

    def one_iteration(carry):
        state, mu, inertia_coef, it, done, status, diags, filt = carry
        if shared_ad:
            ad = interface.eval_ad(state)
            info = interface.convergence_from_ad(state, ad, mu, error_scaling)
        else:
            ad = None
            info = interface.convergence_info(state, mu, error_scaling)
        err0 = jnp.maximum(
            info.primal_inf, jnp.maximum(info.dual_inf, info.compl_inf_0)
        )
        converged = err0 <= tol
        diags = (info.primal_inf, info.dual_inf, info.compl_inf_0)

        err_mu = jnp.maximum(
            info.primal_inf, jnp.maximum(info.dual_inf, info.compl_inf_mu)
        )
        mu_monotone = jnp.where(
            err_mu <= mu_decrease_gate * mu,
            jnp.maximum(mu_min, jnp.minimum(0.5 * mu, mu**1.5)),
            mu,
        )
        if options.barrier_strategy == "adaptive":
            # LOQO/Vanderbei-Shanno centrality rule (see IPOptions docstring);
            # falls back to the monotone rule when the problem has no finite
            # bounds (compl_count == 0) or the products degenerate.
            avg = info.compl_avg
            xi = info.compl_min / jnp.maximum(avg, 1e-300)
            sigma = 0.1 * jnp.minimum(
                0.05 * (1.0 - xi) / jnp.maximum(xi, 1e-12), 2.0
            ) ** 3
            mu_adaptive = jnp.clip(
                sigma * avg, mu_min, options.init_barrier_parameter
            )
            mu_next = jnp.where(
                jnp.logical_and(info.compl_count > 0, avg > 0.0),
                mu_adaptive,
                mu_monotone,
            )
        else:
            mu_next = mu_monotone

        def do_step(args):
            state, mu, filt = args
            if shared_ad:
                data = interface.kkt_from_ad(state, ad, mu)
            else:
                data = interface.eval_kkt_data(state, mu)
            fact, ok, used = factor_with_inertia_correction(data, inertia_coef)
            sol, solve_status = solver.solve_with_status(
                fact, interface.kkt_rhs(data)
            )
            ok = jnp.logical_and(
                ok, solve_status <= jnp.int32(LinearSolverStatus.warning)
            )
            deltas = interface.extract_deltas(state, sol, mu)
            a_p, a_d = interface.fraction_to_the_boundary(state, deltas, 1.0 - mu)
            if options.unified_step:
                a = jnp.minimum(a_p, a_d)
                a_p = a
                a_d = a
            if do_ls:
                alpha, ls_ok, filt = filter_line_search(
                    state, deltas, a_p, a_d, mu, filt
                )
                ok = jnp.logical_and(ok, ls_ok)
                stepped = interface.apply_step(state, deltas, a_p, a_d, alpha)
            else:
                stepped = interface.apply_step(state, deltas, a_p, a_d)
            # on factorization/solve failure keep the incoming iterate: the
            # error result then carries the last valid point (the Python
            # ip_solve raises before stepping; this is the fused equivalent)
            new_state = jax.tree_util.tree_map(
                lambda a, b: jnp.where(ok, a, b), stepped, state
            )
            next_coef = jnp.maximum(
                jnp.asarray(ic.init_coef), used * ic.factor_decrease
            )
            return new_state, next_coef, jnp.logical_not(ok), filt

        def no_step(args):
            state, mu, filt = args
            return state, jnp.asarray(inertia_coef) * 1.0, jnp.asarray(False), filt

        new_state, next_coef, failed, filt = lax.cond(
            converged, no_step, do_step, (state, mu_next, filt)
        )
        done = jnp.logical_or(converged, failed)
        status = jnp.where(
            converged,
            jnp.int32(InteriorPointStatus.optimal.value),
            jnp.where(failed, jnp.int32(InteriorPointStatus.error.value), status),
        )
        return new_state, mu_next, next_coef, it + 1, done, status, diags, filt

    def cond(carry):
        state, mu, inertia_coef, it, done, status, diags, filt = carry
        return jnp.logical_and(jnp.logical_not(done), it < options.max_iter)

    def solve(state0) -> FusedResult:
        zero = jnp.asarray(0.0)
        carry0 = (
            state0,
            jnp.asarray(options.init_barrier_parameter),
            jnp.asarray(ic.init_coef),
            jnp.int32(0),
            jnp.asarray(False),
            jnp.int32(InteriorPointStatus.error.value),
            (zero, zero, zero),
            empty_filter(),
        )
        state, mu, _, it, done, status, diags, _ = lax.while_loop(
            cond, one_iteration, carry0
        )
        return FusedResult(
            state=state,
            status=status,
            iterations=it,
            barrier=mu,
            primal_inf=diags[0],
            dual_inf=diags[1],
            compl_inf=diags[2],
        )

    return jax.jit(solve)


def ip_solve_fused(interface, options: Optional[IPOptions] = None):
    """One-call fused solve.  Sets the bounds relaxation factor (host-side),
    builds the fused function, runs it, stores the final state on the
    interface, and returns (InteriorPointStatus, FusedResult)."""
    if options is None:
        options = IPOptions()
    interface.set_bounds_relaxation_factor(options.bounds_relaxation_factor)
    solve = make_fused_ip_solve(interface, options)
    state0 = interface.init_state()
    result = solve(state0)
    interface._current_state = result.state
    status = InteriorPointStatus(int(result.status))
    return status, result
