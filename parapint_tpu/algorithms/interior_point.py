"""Primal-dual interior-point driver.

A semantic transcription of the reference algorithm
(/root/reference/parapint/algorithms/interior_point.py:405-631) against the
functional interface/solver protocols of this package:

- convergence check with IPOPT-style error scaling (:174-317),
- monotone barrier decrease mu <- max(mu_min, min(0.5 mu, mu^1.5)) gated on
  the mu-convergence test (:520-528),
- fraction-to-the-boundary with tau = 1 - mu (:571, 655-758),
- inertia correction: grow delta by factor_increase until the factorization
  reports (neg, zero) == (n_constraints, 0), where the constraint diagonal
  is *set* to -delta and the Hessian diagonal *accumulates* +delta, exactly
  like the reference's regularize_equality_gradient / regularize_hessian
  calls (:363-400 with interface.py:590-619),
- memory-reallocation retry protocol (:634-652) — a no-op for the built-in
  dense device solvers but preserved for solver parity.

Device/host split: all linear algebra and evaluation is jitted on device;
the Python loop only moves a handful of scalars per iteration (convergence
numbers, factorization status/inertia, step sizes) for control flow and the
iteration log.
"""

import enum
import logging
import time
from typing import Optional, Tuple

import jax.numpy as jnp

from parapint_tpu.linalg.base import LinearSolver
from parapint_tpu.linalg.results import LinearSolverStatus
from parapint_tpu.options import IPOptions
from parapint_tpu.utils.timer import HierarchicalTimer

logger = logging.getLogger(__name__)


class InteriorPointStatus(enum.Enum):
    optimal = 0
    error = 1


def check_precision_compat(interface, solver) -> None:
    """Warn when a mixed-precision interface feeds a higher-precision factor.

    ``kkt_dtype=f32`` rounds the KKT matrix at assembly; a solver asking for
    a HIGHER-precision factor sweep (the hybrid ``factor_dtype=f64`` +
    ``apply_dtype=f32`` path exists precisely for exact pivot signs on
    cancellation-heavy blocks) then computes its pivots from already-rounded
    data — the inertia fidelity it promises cannot be recovered.  The
    production combination (f32 matrix, f32 factor) is unaffected.
    """
    import warnings

    import numpy as _np

    kd = getattr(interface, "kkt_dtype", None)
    fd = getattr(solver, "factor_dtype", None)
    if kd is None or fd is None:
        return
    if _np.dtype(fd).itemsize > _np.dtype(kd).itemsize:
        warnings.warn(
            f"interface kkt_dtype={_np.dtype(kd).name} assembles the KKT in "
            f"reduced precision, but the solver factors in "
            f"{_np.dtype(fd).name}: pivot signs/inertia are computed from "
            "already-rounded data, defeating the hybrid-precision "
            "factorization's guarantee. Use kkt_dtype=None with "
            "factor_dtype=f64 (hybrid), or factor_dtype=f32.",
            stacklevel=3,
        )


def check_convergence(interface, barrier, error_scaling: float = 100.0):
    """Standalone convergence check (reference :174-317).

    Returns (primal_inf, dual_inf, complimentarity_inf) as floats, evaluated
    at the given barrier value.
    """
    info = interface.convergence_info(interface_state_or(interface), barrier, error_scaling)
    return float(info.primal_inf), float(info.dual_inf), float(info.compl_inf_mu)


def interface_state_or(interface):
    state = getattr(interface, "_current_state", None)
    if state is None:
        state = interface.init_state()
    return state


def line_search(
    interface,
    state,
    deltas,
    alpha_primal_max: float,
    alpha_dual_max: float,
    barrier: float,
    options: IPOptions,
) -> Optional[float]:
    """Backtracking line search on the barrier-KKT-residual merit.

    The reference's line search is an unimplemented placeholder
    (interior_point.py:320-334, disabled by default); this is a working
    implementation honoring the same options: up to ``max_iter`` halvings of
    the step, accepting the first trial whose merit (the max of the scaled
    primal/dual/complementarity infeasibilities at the current barrier)
    improves on the incumbent; ``step_anyway=True`` takes the full step when
    no trial improves, ``False`` reports failure (None).
    """
    ls = options.line_search

    def merit(s) -> float:
        info = interface.convergence_info(s, barrier, options.error_scaling)
        return max(
            float(info.primal_inf), float(info.dual_inf), float(info.compl_inf_mu)
        )

    merit0 = merit(state)
    alpha = 1.0
    for _ in range(max(1, ls.max_iter)):
        trial = interface.apply_step(
            state, deltas, alpha_primal_max, alpha_dual_max, alpha
        )
        if merit(trial) < merit0:
            return alpha
        alpha *= 0.5
    return 1.0 if ls.step_anyway else None


def try_factorization_and_reallocation(
    kkt, linear_solver: LinearSolver, reallocation_factor, max_iter, timer=None
):
    """Reference :634-652: retry on not_enough_memory."""
    assert max_iter >= 1
    for count in range(max_iter):
        fact = linear_solver.numeric(kkt)
        status = LinearSolverStatus(int(linear_solver.status(fact)))
        if status == LinearSolverStatus.not_enough_memory:
            linear_solver.increase_memory_allocation(reallocation_factor)
        else:
            break
    return fact, status, count


def numeric_factorization(
    interface,
    data,
    options: IPOptions,
    inertia_coef: float,
    timer: Optional[HierarchicalTimer] = None,
) -> Tuple[object, float]:
    """Factorize the KKT system, applying inertia correction as needed.

    Returns (factorization, final_inertia_coef).  Reference :337-402.
    """
    solver: LinearSolver = options.linalg.solver
    logger.debug(
        f"{'reg_iter':<10}{'reg_coef':<10}{'pos_eig':<10}"
        f"{'neg_eig':<10}{'zero_eig':<10}{'status':<10}"
    )
    kkt = interface.assemble_kkt(data, 0.0, 0.0)
    fact, status, _ = try_factorization_and_reallocation(
        kkt,
        solver,
        options.linalg.reallocation_factor,
        options.linalg.max_num_reallocations,
        timer=timer,
    )

    final_inertia_coef = 0.0
    if not options.use_inertia_correction:
        if status != LinearSolverStatus.successful:
            raise RuntimeError(
                "Could not factorize KKT system; linear solver status: " + str(status)
            )
        return fact, final_inertia_coef

    if status not in {LinearSolverStatus.successful, LinearSolverStatus.singular}:
        raise RuntimeError(
            "Could not factorize KKT system; linear solver status: " + str(status)
        )

    expected_neg = interface.expected_neg_eig
    pos = neg = zero = None
    w_reg_cumulative = 0.0
    _iter = 0
    while final_inertia_coef <= options.inertia_correction.max_coef:
        if status == LinearSolverStatus.successful:
            p, n, z = solver.inertia(fact)
            pos, neg, zero = int(p), int(n), int(z)
        else:
            pos, neg, zero = None, None, None
        logger.debug(
            f"{_iter:<10}{final_inertia_coef:<10.2e}{str(pos):<10}"
            f"{str(neg):<10}{str(zero):<10}{str(status):<10}"
        )
        if (
            neg == expected_neg
            and zero == 0
            and status == LinearSolverStatus.successful
        ):
            break
        # hessian reg accumulates, constraint reg is set (reference :385-386
        # with interface.py:590-619 set-vs-add semantics)
        w_reg_cumulative += inertia_coef
        kkt = interface.assemble_kkt(data, w_reg_cumulative, inertia_coef)
        fact, status, _ = try_factorization_and_reallocation(
            kkt,
            solver,
            options.linalg.reallocation_factor,
            options.linalg.max_num_reallocations,
            timer=timer,
        )
        final_inertia_coef = inertia_coef
        inertia_coef *= options.inertia_correction.factor_increase
        _iter += 1

    if (
        neg != expected_neg
        or zero != 0
        or status != LinearSolverStatus.successful
    ):
        raise RuntimeError("Exceeded maximum inertia correction")

    return fact, final_inertia_coef


_LOG_HEADER = (
    f"{'Iter':<6}{'Objective':<11}{'Prim Inf':<11}{'Dual Inf':<11}"
    f"{'Comp Inf':<11}{'Barrier':<11}{'Prim Step':<11}{'Dual Step':<11}"
    f"{'LS Step':<11}{'Reg':<11}{'Time':<7}"
)


def ip_solve(
    interface,
    options: Optional[IPOptions] = None,
    timer: Optional[HierarchicalTimer] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_interval: int = 10,
    resume_from: Optional[str] = None,
) -> InteriorPointStatus:
    """Solve an NLP with the primal-dual interior-point method.

    Parameters
    ----------
    interface: an interface object (function evaluation + KKT assembly), e.g.
        :class:`parapint_tpu.interfaces.InteriorPointInterface` or the
        dynamic/stochastic Schur-complement interfaces.
    options: IPOptions (``options.linalg.solver`` must be set).
    timer: optional HierarchicalTimer.
    checkpoint_path / checkpoint_interval: write the full solver state every
        k iterations (beyond-reference; see utils/checkpoint.py).
    resume_from: path of a checkpoint to resume from.

    The final iterate is available as ``interface.get_state()`` /
    ``interface.get_primals()`` after the solve.
    """
    if options is None:
        options = IPOptions()
    options.validate()
    if options.linalg.solver is None:
        raise ValueError("options.linalg.solver must be set")
    solver: LinearSolver = options.linalg.solver
    check_precision_compat(interface, solver)
    if timer is None:
        timer = HierarchicalTimer()

    timer.start("IP solve")
    timer.start("init")
    interface.set_bounds_relaxation_factor(options.bounds_relaxation_factor)

    barrier_parameter = options.init_barrier_parameter
    inertia_coef = options.inertia_correction.init_coef
    used_inertia_coef = 0.0

    t0 = time.time()
    state = interface.init_state()
    start_iter = 0
    if resume_from is not None:
        from parapint_tpu.utils.checkpoint import load_checkpoint

        state, barrier_parameter, inertia_coef, start_iter = load_checkpoint(
            resume_from, like=state
        )
        logger.info(f"resumed from {resume_from} at iteration {start_iter}")
    interface._current_state = state

    alpha_primal_max = 1.0
    alpha_dual_max = 1.0
    alpha = 1.0

    logger.info(_LOG_HEADER)
    timer.stop("init")
    status = InteriorPointStatus.error

    for _iter in range(start_iter, options.max_iter):
        interface._current_state = state
        if (
            checkpoint_path is not None
            and checkpoint_interval > 0
            and _iter > start_iter
            and (_iter - start_iter) % checkpoint_interval == 0
        ):
            from parapint_tpu.utils.checkpoint import save_checkpoint

            save_checkpoint(
                checkpoint_path, state, barrier_parameter, inertia_coef, _iter
            )

        timer.start("convergence check")
        info = interface.convergence_info(
            state, barrier_parameter, options.error_scaling
        )
        objective = float(info.objective)
        primal_inf = float(info.primal_inf)
        dual_inf = float(info.dual_inf)
        compl_inf_0 = float(info.compl_inf_0)
        compl_inf_mu = float(info.compl_inf_mu)
        timer.stop("convergence check")

        logger.info(
            f"{_iter:<6}{objective:<11.2e}{primal_inf:<11.2e}{dual_inf:<11.2e}"
            f"{compl_inf_0:<11.2e}{barrier_parameter:<11.2e}"
            f"{alpha_primal_max:<11.2e}{alpha_dual_max:<11.2e}{alpha:<11.2e}"
            f"{used_inertia_coef:<11.2e}{time.time() - t0:<7.3f}"
        )

        if max(primal_inf, dual_inf, compl_inf_0) <= options.tol:
            status = InteriorPointStatus.optimal
            break
        if options.barrier_strategy == "adaptive" and int(info.compl_count) > 0:
            # LOQO/Vanderbei-Shanno centrality rule (see IPOptions docstring)
            avg = float(info.compl_avg)
            if avg > 0.0:
                xi = float(info.compl_min) / avg
                sigma = 0.1 * min(0.05 * (1.0 - xi) / max(xi, 1e-12), 2.0) ** 3
                barrier_parameter = min(
                    options.init_barrier_parameter,
                    max(options.minimum_barrier_parameter, sigma * avg),
                )
        elif (
            max(primal_inf, dual_inf, compl_inf_mu)
            <= options.barrier_decrease * barrier_parameter
        ):
            barrier_parameter = max(
                options.minimum_barrier_parameter,
                min(0.5 * barrier_parameter, barrier_parameter**1.5),
            )

        timer.start("eval")
        data = interface.eval_kkt_data(state, barrier_parameter)
        timer.stop("eval")

        timer.start("factorize")
        if _iter == 0:
            timer.start("symbolic")
            sym_res = solver.symbolic(interface.assemble_kkt(data, 0.0, 0.0))
            timer.stop("symbolic")
            if sym_res.status != LinearSolverStatus.successful:
                raise RuntimeError(
                    "Could not factorize KKT system; linear solver status: "
                    + str(sym_res.status)
                )
        timer.start("numeric")
        fact, used_inertia_coef = numeric_factorization(
            interface=interface,
            data=data,
            options=options,
            inertia_coef=inertia_coef,
            timer=timer,
        )
        inertia_coef = used_inertia_coef * options.inertia_correction.factor_decrease
        if inertia_coef < options.inertia_correction.init_coef:
            inertia_coef = options.inertia_correction.init_coef
        timer.stop("numeric")
        timer.stop("factorize")

        timer.start("back solve")
        delta_sol, solve_status = solver.solve_with_status(
            fact, interface.kkt_rhs(data)
        )
        solve_status = LinearSolverStatus(int(solve_status))
        timer.stop("back solve")
        if solve_status not in {
            LinearSolverStatus.successful,
            LinearSolverStatus.warning,
        }:
            # iterative coupling solvers (PCG-SC) can fail per-solve even
            # after a successful factorization; never step on such a solution
            raise RuntimeError(
                "Linear solver back solve failed; status: " + solve_status.name
            )

        deltas = interface.extract_deltas(state, delta_sol, barrier_parameter)

        timer.start("frac boundary")
        a_p, a_d = interface.fraction_to_the_boundary(
            state, deltas, 1.0 - barrier_parameter
        )
        alpha_primal_max = float(a_p)
        alpha_dual_max = float(a_d)
        if options.unified_step:
            tmp = min(alpha_primal_max, alpha_dual_max)
            alpha_primal_max = tmp
            alpha_dual_max = tmp
        timer.stop("frac boundary")

        if options.line_search.disable:
            alpha = 1.0
        else:
            timer.start("line search")
            alpha = line_search(
                interface,
                state,
                deltas,
                alpha_primal_max,
                alpha_dual_max,
                barrier_parameter,
                options,
            )
            timer.stop("line search")
            if alpha is None:
                logger.warning("line search failed")
                status = InteriorPointStatus.error
                break

        state = interface.apply_step(
            state, deltas, alpha_primal_max, alpha_dual_max, alpha
        )

    interface._current_state = state
    timer.stop("IP solve")
    if options.report_timing:
        print(timer)
    return status
