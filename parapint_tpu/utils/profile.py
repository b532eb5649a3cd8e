"""jax.profiler integration.

The reference threads a HierarchicalTimer through every layer (SURVEY.md
section 5.1); the device-side equivalent is an XLA trace.  These helpers
wrap any solve/step callable in a profiler trace whose output loads in
TensorBoard / Perfetto, and time warm calls on the device.
"""

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager: capture a device trace into ``log_dir``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def profile_call(log_dir: str, fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a trace and block on the result."""
    with trace(log_dir):
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
    return out


def timed(f, *a, reps: int = 5):
    """(output, median seconds) of ``reps`` warm calls of ``f(*a)``.

    The first call compiles and is not timed; each timed call ends in
    ``jax.block_until_ready`` so the time covers the device work.
    """
    import statistics
    import time

    out = jax.block_until_ready(f(*a))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(*a))
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def solver_phase_breakdown(solver, kkt, rhs, reps: int = 3):
    """Host-side per-phase wall times of one factor+solve cycle.

    The reference's MPI SC solver reports internal timers for
    ``form SC`` / ``factorize SC`` / ``communicate`` / ``back solve``
    (mpi_explicit_schur_complement.py:207-360).  Under whole-solve fusion
    those phases are not separable at runtime, so this diagnostic runs the
    *unfused* phases — each jitted alone, timed by :func:`timed` — on the
    given KKT system.  It localizes perf regressions without a full
    profiler trace; for in-fusion attribution the solver also emits
    ``jax.named_scope`` labels with the same names, visible in
    ``jax.profiler`` traces (see :func:`trace`).

    Returns a dict: phase name -> median-of-``reps`` seconds.
    """
    times = {}
    fact, times["numeric (factor blocks + form SC + factor SC)"] = timed(
        jax.jit(solver.numeric), kkt, reps=reps
    )
    _, times["solve (block solves + SC back solve)"] = timed(
        jax.jit(solver.solve), fact, rhs, reps=reps
    )
    return times
