"""Benchmark: interior-point iterations/s on a 64-block Burgers problem.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Measurement (ours)
------------------
Full device-fused ``ip_solve_fused`` of the Burgers optimal-control problem
(nfe_x=50, nfe_t=256, 64 time blocks — the BASELINE.md 64-block flagship
config) at tol 1e-8 on the GPU: BANDED per-block factorization
(block-Thomas over 128-wide tiles of the bandwidth-permuted per-block KKTs,
f32 tile factors with per-tile Ruiz equilibration, adaptive f64 iterative
refinement — the MA27-envelope path, see _block_form) and the
cyclic-reduction tile solver on the chain-topology Schur complement.  The
first solve compiles; the median of 5 warm solves, each ended by
``jax.block_until_ready``, is timed.
iterations/s = IP iterations / wall time, all evaluation/assembly/
factorization/convergence work included.

Baseline
--------
The reference (sandialabs/parapint) cannot run here (no pyomo/mpi4py), so
the baseline reconstructs its per-iteration KKT linear-algebra path with
scipy on the *same* assembled KKT blocks, idealized to perfect 64-rank MPI
scaling (zero communication cost):

  time/iter = max over blocks of (SuperLU factorization of the block +
              one back solve per nonzero border row for the SC contribution,
              the reference's loop in explicit_schur_complement.py:108-122)
              + replicated dense-SC factorization
              + the back-solve phase (2 block solves + SC solve)

This EXCLUDES the reference's per-iteration NLP evaluation (Pyomo/ASL),
all MPI communication (the 64-rank reference all-reduces the dense SC data
— ~76 MB f64 — every factorization, mpi_explicit_schur_complement.py:343),
and sparse-format conversions, all of which the reference must also pay —
i.e. the baseline is strictly favorable to the reference.  It models 64
perfectly-scaled CPU ranks; the measurement here runs on ONE GPU, so
``vs_baseline`` understates the framework: the block axis is the sharded
axis, and on an n-GPU mesh the per-GPU block work divides by n while only
the replicated SC factorization and one small psum remain.  The baseline
runs in a CPU-only subprocess (JAX_PLATFORMS=cpu), so only one process
holds the GPU.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

NFE_X = 50
NFE_T = 256
N_BLOCKS = 64
TOL = 1e-8


def build_problem(
    nfe_x=NFE_X, nfe_t=NFE_T, n_blocks=N_BLOCKS, kkt_dtype="f32", block_form=None
):
    import jax.numpy as jnp
    import parapint_tpu as pt
    from parapint_tpu.examples import burgers

    spec = burgers.build_spec(nfe_x=nfe_x, nfe_t=nfe_t, num_time_blocks=n_blocks)
    # kkt_dtype=f32: the Hessian AD sweep and the KKT-matrix assembly run in
    # f32 (the matrix feeds the f32 factorization anyway); rhs, gradients and
    # convergence residuals stay f64 so tol=1e-8 remains certifiable.  The
    # scipy baseline passes kkt_dtype=None (it factors in f64).
    kw = {} if block_form is None else {"block_form": block_form}
    return pt.DynamicSchurComplementInteriorPointInterface(
        spec, kkt_dtype=jnp.float32 if kkt_dtype == "f32" else None, **kw
    )


def _block_form():
    """PT_BENCH_BLOCK in {banded, dense}: per-block factorization family.

    Default "banded": the flagship runs the MA27-envelope path
    (linalg/banded_schur.py) — block-Thomas over ts x ts tiles of the
    bandwidth-permuted per-block KKTs, O(nk * ts) factor bytes instead of
    the dense path's O(nk^2) explicit W.  "dense" selects the dense
    explicit-inverse path."""
    return os.environ.get("PT_BENCH_BLOCK", "banded")


def _make_solver(iface=None):
    import jax.numpy as jnp
    import parapint_tpu as pt

    if _block_form() == "banded":
        # ts=128 instead of the bandwidth-snapped default (72 for this
        # family): fewer sequential tile steps, larger batched matmuls
        ts = int(os.environ.get("PT_BENCH_TS", "128"))
        return pt.BandedSchurComplementSolver(
            schur_complement_solver=pt.BlockTridiagSolver(ns=iface.ns),
            tile_size=ts,
        )

    # refine_steps=0 converges this benchmark problem to tol 1e-8 and
    # skips the f64 refinement pass.  The chain-topology SC is block
    # tridiagonal: the cyclic-reduction tile solver factors it in
    # O(N * ns^3) instead of the dense O(((N-1) ns)^3).
    sc = (
        None
        if os.environ.get("PT_BENCH_SC") == "dense"
        else pt.BlockTridiagSolver()
    )
    # knobs for the bf16-W experiment:
    #   PT_BENCH_W=bf16      store W in bf16 (halves the apply HBM reads)
    #   PT_BENCH_REFINE=adaptive  adaptive refinement (enables the bf16
    #                        auto-gate; costs a probe matvec per solve)
    w_store = (
        jnp.bfloat16 if os.environ.get("PT_BENCH_W") == "bf16" else None
    )
    refine = (
        None if os.environ.get("PT_BENCH_REFINE") == "adaptive" else 0
    )
    return pt.SchurComplementSolver(
        block_size=128, explicit_inverse=True, factor_dtype=jnp.float32,
        refine_steps=refine, schur_complement_solver=sc,
        w_store_dtype=w_store,
    )


def measure_ours(nfe_x=NFE_X, nfe_t=NFE_T, n_blocks=N_BLOCKS, tol=TOL):
    import jax
    import parapint_tpu as pt

    interface = build_problem(
        nfe_x,
        nfe_t,
        n_blocks,
        block_form="banded" if _block_form() == "banded" else None,
    )
    options = pt.IPOptions()
    options.tol = tol
    options.linalg.solver = _make_solver(interface)
    solve = pt.make_fused_ip_solve(interface, options)
    interface.set_bounds_relaxation_factor(options.bounds_relaxation_factor)
    state0 = interface.init_state()

    # run 1 compiles; then the median of 5 warm solves, each ended by
    # block_until_ready
    t0 = time.perf_counter()
    result = jax.block_until_ready(solve(state0))
    first_solve_s = time.perf_counter() - t0
    status = int(result.status)
    n_iter = int(result.iterations)
    assert status == pt.InteriorPointStatus.optimal.value, (
        status,
        n_iter,
        float(result.primal_inf),
        float(result.dual_inf),
        float(result.compl_inf),
    )
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        result = jax.block_until_ready(solve(state0))
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    steps = max(1, n_iter - 1)  # final iteration is the terminating check
    return steps / wall, n_iter, wall, first_solve_s


def measure_reference_baseline(nfe_x=NFE_X, nfe_t=NFE_T, n_blocks=N_BLOCKS):
    """Idealized n_blocks-rank parapint per-iteration KKT time (module doc)."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    interface = build_problem(nfe_x, nfe_t, n_blocks, kkt_dtype=None)
    state = interface.init_state()
    interface._current_state = state
    data = interface.eval_kkt_data(state, 0.1)
    # light regularization so the unregularized zero pivots do not
    # penalize the baseline's SuperLU either
    kkt = interface.assemble_kkt(data, 1e-8, 1e-8)
    diag = np.asarray(kkt.diag)
    border = np.asarray(kkt.border_loc)
    row_idx = np.asarray(kkt.row_idx)
    N, nk, _ = diag.shape
    ncv = kkt.q.shape[0]
    rhs_blocks = np.asarray(interface.kkt_rhs(data).blocks)

    # host timings are noisy: take the minimum of the repetitions of every
    # timed section
    def timed(fn, reps=4):
        best = float("inf")
        out = None
        for _ in range(reps):
            t0 = time.time()
            out = fn()
            best = min(best, time.time() - t0)
        return best, out

    block_times = []
    sc = np.zeros((ncv, ncv))
    lus = []
    for i in range(N):
        K = sps.csc_matrix(diag[i])

        def block_work():
            lu = spla.splu(K)
            # SC contribution: one back solve per nonzero border row
            # (reference explicit_schur_complement.py:108-122)
            cols = {}
            for l in range(border.shape[1]):
                r = row_idx[i, l]
                if r < ncv and np.any(border[i, l] != 0.0):
                    v = lu.solve(border[i, l])
                    cols[r] = border[i] @ v
            return lu, cols

        t, (lu, cols) = timed(block_work)
        local = row_idx[i] < ncv
        for r, contrib in cols.items():
            sc[row_idx[i][local], r] -= contrib[local]
        block_times.append(t)
        lus.append(lu)

    sc_mat = sps.csc_matrix(sc + 1e-10 * np.eye(ncv))
    sc_factor_time, sc_lu = timed(lambda: spla.splu(sc_mat))

    # back-solve phase: 2 block solves + SC solve (reference :363-402)
    block_solve_time, _ = timed(
        lambda: (lus[0].solve(rhs_blocks[0]), lus[0].solve(rhs_blocks[0]))
    )
    sc_solve_time, _ = timed(lambda: sc_lu.solve(np.ones(ncv)))

    time_per_iter = (
        max(block_times) + sc_factor_time + block_solve_time + sc_solve_time
    )
    return 1.0 / time_per_iter, time_per_iter


def main():
    if "--baseline-only" in sys.argv:
        ips, titer = measure_reference_baseline()
        print(json.dumps({"baseline_ips": ips, "time_per_iter": titer}))
        return

    from parapint_tpu.utils.launch import (
        device_info,
        enable_compile_cache,
        require_gpu,
    )

    enable_compile_cache()
    require_gpu()
    ours_ips, n_iter, wall, first_solve_s = measure_ours()

    # baseline in a CPU-only subprocess (scipy path): it never opens the GPU
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--baseline-only"],
        env=env,
        capture_output=True,
        text=True,
        check=True,
    )
    base = json.loads(out.stdout.strip().splitlines()[-1])
    base_ips = base["baseline_ips"]

    result = {
        "metric": "ip_iterations_per_s_burgers_64blocks",
        "value": ours_ips,
        "unit": "iter/s",
        "vs_baseline": ours_ips / base_ips,
        "detail": {
            "n_iter": n_iter,
            "wall_s_median_of_5": wall,
            "first_solve_s_incl_compile": first_solve_s,
            "device": device_info(),
            "baseline_time_per_iter_s": base["time_per_iter"],
            "baseline": "idealized 64-rank parapint KKT path (scipy SuperLU), "
            "zero comm + zero eval cost",
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
