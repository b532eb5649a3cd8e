"""Extended benchmark matrix — the BASELINE.md measurement configs.

Prints one JSON line per config (the driver contract lives in bench.py;
this script is the full matrix for analysis):

  1. serial IP, small Burgers, 4 time blocks
  2. dense Schur-complement decomposition, 8 time blocks, one GPU
  3. two-stage stochastic, 32 scenario blocks, batched factorizations
  4. PCG coupling solver (the sc_mpi/distributed analogue), 8 blocks
  5. 256-block Burgers (one GPU here; several GPUs = same code + mesh)

All solves run the device-fused ip_solve at tol 1e-8; the first solve
compiles, and each row reports the median of 5 warm solves, each ended by
``jax.block_until_ready``.  Exits non-zero when any row failed.
"""

import json
import statistics
import sys
import time

import numpy as np


def fused_iters_per_s(interface, solver, tol=1e-8, reps=5):
    """(iters/s, n_iter, median wall, spread): compile, then time warm
    solves; spread = max - min wall over the ``reps`` timed solves."""
    import jax
    import parapint_tpu as pt

    options = pt.IPOptions()
    options.tol = tol
    options.linalg.solver = solver
    solve = pt.make_fused_ip_solve(interface, options)
    interface.set_bounds_relaxation_factor(options.bounds_relaxation_factor)
    state0 = interface.init_state()
    result = jax.block_until_ready(solve(state0))
    assert int(result.status) == pt.InteriorPointStatus.optimal.value, (
        int(result.status),
        int(result.iterations),
    )
    n_iter = int(result.iterations)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(solve(state0))
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    return max(1, n_iter - 1) / wall, n_iter, wall, max(walls) - min(walls)


def stochastic_32():
    import jax.numpy as jnp
    import parapint_tpu as pt
    from parapint_tpu.examples import stochastic as farmer

    rng = np.random.default_rng(0)
    base = farmer.YIELDS[1]
    scale = np.linspace(0.7, 1.3, 32)[:, None]
    yields = base[None, :] * scale * (1.0 + 0.05 * rng.standard_normal((32, 3)))
    probs = np.full(32, 1.0 / 32)
    spec = farmer.build_spec(yields=yields, probs=probs)
    return pt.StochasticSchurComplementInteriorPointInterface(spec)


def stochastic_qp(n_scenarios=32, n=768, me=192, n_first=64, kkt_dtype="f32"):
    """Synthetic two-stage stochastic QP with ~1k variables per scenario.

    The farmer family's blocks are ~3 variables: timing it measures
    dispatch overhead, not factorization throughput (BASELINE.md:34 asks
    for "batched block factorizations").  This family's per-scenario KKT
    block is nk = n + me + n_first = 1024 — the production panel shape —
    so the 32-scenario config stresses the batched LDL^T exactly like the
    dynamic family does.

      min  sum_s p_s [ 0.5 x_s^T diag(q_s) x_s + c_s^T x_s ]
      s.t. A x_s = b_s,  x_s >= 0,  x_s[:n_first] == theta (nonanticipativity)

    with shared Gaussian A and per-scenario (q_s, c_s, b_s); b_s = A x*_s
    for a strictly positive x*_s, so a strict interior exists; c_s makes a
    meaningful fraction of the bounds active at the optimum.
    """
    import jax.numpy as jnp
    import parapint_tpu as pt
    from parapint_tpu.interfaces.stochastic import StochasticModelSpec

    rng = np.random.default_rng(7)
    N = n_scenarios
    A = rng.standard_normal((me, n)) / np.sqrt(n)
    Aj = jnp.asarray(A)
    q = rng.uniform(0.5, 2.0, size=(N, n))
    c = rng.standard_normal((N, n))
    x_tgt = np.abs(rng.standard_normal((N, n))) + 0.1
    b = x_tgt @ A.T
    probs = np.full(N, 1.0 / N)

    def objective(x, p):
        return p["prob"] * (0.5 * jnp.sum(p["q"] * x * x) + jnp.dot(p["c"], x))

    def eq_constraints(x, p):
        return Aj @ x - p["b"]

    spec = StochasticModelSpec(
        num_scenarios=N,
        objective=objective,
        eq_constraints=eq_constraints,
        params={
            "q": jnp.asarray(q),
            "c": jnp.asarray(c),
            "b": jnp.asarray(b),
            "prob": jnp.asarray(probs),
        },
        x0=np.full((N, n), 1.0),
        first_stage_idx=np.arange(n_first),
        xl=np.zeros((N, n)),
    )
    return pt.StochasticSchurComplementInteriorPointInterface(
        spec, kkt_dtype=jnp.float32 if kkt_dtype == "f32" else None
    )


def main():
    import jax.numpy as jnp
    import parapint_tpu as pt
    from parapint_tpu.examples import burgers
    from parapint_tpu.utils.launch import (
        device_info,
        enable_compile_cache,
        require_gpu,
    )

    enable_compile_cache()
    require_gpu()

    fast = dict(block_size=128, explicit_inverse=True, factor_dtype=jnp.float32, refine_steps=0)
    configs = []

    def burgers_if(nfe_x, nfe_t, nblocks):
        spec = burgers.build_spec(nfe_x=nfe_x, nfe_t=nfe_t, num_time_blocks=nblocks)
        return pt.DynamicSchurComplementInteriorPointInterface(
            spec, kkt_dtype=jnp.float32
        )

    def cr():
        return pt.BlockTridiagSolver()

    configs.append(
        (
            "burgers_serial_4blocks",
            lambda: (burgers_if(50, 16, 4), pt.SchurComplementSolver(**fast)),
        )
    )
    configs.append(
        (
            "burgers_ssc_8blocks",
            lambda: (burgers_if(50, 32, 8), pt.SchurComplementSolver(**fast)),
        )
    )
    configs.append(
        (
            "stochastic_32scenarios",
            lambda: (
                stochastic_32(),
                pt.SchurComplementSolver(block_size=64, explicit_inverse=True),
            ),
        )
    )
    configs.append(
        (
            # BASELINE.md:34 "batched block factorizations": the farmer
            # family's ~3-variable blocks measure dispatch overhead; this
            # synthetic two-stage QP has nk=1024 per scenario (see
            # stochastic_qp), so the config stresses the batched LDL^T
            "stochastic_qp_32scenarios_1k",
            lambda: (
                stochastic_qp(kkt_dtype=None),
                # HYBRID precision (f64 pivot sweep + f32 applies) with
                # adaptive refinement: the QP's active bounds give real
                # barrier ill-conditioning — an all-f32 sweep stalls
                # (status=error from the refinement-stall detector)
                pt.SchurComplementSolver(
                    block_size=128, explicit_inverse=True,
                    factor_dtype=jnp.float64, apply_dtype=jnp.float32,
                ),
            ),
        )
    )
    configs.append(
        (
            "burgers_pcg_coupling_8blocks",
            lambda: (
                burgers_if(50, 32, 8),
                pt.PCGSchurComplementSolver(block_size=128, factor_dtype=jnp.float32),
            ),
        )
    )
    configs.append(
        (
            "burgers_64blocks_cr",
            lambda: (
                burgers_if(50, 256, 64),
                pt.SchurComplementSolver(schur_complement_solver=cr(), **fast),
            ),
        )
    )
    def banded_cr(iface):
        return pt.BandedSchurComplementSolver(
            schur_complement_solver=pt.BlockTridiagSolver(ns=iface.ns),
            tile_size=128,
        )

    def burgers_banded_row(nfe_x, nfe_t, nblocks):
        spec = burgers.build_spec(
            nfe_x=nfe_x, nfe_t=nfe_t, num_time_blocks=nblocks
        )
        iface = pt.DynamicSchurComplementInteriorPointInterface(
            spec, kkt_dtype=jnp.float32, block_form="banded"
        )
        return iface, banded_cr(iface)

    configs.append(
        (
            # the flagship default (bench.py): banded block-Thomas
            # per-block factorization, ts=128 tiles, CR coupling
            "burgers_64blocks_banded_cr",
            lambda: burgers_banded_row(50, 256, 64),
        )
    )
    configs.append(
        (
            "burgers_256blocks_banded_cr",
            lambda: burgers_banded_row(50, 512, 256),
        )
    )
    configs.append(
        (
            "burgers_256blocks_cr",
            lambda: (
                burgers_if(50, 512, 256),
                pt.SchurComplementSolver(schur_complement_solver=cr(), **fast),
            ),
        )
    )
    configs.append(
        (
            "burgers_256blocks_dense_sc",
            lambda: (burgers_if(50, 512, 256), pt.SchurComplementSolver(**fast)),
        )
    )

    def burgers_banded_if(nfe_x, nfe_t, nblocks):
        spec = burgers.build_spec(nfe_x=nfe_x, nfe_t=nfe_t, num_time_blocks=nblocks)
        return pt.DynamicSchurComplementInteriorPointInterface(
            spec, kkt_dtype=jnp.float32, block_form="banded"
        )

    configs.append(
        (
            # the reference's flagship scaling knob at a DENSE-INFEASIBLE
            # size: nfe_x=200 gives nk=3017 per block; the dense path would
            # materialize 64 x 3017^2 f32 = 2.3 GB diag + same W, the
            # banded path stores (64, 61, 3017) bands + O(nk*ts) tiles
            # (~70x less): the banded path's memory case.
            "burgers_banded_nfex200_64blocks",
            lambda: (
                burgers_banded_if(200, 256, 64),
                pt.BandedSchurComplementSolver(
                    schur_complement_solver=pt.BlockTridiagSolver(),
                    factor_dtype=jnp.float32,
                ),
            ),
        )
    )

    # optional substring filters: python bench_all.py 256 pcg
    filters = [a for a in sys.argv[1:] if not a.startswith("-")]
    if filters:
        configs = [
            (n, m) for n, m in configs if any(f in n for f in filters)
        ]

    device = device_info()
    failed = []
    for name, make in configs:
        try:
            interface, solver = make()
            ips, n_iter, wall, spread = fused_iters_per_s(interface, solver)
            print(
                json.dumps(
                    {
                        "config": name,
                        "ip_iterations_per_s": ips,
                        "n_iter": n_iter,
                        "wall_s_median": wall,
                        "wall_s_spread": spread,
                        "device": device,
                    }
                ),
                flush=True,
            )
        except Exception as e:  # keep the matrix running, fail at the end
            failed.append(name)
            print(json.dumps({"config": name, "error": str(e)[:200]}), flush=True)

    # condensed structured solver at the reference's DEFAULT perf-harness
    # scale (n_q_per_block=5000, n_y_multiplier=120 -> 605,010 variables
    # per block; /root/reference/parapint/examples/performance/
    # schur_complement/main.py:63-73), with planted-theta recovery
    if not filters or any(f in "condensed_lsq_refscale" for f in filters):
        try:
            from parapint_tpu.examples.performance import schur_complement as perf

            # warm=True: numeric+solve re-timed after the first call, so the
            # one-time XLA compile is excluded — the quantity comparable to
            # the reference's per-call MA27 numeric/back-solve times
            r = perf.run(
                method="csc",
                n_blocks=3,
                n_q_per_block=5000,
                n_y_multiplier=120,
                verbose=False,
                warm=True,
            )
            print(
                json.dumps(
                    {
                        "config": "condensed_lsq_refscale_605k_vars_per_block",
                        "theta_max_err": r.max_err,
                        "theta_recovered": bool(r.max_err < 1.0),
                        "symbolic_s": r.symbolic_time,
                        "warm_numeric_s": r.numeric_time,
                        "warm_back_solve_s": r.back_solve_time,
                        "status": r.status,
                        "device": device,
                    }
                ),
                flush=True,
            )
        except Exception as e:
            failed.append("condensed_lsq_refscale_605k_vars_per_block")
            print(
                json.dumps(
                    {"config": "condensed_lsq_refscale_605k_vars_per_block",
                     "error": str(e)[:200]}
                ),
                flush=True,
            )
    if failed:
        sys.exit(f"failed rows: {', '.join(failed)}")


if __name__ == "__main__":
    main()
