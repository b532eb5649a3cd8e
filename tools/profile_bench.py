"""Per-phase breakdown of one IP iteration at the benchmark shape.

Times each phase of the fused Burgers-64-block iteration separately (each
jitted alone; median of 5 warm calls, each ended by
``jax.block_until_ready``) on the current backend.  Phases mirror the fused
step:

  eval_ad       one AD sweep (f32 Hessian/Jacobians, f64 grads/residuals)
  convergence   residual norms from the AD bundle
  kkt+rhs       KKT data assembly from the AD bundle
  assemble      (N, nk, nk) block-diagonal matrix assembly
  numeric       block factorization + SC tiles + SC factorization
  solve         block solves + SC back solve (+ refinement probe)
  step          deltas + fraction-to-the-boundary + apply
"""

import builtins
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
builtins.print = functools.partial(print, flush=True)

import jax
import jax.numpy as jnp


from parapint_tpu.utils.profile import timed


def main():
    import bench
    import parapint_tpu as pt

    interface = bench.build_problem(
        block_form="banded" if bench._block_form() == "banded" else None
    )
    solver = bench._make_solver(interface)
    state = interface.init_state()
    mu = 0.1

    times = {}
    ad, times["eval_ad"] = timed(
        jax.jit(interface.eval_ad), state
    )
    _, times["convergence"] = timed(
        jax.jit(
            lambda s, a: interface.convergence_from_ad(s, a, 0.0, 100.0)
        ),
        state,
        ad,
    )
    data_rhs, times["kkt_rhs_from_ad"] = timed(
        jax.jit(lambda s, a: interface.kkt_from_ad(s, a, mu)), state, ad
    )
    kkt, times["assemble"] = timed(
        jax.jit(lambda d: interface.assemble_kkt(d, 0.0, 0.0)), data_rhs
    )
    fact, times["numeric"] = timed(jax.jit(solver.numeric), kkt)
    rhs = interface.kkt_rhs(data_rhs)
    sol, times["solve"] = timed(jax.jit(solver.solve), fact, rhs)

    def step_tail(state, sol):
        deltas = interface.extract_deltas(state, sol, mu)
        a_p, a_d = interface.fraction_to_the_boundary(state, deltas, 1.0 - mu)
        return interface.apply_step(state, deltas, a_p, a_d)

    _, times["step_tail"] = timed(jax.jit(step_tail), state, sol)

    total = sum(times.values())
    print(json.dumps({k: round(v * 1e3, 3) for k, v in times.items()}))
    print(f"total {total*1e3:.2f} ms/iter -> {1.0/total:.2f} iter/s upper bound")


if __name__ == "__main__":
    main()
