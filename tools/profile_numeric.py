"""Drill-down of the dense path's `numeric` phase (factor + SC).

Times the sub-pieces of the dense explicit-inverse factorization
(PT_BENCH_BLOCK=dense in bench.py) at the benchmark shape, each jitted
alone: median of 5 warm calls, each ended by ``jax.block_until_ready``.
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
    from parapint_tpu.linalg import schur as S
    from parapint_tpu.ops import ldl as L

    os.environ["PT_BENCH_BLOCK"] = "dense"
    interface = bench.build_problem()
    solver = bench._make_solver(interface)
    state = interface.init_state()
    data_rhs = jax.jit(
        lambda s: interface.eval_kkt_data(s, 0.1)
    )(state)
    kkt = jax.jit(lambda d: interface.assemble_kkt(d, 1e-8, 1e-8))(data_rhs)
    print(f"diag shape {kkt.diag.shape} dtype {kkt.diag.dtype} "
          f"border {kkt.border_loc.shape} q {kkt.q.shape}")

    times = {}
    # full numeric
    fact, times["numeric_total"] = timed(jax.jit(solver.numeric), kkt)

    # 1) factor blocks (winv form, f32, ruiz)
    def fb(diag, mask):
        return S._factor_blocks_winv(
            diag, mask, solver.block_size, solver.zero_tol,
            solver.factor_dtype, apply_dtype=solver.apply_dtype
        )

    out, times["factor_blocks_winv"] = timed(jax.jit(fb), kkt.diag, kkt.mask)
    W, d, s = out[0], out[1], out[2]

    # 1a) inside: cast+ruiz+the batched LDL+winv alone
    def raw_factor(diag):
        return L.ldl_factor_winv_batched(
            diag.astype(jnp.float32), solver.block_size
        )

    _, times["ldl_factor_winv_batched"] = timed(jax.jit(raw_factor), kkt.diag)

    # factor WITHOUT the fused W assembly
    def raw_factor_plain(diag):
        LD, dd = L.ldl_factor_batched(diag.astype(jnp.float32), solver.block_size)
        return LD, dd

    _, times["ldl_factor_batched_only"] = timed(
        jax.jit(raw_factor_plain), kkt.diag
    )

    # 2) SC tiles from the factor
    nc = kkt.q.shape[-1]
    def tiles(W, d, s, border):
        return S._sc_tiles_local_winv(W, d, s, border, nc, 0)

    _, times["sc_tiles"] = timed(jax.jit(tiles), W, d, s, kkt.border_loc)

    # 3) SC (tridiag CR) factorization
    from parapint_tpu.linalg.tridiag import extract_tridiag, BlockTridiag
    dt_c, ut_full = jax.jit(tiles)(W, d, s, kkt.border_loc)
    ns = kkt.border_loc.shape[1] // 2
    def sc_num(dt_c, ut_full, q):
        q_tri = extract_tridiag(q, ns)
        sc = BlockTridiag(diag=q_tri.diag - dt_c, upper=q_tri.upper - ut_full[:-1])
        return solver.sc_solver.numeric(sc)

    _, times["sc_factor_cr"] = timed(jax.jit(sc_num), dt_c, ut_full, kkt.q)

    adj = {k: round(v * 1e3, 2) for k, v in times.items()}
    print(json.dumps(adj))


if __name__ == "__main__":
    main()
