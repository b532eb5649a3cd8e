"""Worker body for the 2-process sharded-solver test (the reference's
``mpirun -np 2 ... -m pytest`` analogue, main_ci.yml:33-41).

Run as:  python multiprocess_worker.py <process_id> <num_processes> <port> [mode]

mode "toy" (default): every process builds the SAME deterministic
block-bordered system, places it on a global mesh spanning both processes,
runs the sharded Schur solver (collectives cross the process boundary over
TCP), and checks the result against a dense oracle.

mode "production": the dryrun_multichip configuration under REAL
multi-process execution — 16-block Burgers chain at nk=922 (b=128 winv
panels, kkt_dtype=f32, CR coupling, 2 blocks/shard so ``group_offset`` is
live), full fused IP solve to tol 1e-8 with serial objective parity,
plus a non-divisible block count (11 blocks on 8 shards).

Prints "WORKER_OK <pid>" on success.
"""

import os
import sys

proc_id, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mode = sys.argv[4] if len(sys.argv) > 4 else "toy"

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from parapint_tpu.parallel import distributed

distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=nprocs,
    process_id=proc_id,
    local_device_count=4,
)

import numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import parapint_tpu as pt
from parapint_tpu.linalg import BlockTridiagSolver, ShardedSchurComplementSolver
from parapint_tpu.linalg.schur import BlockKKT, BlockRhs

assert len(jax.devices()) == 4 * nprocs, jax.devices()
mesh = distributed.global_mesh("blocks")


def _production_mode():
    """Full fused production solve across the process boundary (round-5
    verdict item: the dryrun config under real multi-process execution,
    the analogue of the reference's mpirun CI tier, main_ci.yml:33-41)."""
    import parapint_tpu as pt
    from parapint_tpu.examples import burgers
    from parapint_tpu.linalg import BlockTridiagSolver, ShardedSchurComplementSolver

    n_devices = len(jax.devices())
    tol = 1e-8
    n_blocks = 2 * n_devices  # 2 blocks/shard -> group_offset live
    nfe_x, nfe_t = 50, 4 * n_blocks  # nk = 922, b=128 winv panels
    spec = burgers.build_spec(nfe_x=nfe_x, nfe_t=nfe_t, num_time_blocks=n_blocks)
    interface = pt.DynamicSchurComplementInteriorPointInterface(
        spec, mesh=mesh, kkt_dtype=jnp.float32
    )
    solver = ShardedSchurComplementSolver(
        mesh, "blocks", block_size=128, explicit_inverse=True,
        factor_dtype=jnp.float32,
        schur_complement_solver=BlockTridiagSolver(),
    )
    opts = pt.IPOptions()
    opts.tol = tol
    opts.linalg.solver = solver
    solve = pt.make_fused_ip_solve(interface, opts)
    interface.set_bounds_relaxation_factor(opts.bounds_relaxation_factor)
    result = solve(interface.init_state())
    assert int(result.status) == pt.InteriorPointStatus.optimal.value, (
        int(result.status), int(result.iterations),
    )
    interface._current_state = result.state
    sharded_obj = float(interface.evaluate_objective())

    # serial parity: an independent single-device solve of the same problem
    # (computed identically in every process; asserts the distributed
    # collectives changed nothing)
    spec_s = burgers.build_spec(nfe_x=nfe_x, nfe_t=nfe_t, num_time_blocks=n_blocks)
    iface_s = pt.DynamicSchurComplementInteriorPointInterface(spec_s)
    opts_s = pt.IPOptions()
    opts_s.tol = tol
    opts_s.linalg.solver = pt.SchurComplementSolver(
        block_size=128, explicit_inverse=True, factor_dtype=jnp.float32,
        schur_complement_solver=BlockTridiagSolver(),
    )
    solve_s = pt.make_fused_ip_solve(iface_s, opts_s)
    iface_s.set_bounds_relaxation_factor(opts_s.bounds_relaxation_factor)
    result_s = solve_s(iface_s.init_state())
    assert int(result_s.status) == pt.InteriorPointStatus.optimal.value
    iface_s._current_state = result_s.state
    serial_obj = float(iface_s.evaluate_objective())
    gap = abs(sharded_obj - serial_obj) / max(1.0, abs(serial_obj))
    assert gap <= 1e-6, (sharded_obj, serial_obj)

    # non-divisible count: 11 blocks on 8 shards (pad_block_count +
    # chain->scatter fallback) across the process boundary
    n_odd = n_devices + 3
    spec_o = burgers.build_spec(nfe_x=8, nfe_t=2 * n_odd, num_time_blocks=n_odd)
    iface_o = pt.DynamicSchurComplementInteriorPointInterface(
        spec_o, mesh=mesh, kkt_dtype=jnp.float32
    )
    solver_o = ShardedSchurComplementSolver(
        mesh, "blocks", block_size=32, explicit_inverse=True,
        factor_dtype=jnp.float32,
    )
    opts_o = pt.IPOptions()
    opts_o.tol = tol
    opts_o.linalg.solver = solver_o
    solve_o = pt.make_fused_ip_solve(iface_o, opts_o)
    iface_o.set_bounds_relaxation_factor(opts_o.bounds_relaxation_factor)
    result_o = solve_o(iface_o.init_state())
    assert int(result_o.status) == pt.InteriorPointStatus.optimal.value
    print(
        f"PRODUCTION_OK blocks={n_blocks} nk=922 iters={int(result.iterations)} "
        f"obj={sharded_obj:.12g} serial_obj={serial_obj:.12g} gap={gap:.2e} "
        f"odd_iters={int(result_o.iterations)}",
        flush=True,
    )


if mode == "production":
    _production_mode()
    print(f"WORKER_OK {proc_id}", flush=True)
    sys.exit(0)

# deterministic system, identical on every process
rng = np.random.default_rng(0)
N, nk, nc = 8, 12, 5
diag = np.zeros((N, nk, nk))
border = rng.standard_normal((N, nc, nk))
for i in range(N):
    A = rng.standard_normal((nk, nk))
    diag[i] = A @ A.T + nk * np.eye(nk)
q = np.eye(nc) * nc + 0.1
rhs_blocks = rng.standard_normal((N, nk))
rhs_coupling = rng.standard_normal(nc)

# dense oracle (host, per process)
M = np.zeros((N * nk + nc, N * nk + nc))
for i in range(N):
    M[i * nk : (i + 1) * nk, i * nk : (i + 1) * nk] = diag[i]
    M[N * nk :, i * nk : (i + 1) * nk] = border[i]
    M[i * nk : (i + 1) * nk, N * nk :] = border[i].T
M[N * nk :, N * nk :] = q
expected = np.linalg.solve(M, np.concatenate([rhs_blocks.ravel(), rhs_coupling]))

# global placement: block axis sharded across ALL 8 devices (2 processes)
kkt = BlockKKT.make(
    *distributed.replicated_to_global(mesh, P("blocks"), (diag, border)),
    distributed.replicated_to_global(mesh, P(), q),
)
rhs = BlockRhs(
    blocks=distributed.replicated_to_global(mesh, P("blocks"), rhs_blocks),
    coupling=distributed.replicated_to_global(mesh, P(), rhs_coupling),
)

solver = ShardedSchurComplementSolver(mesh=mesh, block_size=16)
sol = jax.jit(lambda k, r: solver.solve(solver.numeric(k), r))(kkt, rhs)

# coupling is replicated -> fully addressable on every process
y = np.asarray(sol.coupling)
assert np.allclose(y, expected[N * nk :], rtol=1e-8, atol=1e-8), (
    y,
    expected[N * nk :],
)
# block solutions: check the shards THIS process owns
for shard in sol.blocks.addressable_shards:
    lo = shard.index[0].start or 0
    got = np.asarray(shard.data)
    exp = expected[: N * nk].reshape(N, nk)[lo : lo + got.shape[0]]
    assert np.allclose(got, exp, rtol=1e-8, atol=1e-8)

# inertia (psum across processes) must match the dense eigvals
fact = jax.jit(solver.numeric)(kkt)
pos, neg, zero = (int(v) for v in solver.inertia(fact))
w = np.linalg.eigvalsh(M)
assert (pos, neg, zero) == ((w > 0).sum(), (w < 0).sum(), 0), (pos, neg, zero)

# full interface + fused solve across both processes: the multichip dryrun
# under real multi-process execution (2-process analogue of
# __graft_entry__.dryrun_multichip)
from parapint_tpu.examples import burgers

spec = burgers.build_spec(nfe_x=4, nfe_t=16, num_time_blocks=8)
iface = pt.DynamicSchurComplementInteriorPointInterface(spec, mesh=mesh)
opts = pt.IPOptions()
opts.max_iter = 3  # a dryrun: a few sharded iterations, not full convergence
opts.linalg.solver = ShardedSchurComplementSolver(
    mesh, "blocks", block_size=32,
    schur_complement_solver=BlockTridiagSolver(),
)
status, result = pt.ip_solve_fused(iface, opts)
assert int(result.iterations) >= 1
for leaf in jax.tree_util.tree_leaves(result.state):
    if hasattr(leaf, "addressable_shards"):
        for shard in leaf.addressable_shards:
            assert np.all(np.isfinite(np.asarray(shard.data)))

print(f"WORKER_OK {proc_id}", flush=True)
