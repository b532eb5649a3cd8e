"""GPU smoke test: the solver's main path on one card, end to end.

    python chip_smoke.py              # one GPU, phases (a)-(e)
    python chip_smoke.py --four-gpus  # only the sharded path on 4 GPUs

Phases, in order, in one process; any failure exits non-zero:

  (a) device check: JAX's default backend must be the GPU (no CPU
      fallback); prints the card's name and power limit.
  (b) the panel LDL^T step as the GPU dispatch runs it (the compiled Triton
      kernel; f64 panels wider than 64 on the XLA slab loop) against the plain
      reference (``vmap(_ldl_unblocked)`` in f64 on the card): widths 64,
      128 and 49 (padded), batches 64 and 512, f32 and f64, quasi-definite
      KKT-like panels plus real tiles of the flagship's first
      factorization.  Inertia identical, reconstruction residual and
      ``max|L W - I|`` under their limits.
  (c) the flagship (bench.py's configuration: Burgers nfe_x=50, nfe_t=256,
      64 time blocks, banded f32 block factorization, cyclic-reduction
      coupling solve, tol 1e-8) through ``make_fused_ip_solve``: optimal,
      iterations, warm iterations/s (median of 5 solves), compile seconds,
      the solve's device footprint; objective against a plain f64 dense
      solve.
  (d) the 32-scenario stochastic QP (nk=1024, f64 pivot sweep with f32
      applies): optimal, objective against the f64 dense solve.
  (e) one IP step from ``__graft_entry__.entry()``, then the flagship
      through ``ShardedBandedSchurComplementSolver`` on a mesh of the one
      GPU, against the serial objective of (c).

The last line of standard output is one JSON object naming the device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

OBJ_GAP = 1e-6
RESID_LIMIT = {"float32": 1e-5, "float64": 1e-12}
WINV_LIMIT = {"float32": 1e-4, "float64": 1e-11}
# on real (pivot-growing) tiles: the kernel's raw residual against that of
# the plain reference factored in the same dtype
RAW_VS_PLAIN = 4.0


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()


def fused_solve(interface, solver, tol=1e-8, reps=0):
    """Compile and run one fused IP solve; optionally time ``reps`` warm
    solves.  Returns (result, objective, compile_s, median warm wall, the
    executable's device footprint in bytes: arguments + outputs + temps)."""
    import jax
    import parapint_tpu as pt

    options = pt.IPOptions()
    options.tol = tol
    options.linalg.solver = solver
    solve = pt.make_fused_ip_solve(interface, options)
    interface.set_bounds_relaxation_factor(options.bounds_relaxation_factor)
    state0 = interface.init_state()
    t0 = time.perf_counter()
    compiled = solve.lower(state0).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    footprint = (
        mem.argument_size_in_bytes
        + mem.output_size_in_bytes
        + mem.temp_size_in_bytes
        - mem.alias_size_in_bytes
    )
    result = jax.block_until_ready(compiled(state0))
    assert int(result.status) == pt.InteriorPointStatus.optimal.value, (
        int(result.status),
        int(result.iterations),
        float(result.primal_inf),
        float(result.dual_inf),
        float(result.compl_inf),
    )
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(state0))
        walls.append(time.perf_counter() - t0)
    interface._current_state = result.state
    obj = float(interface.evaluate_objective())
    return result, obj, compile_s, (statistics.median(walls) if walls else None), footprint


def process_peak_bytes():
    """The process's peak device memory so far (all phases before it)."""
    import jax

    return jax.devices()[0].memory_stats()["peak_bytes_in_use"]


def rel_gap(a, b):
    return abs(a - b) / max(1.0, abs(b))


# ---------------------------------------------------------------- (b)


def quasi_definite_panels(rng, B, b):
    """KKT-like quasi-definite panels: an SPD block, then a negative
    definite block, coupled off the diagonal."""
    k = b // 2
    G = rng.standard_normal((B, k, k))
    H = rng.standard_normal((B, b - k, b - k))
    C = rng.standard_normal((B, b - k, k))
    A = np.zeros((B, b, b))
    A[:, :k, :k] = G @ G.transpose(0, 2, 1) / k + np.eye(k)
    A[:, k:, k:] = -(H @ H.transpose(0, 2, 1) / (b - k) + np.eye(b - k))
    A[:, k:, :k] = 0.5 * C
    A[:, :k, k:] = 0.5 * C.transpose(0, 2, 1)
    return A


def flagship_tiles(interface, ts=128):
    """The Ruiz-scaled first diagonal tile of every block of the flagship's
    first factorization, as the banded solver hands it to the panel step."""
    import jax
    import jax.numpy as jnp
    from parapint_tpu.linalg.banded_schur import banded_tiles
    from parapint_tpu.ops.ldl import ruiz_scale

    state = interface.init_state()
    data = jax.jit(lambda s: interface.eval_kkt_data(s, 0.1))(state)
    kkt = jax.jit(lambda d: interface.assemble_kkt(d, 0.0, 0.0))(data)
    diag_t = banded_tiles(kkt.sym_bands, ts)[0]
    T = diag_t[:, 0].astype(jnp.float32)
    s = jax.vmap(ruiz_scale)(T)
    return np.asarray(T * s[:, :, None] * s[:, None, :], dtype=np.float64)


def check_panels(A, dtype, label, normalized=False):
    """Factor ``A`` (numpy, rounded to ``dtype``) through the production
    panel step (the compiled Triton kernel, or the XLA loop for the f64
    panels wider than 64 that the dispatch rule sends there) and compare
    with the f64 reference on the card.

    The residuals are taken relative to max|A| and, for ``normalized``
    batches, relative to max(|L||D||L^T|) and max(|L||W|): real KKT tiles
    carry pivot growth (max|L D L^T| / max|A| ~ 1e5 on the flagship) that
    any unpivoted f32 factorization turns into a residual of ~1e-3 of
    max|A|, so there the growth-normalized backward error is checked, and
    the raw residual must stay within RAW_VS_PLAIN of the plain reference
    factored in the same dtype on the same tiles.
    """
    import jax
    import jax.numpy as jnp
    from parapint_tpu.ops import ldl, pallas_ldl

    B, b, _ = A.shape
    Ad = jnp.asarray(A, dtype)
    A64 = Ad.astype(jnp.float64)
    F, W = jax.jit(ldl._panel_factor_batch_winv)(Ad)
    reference = jax.jit(jax.vmap(ldl._ldl_unblocked))
    R = reference(A64)
    eye = jnp.eye(b, dtype=jnp.float64)

    def residuals(F, W=None):
        F = F.astype(jnp.float64)
        d = jnp.diagonal(F, axis1=1, axis2=2)
        L = jnp.tril(F, -1) + eye
        hi = "highest"
        rec = jnp.einsum("nij,nj,nkj->nik", L, d, L, precision=hi)
        err = jnp.max(jnp.abs(rec - A64))
        grown = jnp.einsum("nij,nj,nkj->nik", jnp.abs(L), jnp.abs(d), jnp.abs(L), precision=hi)
        out = [float(err / jnp.max(jnp.abs(A64))), float(err / jnp.max(grown))]
        if W is not None:
            W = W.astype(jnp.float64)
            werr = jnp.max(jnp.abs(jnp.einsum("nij,njk->nik", L, W, precision=hi) - eye))
            wgrown = jnp.einsum("nij,njk->nik", jnp.abs(L), jnp.abs(W), precision=hi)
            out += [float(werr), float(werr / jnp.max(wgrown))]
        return d, out

    d, (resid, resid_n, winv, winv_n) = residuals(F, W)
    d_ref = jnp.diagonal(R, axis1=1, axis2=2)
    inertia = [int(jnp.sum(d > 0)), int(jnp.sum(d < 0))]
    inertia_ref = [int(jnp.sum(d_ref > 0)), int(jnp.sum(d_ref < 0))]
    same_signs = bool(jnp.all(jnp.sign(d) == jnp.sign(d_ref)))
    name = jnp.dtype(dtype).name
    r_lim, w_lim = RESID_LIMIT[name], WINV_LIMIT[name]
    if not pallas_ldl.use_kernel(b, dtype):
        route = "XLA slab loop, W by triangular solve"
    elif pallas_ldl.w_in_kernel(b):
        route = "Triton kernel, W in the kernel"
    else:
        route = "Triton kernel, W by triangular solve"
    msg = (
        f"panel {label} B={B} b={b} {name} ({route}): inertia {inertia} ref {inertia_ref} "
        f"signs_equal={same_signs} | max|LDL^T-A|/max|A| {resid:.3e} "
        f"(growth-normalized {resid_n:.3e}) | max|LW-I| {winv:.3e} "
        f"(growth-normalized {winv_n:.3e})"
    )
    if normalized:
        plain = residuals(reference(Ad))[1][0]
        msg += (
            f" | limits on the normalized values: {r_lim:.0e}, {w_lim:.0e} "
            f"| plain reference in {name}: max|LDL^T-A|/max|A| {plain:.3e}, "
            f"raw limit {RAW_VS_PLAIN} x that"
        )
        log(msg)
        assert resid <= RAW_VS_PLAIN * plain, (label, resid, plain)
        resid, winv = resid_n, winv_n
    else:
        msg += f" | limits: {r_lim:.0e}, {w_lim:.0e}"
        log(msg)
    assert same_signs and inertia == inertia_ref, label
    assert resid <= r_lim, (label, resid)
    assert winv <= w_lim, (label, winv)


def phase_panels(tiles):
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    for dtype in (jnp.float32, jnp.float64):
        for b in (64, 128, 49):
            for B in (64, 512):
                check_panels(quasi_definite_panels(rng, B, b), dtype, "quasi-definite")
    for dtype in (jnp.float32, jnp.float64):
        check_panels(tiles, dtype, "flagship tile", normalized=True)
        check_panels(tiles[:, :64, :64], dtype, "flagship panel", normalized=True)


# ---------------------------------------------------------------- (c)


def phase_flagship(interface):
    import jax
    import bench
    import parapint_tpu as pt
    from parapint_tpu.examples import burgers

    solver = pt.BandedSchurComplementSolver(
        schur_complement_solver=pt.BlockTridiagSolver(ns=interface.ns),
        tile_size=128,
    )
    result, obj, compile_s, wall, footprint = fused_solve(interface, solver, reps=5)
    n_iter = int(result.iterations)
    ips = max(1, n_iter - 1) / wall
    log(
        f"flagship: status=optimal iterations={n_iter} "
        f"warm_iter_per_s={ips} (median of 5 solves: {wall} s) "
        f"compile_s={compile_s} solve_device_bytes={footprint} "
        f"(executable's arguments + outputs + temps) "
        f"process_peak_device_bytes={process_peak_bytes()} (phases a-b and this solve)"
    )
    spec = burgers.build_spec(
        nfe_x=bench.NFE_X, nfe_t=bench.NFE_T, num_time_blocks=bench.N_BLOCKS
    )
    ref_if = pt.DynamicSchurComplementInteriorPointInterface(spec)
    ref, ref_obj, _, _, _ = fused_solve(ref_if, pt.SchurComplementSolver(block_size=128))
    gap = rel_gap(obj, ref_obj)
    log(
        f"flagship objective {obj!r} vs f64 dense {ref_obj!r} "
        f"({int(ref.iterations)} iterations): rel gap {gap:.3e} <= {OBJ_GAP:.0e}"
    )
    assert gap <= OBJ_GAP, gap
    return obj


# ---------------------------------------------------------------- (d)


def phase_stochastic_qp():
    import jax.numpy as jnp
    import bench_all
    import parapint_tpu as pt

    # f64 KKT assembly: the f64 pivot sweep reads exact pivot signs
    interface = bench_all.stochastic_qp(n_scenarios=32, kkt_dtype=None)
    solver = pt.SchurComplementSolver(
        block_size=128,
        explicit_inverse=True,
        factor_dtype=jnp.float64,
        apply_dtype=jnp.float32,
    )
    result, obj, compile_s, wall, _ = fused_solve(interface, solver, reps=1)
    ref_if = bench_all.stochastic_qp(n_scenarios=32, kkt_dtype=None)
    ref, ref_obj, _, _, _ = fused_solve(ref_if, pt.SchurComplementSolver(block_size=128))
    gap = rel_gap(obj, ref_obj)
    log(
        f"stochastic QP (32 scenarios, nk=1024, hybrid f64/f32): status=optimal "
        f"iterations={int(result.iterations)} warm_solve_s={wall} "
        f"compile_s={compile_s} | objective {obj!r} vs f64 dense {ref_obj!r} "
        f"({int(ref.iterations)} iterations): rel gap {gap:.3e} <= {OBJ_GAP:.0e}"
    )
    assert gap <= OBJ_GAP, gap


# ---------------------------------------------------------------- (e)


def phase_entry_and_mesh1(serial_obj):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    import bench
    import parapint_tpu as pt
    import __graft_entry__ as g
    from parapint_tpu.examples import burgers

    fn, args = g.entry()
    out = jax.block_until_ready(jax.jit(fn)(*args))
    leaves = jax.tree_util.tree_leaves(out)
    assert all(bool(jnp.all(jnp.isfinite(x))) for x in leaves)
    log(f"__graft_entry__.entry() step: {len(leaves)} finite output arrays")

    mesh = Mesh(np.array(jax.devices()[:1]), ("blocks",))
    spec = burgers.build_spec(
        nfe_x=bench.NFE_X, nfe_t=bench.NFE_T, num_time_blocks=bench.N_BLOCKS
    )
    interface = pt.DynamicSchurComplementInteriorPointInterface(
        spec, mesh=mesh, kkt_dtype=jnp.float32, block_form="banded"
    )
    solver = pt.ShardedBandedSchurComplementSolver(
        mesh,
        "blocks",
        tile_size=128,
        schur_complement_solver=pt.BlockTridiagSolver(ns=interface.ns),
    )
    result, obj, compile_s, _, _ = fused_solve(interface, solver)
    gap = rel_gap(obj, serial_obj)
    log(
        f"sharded banded flagship on a 1-GPU mesh: status=optimal "
        f"iterations={int(result.iterations)} compile_s={compile_s} | "
        f"objective {obj!r} vs serial {serial_obj!r}: rel gap {gap:.3e} "
        f"<= {OBJ_GAP:.0e}"
    )
    assert gap <= OBJ_GAP, gap


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four-gpus",
        action="store_true",
        help="run only __graft_entry__.dryrun_multichip(4) on 4 GPUs",
    )
    opts = parser.parse_args()

    import jax

    # (a) device check: the GPU or nothing
    backend = jax.default_backend()
    if backend != "gpu":
        log(f"FAIL: no GPU backend (JAX reports {backend!r})")
        sys.exit(1)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from parapint_tpu.utils.launch import device_info, enable_compile_cache

    cache = enable_compile_cache()
    for line in card_lines():
        log(f"card: {line}")
    log(f"devices: {jax.devices()} compile cache: {cache}")

    if opts.four_gpus:
        if len(jax.devices()) < 4:
            log(f"FAIL: --four-gpus needs 4 GPUs, found {len(jax.devices())}")
            sys.exit(1)
        import __graft_entry__ as g

        t0 = time.perf_counter()
        g.dryrun_multichip(4)
        log(f"dryrun_multichip(4) passed in {time.perf_counter() - t0:.1f} s")
    else:
        import bench

        interface = bench.build_problem(block_form="banded")
        t0 = time.perf_counter()
        phase_panels(flagship_tiles(interface))
        log(f"(b) panel kernel passed in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        serial_obj = phase_flagship(interface)
        log(f"(c) flagship passed in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_stochastic_qp()
        log(f"(d) stochastic QP passed in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_entry_and_mesh1(serial_obj)
        log(f"(e) entry step + 1-GPU mesh passed in {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"ok": True, "device": device_info()}), flush=True)


if __name__ == "__main__":
    main()
