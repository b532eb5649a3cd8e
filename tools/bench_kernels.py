"""Per-call times of the panel LDL^T step and the batched W-apply.

    python tools/bench_kernels.py [--reps N]

Panel step at the shapes the solvers run: (64, 64, 64) and (64, 128, 128)
f32 (the flagship's banded tiles and the dense path's panels), (64, 64, 64)
f64 and (32, 128, 128) f64 (the stochastic QP's hybrid pivot sweep).  Each
shape is timed as the Triton kernel (factor only, factor + in-kernel W,
factor + batched ``unit_lower_inv``) and as the XLA slab loop (factor
only, factor + ``unit_lower_inv``).  Also times the XLA two-GEMV W-apply at
(64, 1024, 1024) f32.  Each time is the median of ``--reps`` calls, each
ended by ``jax.block_until_ready``.  Prints one JSON line per measurement
with the device, and the card's name and power limit first.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def median_time(f, *a, reps):
    import jax

    jax.block_until_ready(f(*a))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*a))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    reps = ap.parse_args().reps

    import jax
    import jax.numpy as jnp
    from parapint_tpu.linalg.schur import _winv_apply_batched
    from parapint_tpu.ops import ldl, pallas_ldl
    from parapint_tpu.utils.launch import device_info, enable_compile_cache, require_gpu

    enable_compile_cache()
    backend = require_gpu()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip() if backend == "gpu" else "none"
    print(f"card: {card}", flush=True)
    dev = device_info()

    def emit(**kw):
        print(json.dumps({**kw, "device": dev}), flush=True)

    def with_inv(F):
        b = F.shape[-1]
        return F, ldl.unit_lower_inv(jnp.tril(F, -1) + jnp.eye(b, dtype=F.dtype))

    failed = []
    rng = np.random.default_rng(0)
    shapes = (
        (64, 64, jnp.float32),
        (64, 128, jnp.float32),
        (64, 64, jnp.float64),
        (32, 128, jnp.float64),
    )
    for B, b, dt in shapes:
        M = rng.standard_normal((B, b, b))
        A = jnp.asarray(M @ M.transpose(0, 2, 1) / b + np.eye(b), dt)
        shape = f"({B},{b},{b}) {jnp.dtype(dt).name}"
        variants = {
            "xla_slab": jax.jit(ldl._ldl_slab_batched_xla),
            "xla_slab+inv": jax.jit(lambda a: with_inv(ldl._ldl_slab_batched_xla(a))),
        }
        if backend == "gpu":
            variants["triton"] = jax.jit(pallas_ldl.ldl_panels)
            variants["triton+W"] = jax.jit(
                lambda a: pallas_ldl.ldl_panels(a, with_w=True)
            )
            variants["triton+inv"] = jax.jit(
                lambda a: with_inv(pallas_ldl.ldl_panels(a))
            )
        for name, f in variants.items():
            try:
                t = median_time(f, A, reps=reps)
            except Exception as e:  # report every variant, fail at the end
                failed.append(f"{shape} {name}")
                emit(op="panel_ldl", shape=shape, variant=name, error=str(e)[:2000])
                continue
            emit(op="panel_ldl", shape=shape, variant=name, median_s=t, reps=reps)

    B, n = 64, 1024
    W = jnp.asarray(rng.standard_normal((B, n, n)) / np.sqrt(n), jnp.float32)
    d = jnp.asarray(rng.uniform(0.5, 2.0, (B, n)), jnp.float32)
    s = jnp.ones((B, n), jnp.float32)
    rhs = jnp.asarray(rng.standard_normal((B, n)), jnp.float32)
    t = median_time(jax.jit(_winv_apply_batched), W, d, s, rhs, reps=reps)
    emit(op="winv_apply", shape=f"({B},{n},{n}) float32", variant="xla_two_gemv",
         median_s=t, reps=reps, w_bytes=W.nbytes)
    if failed:
        sys.exit(f"failed: {failed}")


if __name__ == "__main__":
    main()
