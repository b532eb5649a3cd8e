"""Pallas (Triton) kernel for the batched LDL^T panel factorization.

The blocked LDL^T (ops/ldl.py) reduces to a chain of ``b`` dependent
rank-1 updates on each small (b, b) diagonal panel.  In plain XLA every
step of that chain is a separate kernel launch and the working batch
round-trips device memory between steps.  Here one Triton program owns
one panel: the panel is loaded once into registers, all ``b`` steps run
on chip inside a ``fori_loop``, and the packed factor is written once.

Contract (identical to :func:`parapint_tpu.ops.ldl._ldl_unblocked`): the
strict lower triangle of the output holds the unit-lower L, the diagonal
holds D, the strict upper triangle is unspecified.  The factor is derived
from the pivot COLUMNS only (the lower triangle), so a trailing block that
is symmetric only up to roundoff gives the same factor as the reference.

Register tiles cannot be indexed dynamically, so column ``j`` is taken by a
masked reduction over the lane axis.  After step ``j`` nothing touches
column ``j`` again, so the raw pivot column stays in place and the
division by the pivot happens once, after the loop.  Optionally the kernel
also accumulates W = L^{-1} as the product of the elementary Gauss
transforms (one extra rank-1 per step on a second register tile).
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# widest panel the kernel takes (one register tile of 128 x 128)
MAX_WIDTH = 128
_DTYPES = (jnp.dtype(jnp.float32), jnp.dtype(jnp.float64))
# widest panel the GPU dispatch sends to the kernel, per dtype.  f64 panels
# wider than 64 spill registers: on the H100 the stochastic QP's f64
# 128-wide pivot sweep ran its solve 1.44x faster on the XLA slab loop,
# with equal compile time (PERF.md).
_DISPATCH_WIDTH = {jnp.dtype(jnp.float32): 128, jnp.dtype(jnp.float64): 64}
# W = L^{-1} accumulates in the kernel up to this width.  At 128 the
# factor-only kernel plus one batched triangular solve ran the dense
# explicit-inverse solve 1.3x faster; at 64 the in-kernel W ran the banded
# flagship 4 % faster (H100, PERF.md).
_W_IN_KERNEL_WIDTH = 64


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def supported(b: int, dtype) -> bool:
    """Whether the kernel can factor a (., b, b) panel batch of ``dtype``."""
    return jnp.dtype(dtype) in _DTYPES and 1 <= b <= MAX_WIDTH


def use_kernel(b: int, dtype) -> bool:
    """Dispatch rule: the GPU backend takes the kernel for f32 panels up to
    128 wide and f64 panels up to 64 wide (odd widths padded to a power of
    two); other backends, dtypes and widths run the XLA loop."""
    return (
        jax.default_backend() == "gpu"
        and supported(b, dtype)
        and _next_pow2(b) <= _DISPATCH_WIDTH[jnp.dtype(dtype)]
    )


def w_in_kernel(b: int) -> bool:
    """Whether the panel step takes W from the kernel (else it inverts the
    kernel's unit-lower factor by a triangular solve)."""
    return _next_pow2(b) <= _W_IN_KERNEL_WIDTH


def _num_warps(b: int) -> int:
    # fastest measured on the H100 (PERF.md)
    return 4 if b <= 64 else 8


def _panel_kernel(a_ref, f_ref, *w_refs, b: int):
    dt = a_ref.dtype
    zero = jnp.zeros((), dt)
    one = jnp.ones((), dt)
    rows = lax.broadcasted_iota(jnp.int32, (b, b), 0)
    cols = lax.broadcasted_iota(jnp.int32, (b, b), 1)
    ridx = lax.broadcasted_iota(jnp.int32, (b,), 0)

    def step(j, carry):
        A, W = carry
        col = jnp.sum(jnp.where(cols == j, A, zero), axis=1)  # A[:, j]
        piv = jnp.sum(jnp.where(ridx == j, col, zero))
        piv = jnp.where(jnp.abs(piv) > 0, piv, one)
        x = jnp.where(ridx > j, col, zero)  # raw column below the pivot
        l = x / piv
        # trailing rank-1: A[i, k] -= l_i * A[k, j] for i, k > j
        A = A - l[:, None] * x[None, :]
        if W is not None:
            # W <- (I - l e_j^T) W: row j of W is final at step j
            wrow = jnp.sum(jnp.where(rows == j, W, zero), axis=0)
            W = W - l[:, None] * wrow[None, :]
        return A, W

    A = a_ref[...]
    W = jnp.where(rows == cols, one, zero) if w_refs else None
    A, W = lax.fori_loop(jnp.int32(0), jnp.int32(b), step, (A, W))
    # column j still holds the raw pivot column of step j: pack L = col / d
    d = jnp.sum(jnp.where(rows == cols, A, zero), axis=0)
    d = jnp.where(jnp.abs(d) > 0, d, one)
    f_ref[...] = jnp.where(rows > cols, A / d[None, :], A)
    if w_refs:
        w_refs[0][...] = W


@functools.partial(jax.jit, static_argnames=("with_w", "interpret"))
def ldl_panels(A: jax.Array, with_w: bool = False, interpret: bool = False):
    """Factor a batch of symmetric panels: (B, b, b) -> packed (B, b, b),
    plus W = L^{-1} (B, b, b) when ``with_w``.

    One program per panel.  Widths that are not a power of two are padded
    with decoupled identity rows (unit pivots) and sliced back.
    """
    B, b, b2 = A.shape
    assert b == b2 and supported(b, A.dtype), (A.shape, A.dtype)
    bp = _next_pow2(b)
    if bp != b:
        ids = jnp.arange(bp)
        pad_eye = ((ids[:, None] == ids[None, :]) & (ids[:, None] >= b)).astype(
            A.dtype
        )
        A = jnp.pad(A, ((0, 0), (0, bp - b), (0, bp - b))) + pad_eye
    spec = pl.BlockSpec((None, bp, bp), lambda i: (i, 0, 0))
    shape = jax.ShapeDtypeStruct((B, bp, bp), A.dtype)
    out = pl.pallas_call(
        functools.partial(_panel_kernel, b=bp),
        out_shape=(shape, shape) if with_w else shape,
        grid=(B,),
        in_specs=[spec],
        out_specs=(spec, spec) if with_w else spec,
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=_num_warps(bp), num_stages=1
        ),
        interpret=interpret,
        name="ldl_panel",
    )(A)
    if with_w:
        F, W = out
        return F[:, :b, :b], W[:, :b, :b]
    return out[:, :b, :b]
