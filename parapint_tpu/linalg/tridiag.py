"""Block-tridiagonal solver via cyclic reduction — the chain-topology
Schur-complement coupling solver.

For dynamic (time-chain) problems the Schur complement S is block
*tridiagonal* with ns x ns tiles (ns = number of coupled states, one tile
group per block boundary): block i couples only boundaries i-1 and i.  The
reference factorizes S as a generic sparse matrix, redundantly on every rank
(/root/reference/parapint/linalg/schur_complement/mpi_explicit_schur_complement.py:352-360);
a dense factorization is — O(nc^3) flops replicated per
shard, the dominant cost beyond ~64 blocks.  This module replaces that with
block cyclic reduction:

- Eliminating the even-indexed tiles of a block-tridiagonal matrix leaves a
  block-tridiagonal matrix on the odd tiles (the evens are mutually
  decoupled), so log2(m) *batched* elimination levels reduce m tiles to one.
  Each level is a handful of batched ns x ns matmuls + one batched LDL^T —
  exactly the shape of work batched hardware wants, with no O(m)-length sequential
  chain (a block-Thomas sweep would serialize m tiny factorizations).
- Total cost O(m * ns^3) versus dense O((m*ns)^3): at 256 time blocks with
  ns ~ 49 this is a ~65000x flop reduction of the coupling factorization.
- Inertia is EXACT: by Haynsworth's inertia additivity, inertia(S) equals
  the sum of the inertias of every eliminated diagonal tile across all
  levels (each level's Schur complement carries the remainder), so the IP
  inertia-correction contract is identical to the dense factorization's.
- In tile form the cross-shard reduction of the SC costs O(m * ns^2)
  instead of the dense O((m*ns)^2) — the psum payload shrinks by ~m.

Everything is shape-static: m is padded to 2^k - 1 with masked identity
tiles (zero coupling), which factor trivially, never interact with real
tiles, and are excluded from the inertia.
"""

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from parapint_tpu.linalg.base import LinearSolver
from parapint_tpu.linalg.results import LinearSolverResults, LinearSolverStatus
from parapint_tpu.linalg.schur import _factor_blocks_winv


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockTridiag:
    """Symmetric block-tridiagonal matrix in tile form.

    diag:  (m, ns, ns) diagonal tiles T_i
    upper: (m-1, ns, ns) superdiagonal tiles U_i = S[i, i+1]; the
           subdiagonal is U_i^T by symmetry.
    """

    diag: jax.Array
    upper: jax.Array

    @property
    def m(self) -> int:
        return self.diag.shape[0]

    @property
    def ns(self) -> int:
        return self.diag.shape[-1]

    def todense(self) -> jax.Array:
        m, ns = self.m, self.ns
        eye = jnp.eye(m, dtype=self.diag.dtype)
        up = jnp.eye(m, k=1, dtype=self.diag.dtype)
        upper = jnp.concatenate(
            [self.upper, jnp.zeros((1, ns, ns), dtype=self.diag.dtype)], axis=0
        )
        Sd = jnp.einsum("gij,gh->gihj", self.diag, eye)
        Su = jnp.einsum("gij,gh->gihj", upper, up)
        S = (Sd + Su).reshape(m * ns, m * ns)
        return S + Su.reshape(m * ns, m * ns).T


def extract_tridiag(S: jax.Array, ns: int) -> BlockTridiag:
    """Tile view of a dense block-tridiagonal matrix (out-of-band entries,
    which are structurally zero for chain topologies, are ignored)."""
    nc = S.shape[-1]
    if nc % ns != 0:
        raise ValueError(f"matrix dim {nc} not a multiple of tile size {ns}")
    m = nc // ns
    q = S.reshape(m, ns, m, ns)
    idx = jnp.arange(m)
    diag = q[idx, :, idx, :]
    upper = q[idx[:-1], :, idx[:-1] + 1, :] if m > 1 else jnp.zeros(
        (0, ns, ns), dtype=S.dtype
    )
    return BlockTridiag(diag=diag, upper=upper)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CRFactor:
    """Cyclic-reduction factorization.

    Per level l (m_l tiles): ``tinv[l]`` holds the explicit inverses of the
    eliminated (even-index) tiles, ``ue[l]``/``uo[l]`` the even/odd-index
    superdiagonal tiles used by the level's elimination.  Tuple lengths and
    all shapes are static (m padded to 2^k - 1).
    """

    tinv: tuple  # per level: (E_l, ns, ns)
    ue: tuple  # per level: (K_l, ns, ns)
    uo: tuple  # per level: (K_l, ns, ns)
    inertia: jax.Array  # (3,) int32
    status: jax.Array  # () int32
    m: int = dataclasses.field(metadata=dict(static=True))
    ns: int = dataclasses.field(metadata=dict(static=True))


def _next_pow2m1(m: int) -> int:
    k = 1
    while (1 << k) - 1 < m:
        k += 1
    return (1 << k) - 1


def _winv_to_inverse(W, d, s, ns: int):
    """Explicit K^{-1} = s W^T D^{-1} W s for a batch of tiles (W may carry
    LDL padding beyond ns; padded rows are identity and are sliced off)."""
    d_safe = jnp.where(jnp.abs(d) > 0, d, 1.0)
    Minv = jnp.einsum(
        "bji,bjk->bik", W, W / d_safe[:, :, None], preferred_element_type=W.dtype
    )
    Minv = Minv[:, :ns, :ns]
    return Minv * s[:, :, None] * s[:, None, :]


def cr_factor(
    tri: BlockTridiag,
    block_size: int = 64,
    zero_tol: float = 0.0,
    factor_dtype=None,
) -> CRFactor:
    """Factor a symmetric block-tridiagonal matrix by cyclic reduction."""
    m, ns = tri.m, tri.ns
    M = _next_pow2m1(m)
    diag = tri.diag
    upper = tri.upper
    dt = diag.dtype
    mask = jnp.ones(m, dtype=dt)
    if M != m:
        pad = M - m
        eye = jnp.broadcast_to(jnp.eye(ns, dtype=dt), (pad, ns, ns))
        diag = jnp.concatenate([diag, eye], axis=0)
        mask = jnp.concatenate([mask, jnp.zeros(pad, dtype=dt)])
    if upper.shape[0] != M - 1:
        upper = jnp.concatenate(
            [
                upper,
                jnp.zeros((M - 1 - upper.shape[0], ns, ns), dtype=dt),
            ],
            axis=0,
        )

    tinvs, ues, uos = [], [], []
    inertia = jnp.zeros(3, dtype=jnp.int32)
    status = jnp.int32(LinearSolverStatus.successful)
    while True:
        E = (M + 1) // 2
        K = (M - 1) // 2
        Te = diag[0::2]  # (E, ns, ns) tiles to eliminate (mutually decoupled)
        W, d, s, lvl_inertia, lvl_status = _factor_blocks_winv(
            Te, mask[0::2], block_size, zero_tol, factor_dtype
        )
        tinv = _winv_to_inverse(W, d, s, ns).astype(dt)
        inertia = inertia + lvl_inertia
        status = jnp.maximum(status, lvl_status)
        if K == 0:
            tinvs.append(tinv)
            empty = jnp.zeros((0, ns, ns), dtype=dt)
            ues.append(empty)
            uos.append(empty)
            break
        Ue = upper[0::2]  # (K,...) U_{2p}:   couples (2p,   2p+1)
        Uo = upper[1::2]  # (K,...) U_{2p+1}: couples (2p+1, 2p+2)
        tinvs.append(tinv)
        ues.append(Ue)
        uos.append(Uo)
        # kept tile p (global 2p+1) absorbs both eliminated neighbors:
        #   T'_p = T_{2p+1} - Ue_p^T Tinv_{2p} Ue_p - Uo_p Tinv_{2p+2} Uo_p^T
        tl = jnp.einsum(
            "kij,kil,klh->kjh", Ue, tinv[:K], Ue, preferred_element_type=dt
        )
        tr = jnp.einsum(
            "kij,kjl,khl->kih", Uo, tinv[1:], Uo, preferred_element_type=dt
        )
        diag = diag[1::2] - tl - tr
        # new coupling between kept p and kept p+1 via eliminated 2p+2:
        #   U'_p = -Uo_p Tinv_{2p+2} Ue_{p+1}
        upper = -jnp.einsum(
            "kij,kjl,klh->kih",
            Uo[: K - 1],
            tinv[1:K],
            Ue[1:],
            preferred_element_type=dt,
        )
        mask = mask[1::2]
        M = K
    return CRFactor(
        tinv=tuple(tinvs),
        ue=tuple(ues),
        uo=tuple(uos),
        inertia=inertia,
        status=status,
        m=m,
        ns=ns,
    )


def cr_solve(fact: CRFactor, r: jax.Array) -> jax.Array:
    """Solve S x = r given a cyclic-reduction factorization.

    r: (nc,) with nc = m*ns (or (m, ns)); returns the same shape.
    """
    ns = fact.ns
    flat = r.ndim == 1
    r = r.reshape(-1, ns)
    m = r.shape[0]
    M = _next_pow2m1(m)
    if M != m:
        r = jnp.concatenate([r, jnp.zeros((M - m, ns), dtype=r.dtype)], axis=0)

    # All per-level contractions below are explicit batched GEMMs, not
    # einsum vector forms (see _border_apply_chain in linalg/schur.py).
    def _mv(A, v):  # (k, ns, ns) @ (k, ns) -> (k, ns)
        return jnp.matmul(
            A.astype(v.dtype), v[:, :, None], preferred_element_type=v.dtype
        )[..., 0]

    def _mtv(A, v):  # (k, ns, ns)^T @ (k, ns) -> (k, ns)
        return jnp.matmul(
            v[:, None, :], A.astype(v.dtype), preferred_element_type=v.dtype
        )[:, 0, :]

    # forward sweep: fold eliminated tiles into the kept rhs
    zs = []
    for lvl in range(len(fact.tinv) - 1):
        tinv, Ue, Uo = fact.tinv[lvl], fact.ue[lvl], fact.uo[lvl]
        K = Ue.shape[0]
        re = r[0::2]
        ro = r[1::2]
        z = _mv(tinv, re)
        zs.append(z)
        r = ro - _mtv(Ue, z[:K]) - _mv(Uo, z[1:])
    # deepest level: single tile
    x = _mv(fact.tinv[-1], r)
    # back-substitution: recover the eliminated tiles level by level
    for lvl in range(len(fact.tinv) - 2, -1, -1):
        tinv, Ue, Uo = fact.tinv[lvl], fact.ue[lvl], fact.uo[lvl]
        K = Ue.shape[0]
        E = K + 1
        xk = x  # (K, ns) kept solution
        z = zs[lvl]
        zero = jnp.zeros((1, ns), dtype=xk.dtype)
        xk_pad = jnp.concatenate([zero, xk, zero], axis=0)  # (K+2, ns)
        zt = jnp.zeros((1, ns, ns), dtype=Uo.dtype)
        uo_shift = jnp.concatenate([zt, Uo], axis=0)  # (E,...) U_{2p-1}
        ue_ext = jnp.concatenate([Ue, zt], axis=0)  # (E,...) U_{2p}
        # x_e[p] = Tinv_{2p} (r_e[p] - U_{2p-1}^T x_kept[p-1] - U_{2p} x_kept[p])
        corr = _mtv(uo_shift, xk_pad[:E]) + _mv(ue_ext, xk_pad[1 : E + 1])
        xe = z - _mv(tinv, corr)
        # interleave [xe_0, xk_0, xe_1, xk_1, ..., xe_K]: strided .at[::2]
        # scatters; a stack+reshape is pure data movement
        xk_ext = jnp.concatenate([xk, jnp.zeros((1, ns), dtype=xk.dtype)])
        x = jnp.stack([xe, xk_ext], axis=1).reshape(-1, ns)[: 2 * K + 1]
    x = x[:m]
    return x.reshape(-1) if flat else x


class BlockTridiagSolver(LinearSolver):
    """LinearSolver over block-tridiagonal systems (cyclic reduction).

    ``numeric`` accepts a :class:`BlockTridiag` directly (the Schur
    solvers' chain path hands tiles over without ever densifying) or a
    dense array, from which the tridiagonal band is extracted using the
    constructor's ``ns``.
    """

    def __init__(
        self,
        ns: Optional[int] = None,
        block_size: int = 64,
        zero_tol: float = 0.0,
        factor_dtype=None,
    ):
        self.ns = ns
        self.block_size = block_size
        self.zero_tol = zero_tol
        self.factor_dtype = factor_dtype

    def _as_tridiag(self, sc) -> BlockTridiag:
        if isinstance(sc, BlockTridiag):
            return sc
        if self.ns is None:
            raise ValueError(
                "BlockTridiagSolver needs ns= to interpret a dense matrix"
            )
        return extract_tridiag(sc, self.ns)

    def symbolic(self, sc) -> LinearSolverResults:
        self._as_tridiag(sc)
        return LinearSolverResults(status=LinearSolverStatus.successful)

    def numeric(self, sc) -> CRFactor:
        tri = self._as_tridiag(sc)
        return cr_factor(
            tri,
            block_size=self.block_size,
            zero_tol=self.zero_tol,
            factor_dtype=self.factor_dtype,
        )

    def fact_struct(self, m: int, ns: int, dtype):
        """Abstract factorization pytree (for shard_map out_specs)."""
        tri = BlockTridiag(
            diag=jax.ShapeDtypeStruct((m, ns, ns), dtype),
            upper=jax.ShapeDtypeStruct((max(m - 1, 0), ns, ns), dtype),
        )
        return jax.eval_shape(self.numeric, tri)

    def solve(self, fact: CRFactor, rhs: jax.Array) -> jax.Array:
        return cr_solve(fact, rhs)

    def inertia(self, fact: CRFactor):
        return fact.inertia[0], fact.inertia[1], fact.inertia[2]

    def status(self, fact: CRFactor) -> jax.Array:
        return fact.status
