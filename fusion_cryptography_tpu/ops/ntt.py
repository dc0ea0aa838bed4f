"""Batched negacyclic NTT / inverse NTT over Z_q as XLA-friendly tensor ops.

Reimplements the transform semantics of the reference's scalar loops
(/root/reference/algebra/ntt.py:216-291 Cooley–Tukey forward, :294-377
Gentleman–Sande inverse) as fully vectorized, statically-shaped stage sweeps:

* the polynomial axis is the trailing axis; a stage with ``m`` blocks of span
  ``2t`` is a reshape to ``(..., m, 2, t)`` followed by lane-wise butterflies —
  no scalar loops, no gathers, so XLA emits plain elementwise code and fuses
  adjacent stages;
* twiddles are powers of the order-2d primitive root stored in bit-reversed
  order (identical table layout to the reference, so the forward output is in
  the same bit-reversed order and NTT-domain values serialize bit-identically:
  output[i] == f(psi**(2*bitrev(i)+1)) mod q, centered);
* twiddle tables and their Shoup companions are precomputed once per
  (modulus, degree, root) plan and closed over by the jitted function — the
  reference rebuilds them per call (algebra/polynomials.py:396-397), one of its
  dominant costs;
* all stage arithmetic runs on uint32 residues with Shoup constant-multiplies
  (see ops/field.py); inputs/outputs of the public wrappers are centered int32.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .field import Field, Q, get_field
from .numtheory import bit_reverse_indices, is_odd_prime, is_primitive_root


@dataclass(frozen=True, eq=False)  # identity hash: plans are interned by make_plan
class NTTPlan:
    """Precomputed twiddle schedule for one (modulus, degree, root) transform."""

    field: Field
    degree: int
    root: int
    inv_root: int
    root_order: int
    # Stages: tuples of (blocks, span, twiddle (blocks,1), twiddle_shoup (blocks,1)).
    fwd_stages: Tuple[Tuple[int, int, np.ndarray, np.ndarray], ...]
    inv_stages: Tuple[Tuple[int, int, np.ndarray, np.ndarray], ...]
    n_inv: int
    n_inv_shoup: int
    # Flat bit-reversed twiddle tables (stage m reads [m:2m]) — the layout the
    # reference uses (algebra/ntt.py:281), consumed by the Pallas kernels.
    brp: np.ndarray = None
    brp_shoup: np.ndarray = None
    brp_inv: np.ndarray = None
    brp_inv_shoup: np.ndarray = None

    @property
    def modulus(self) -> int:
        return self.field.q


@lru_cache(maxsize=None)
def make_plan(modulus: int = Q, degree: int = 256, root: Optional[int] = None) -> NTTPlan:
    """Build (and cache) the stage-sliced twiddle tables for one transform size.

    The table layout matches the reference exactly: ``brp`` is the bit-reversed
    list of the first ``degree`` powers of the order-``2*degree`` root, and the
    stage with ``m`` blocks consumes ``brp[m:2m]`` (algebra/ntt.py:276-290).
    """
    if root is None:
        from .numtheory import find_primitive_root

        root = find_primitive_root(modulus, 2 * degree)
    if not is_odd_prime(modulus):
        raise ValueError(f"modulus={modulus} must be an odd prime")
    root_order = 2 * degree
    if not is_primitive_root(root, modulus, root_order):
        raise ValueError(f"root={root} is not a primitive root of order {root_order}")
    field = get_field(modulus)
    inv_root = pow(root, modulus - 2, modulus)

    idx = bit_reverse_indices(degree)
    powers = [pow(root, i, modulus) for i in range(degree)]
    inv_powers = [pow(inv_root, i, modulus) for i in range(degree)]
    brp = [powers[i] for i in idx]
    brp_inv = [inv_powers[i] for i in idx]

    def stage_arrays(tbl: List[int], lo: int, hi: int):
        s = np.array(tbl[lo:hi], dtype=np.uint32).reshape(-1, 1)
        sh = np.array([field.shoup(x) for x in tbl[lo:hi]], dtype=np.uint32).reshape(-1, 1)
        return s, sh

    fwd = []
    m = 1
    while m < degree:
        fwd.append((m, degree // (2 * m)) + stage_arrays(brp, m, 2 * m))
        m *= 2

    inv = []
    h = degree // 2
    while h >= 1:
        inv.append((h, degree // (2 * h)) + stage_arrays(brp_inv, h, 2 * h))
        h //= 2

    n_inv = pow(degree, modulus - 2, modulus)
    return NTTPlan(
        field=field,
        degree=degree,
        root=root,
        inv_root=inv_root,
        root_order=root_order,
        fwd_stages=tuple(fwd),
        inv_stages=tuple(inv),
        n_inv=n_inv,
        n_inv_shoup=field.shoup(n_inv),
        brp=np.array(brp, dtype=np.uint32),
        brp_shoup=np.array([field.shoup(x) for x in brp], dtype=np.uint32),
        brp_inv=np.array(brp_inv, dtype=np.uint32),
        brp_inv_shoup=np.array([field.shoup(x) for x in brp_inv], dtype=np.uint32),
    )


def ntt_fwd_u(plan: NTTPlan, x):
    """Forward negacyclic NTT on unsigned residues, trailing axis = coefficients
    (standard order in, bit-reversed order out, like algebra/ntt.py:216).

    Consecutive radix-2 stage PAIRS are algebraically fused into one radix-4
    pass: the stage sweeps are HBM-materialization-bound, not multiply-bound
    (u32 multiplies are 16-bit-emulated but still ~6x cheaper than a stage's
    buffer round trip), so halving the number of whole-tensor passes nearly
    halves the transform's wall time.  Butterfly algebra and twiddle order
    are IDENTICAL to the radix-2 sweep — outputs are bit-equal.
    """
    F = plan.field
    shape = x.shape
    lead = shape[:-1]
    stages = plan.fwd_stages
    k = 0
    while k + 1 < len(stages):
        m, t, s, sh = stages[k]
        _, t2, s2, sh2 = stages[k + 1]  # 2m blocks, t/2 span
        x = x.reshape(lead + (m, 2, 2, t2))  # [j, uv_k, pair_k1, t2]
        u0, u1 = x[..., 0, 0, :], x[..., 0, 1, :]
        v0, v1 = x[..., 1, 0, :], x[..., 1, 1, :]
        sj, shj = jnp.asarray(s), jnp.asarray(sh)  # [m, 1]
        m0 = F.mul_mod_shoup(v0, sj, shj)
        m1 = F.mul_mod_shoup(v1, sj, shj)
        y00, y01 = F.add_mod(u0, m0), F.add_mod(u1, m1)
        y10, y11 = F.sub_mod(u0, m0), F.sub_mod(u1, m1)
        sA, shA = jnp.asarray(s2[0::2]), jnp.asarray(sh2[0::2])  # block 2j
        sB, shB = jnp.asarray(s2[1::2]), jnp.asarray(sh2[1::2])  # block 2j+1
        t0 = F.mul_mod_shoup(y01, sA, shA)
        t1 = F.mul_mod_shoup(y11, sB, shB)
        z = jnp.stack(
            [
                jnp.stack([F.add_mod(y00, t0), F.sub_mod(y00, t0)], axis=-2),
                jnp.stack([F.add_mod(y10, t1), F.sub_mod(y10, t1)], axis=-2),
            ],
            axis=-3,
        )  # [j, pair_k1, uv_k1, t2]
        x = z
        k += 2
    if k < len(stages):
        m, t, s, sh = stages[k]
        x = x.reshape(lead + (m, 2, t))
        u = x[..., 0, :]
        v = F.mul_mod_shoup(x[..., 1, :], jnp.asarray(s), jnp.asarray(sh))
        x = jnp.stack([F.add_mod(u, v), F.sub_mod(u, v)], axis=-2)
    return x.reshape(shape)


def ntt_inv_u(plan: NTTPlan, x):
    """Inverse negacyclic NTT on unsigned residues (bit-reversed order in,
    standard order out, with the final n^-1 scale, like algebra/ntt.py:294).
    Radix-4 fused stage pairs — see :func:`ntt_fwd_u`."""
    F = plan.field
    shape = x.shape
    lead = shape[:-1]
    stages = plan.inv_stages
    k = 0
    while k + 1 < len(stages):
        h, t, s, sh = stages[k]
        h2, t2, s2, sh2 = stages[k + 1]  # h/2 blocks, 2t span
        x = x.reshape(lead + (h2, 2, 2, t))  # [jB, p(block 2jB+p), uv_k, t]
        a, b = x[..., 0, 0, :], x[..., 0, 1, :]
        c, e = x[..., 1, 0, :], x[..., 1, 1, :]
        s0, sh0 = jnp.asarray(s[0::2]), jnp.asarray(sh[0::2])  # block 2jB
        s1, sh1 = jnp.asarray(s[1::2]), jnp.asarray(sh[1::2])  # block 2jB+1
        y00 = F.add_mod(a, b)
        y01 = F.mul_mod_shoup(F.sub_mod(a, b), s0, sh0)
        y10 = F.add_mod(c, e)
        y11 = F.mul_mod_shoup(F.sub_mod(c, e), s1, sh1)
        sB, shB = jnp.asarray(s2), jnp.asarray(sh2)  # [h2, 1]
        z = jnp.stack(
            [
                jnp.stack([F.add_mod(y00, y10), F.add_mod(y01, y11)], axis=-2),
                jnp.stack(
                    [
                        F.mul_mod_shoup(F.sub_mod(y00, y10), sB, shB),
                        F.mul_mod_shoup(F.sub_mod(y01, y11), sB, shB),
                    ],
                    axis=-2,
                ),
            ],
            axis=-3,
        )  # [jB, uv_k1, p, t]
        x = z
        k += 2
    if k < len(stages):
        h, t, s, sh = stages[k]
        x = x.reshape(lead + (h, 2, t))
        u = x[..., 0, :]
        v = x[..., 1, :]
        x = jnp.stack(
            [F.add_mod(u, v), F.mul_mod_shoup(F.sub_mod(u, v), jnp.asarray(s), jnp.asarray(sh))],
            axis=-2,
        )
    x = x.reshape(shape)
    return F.mul_mod_shoup(
        x, jnp.asarray(np.uint32(plan.n_inv)), jnp.asarray(np.uint32(plan.n_inv_shoup))
    )


# ---------------------------------------------------------------------------
# Dense inverse transform: exact bf16 limb matmuls
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _intt_mxu_tables(plan: NTTPlan):
    """Inverse-transform matrix as bf16 limb planes for one matmul.

    coef[j] = sum_i W[j, i] * ntt[i] mod q with
    W[j, i] = d^-1 * inv_psi^((2*bitrev(i)+1) * j) — the dense form of the
    Gentleman-Sande INTT including its final n^-1 scale (reference
    /root/reference/algebra/ntt.py:294-377 semantics, bit-reversed input
    order).  Each input limb b gets its own PRE-FOLDED matrix
    W_b = W * 2^(8b) mod q, split into four 8-bit limb planes a, so the
    device-side fold is only sum_a 2^(8a) * P_a mod q — 4 modular
    constant-multiplies per element instead of one per (a, b) pair.

    Exactness: bf16 holds integers < 2^8 exactly; each product is a full
    f32 (<= 16-bit) value and the f32 accumulation of d <= 256 terms stays
    below 2^24, so every partial sum is an exact integer.
    """
    q, d = plan.modulus, plan.degree
    if d > 256:
        raise NotImplementedError(
            "bf16 limb accumulation needs d * 255^2 < 2^24 (d <= 256)"
        )
    idx = bit_reverse_indices(d)
    inv_psi = plan.inv_root
    d_inv = pow(d, q - 2, q)
    W = np.empty((d, d), dtype=np.uint64)
    for i in range(d):
        e = 2 * int(idx[i]) + 1
        inv_base = pow(inv_psi, e, q)
        col = d_inv
        for j in range(d):
            W[j, i] = col
            col = col * inv_base % q
    planes = np.empty((4, 4, d, d), dtype=np.float32)  # [a, b, j, i]
    for b in range(4):
        Wb = (W * pow(2, 8 * b, q)) % q
        for a in range(4):
            planes[a, b] = ((Wb >> (8 * a)) & 0xFF).astype(np.float32)
    F = plan.field
    fold = np.array([pow(2, 8 * a, q) for a in range(4)], dtype=np.uint32)
    fold_sh = np.array([F.shoup(int(c)) for c in fold], dtype=np.uint32)
    import ml_dtypes

    # Single-dot layout: limbs ride the CONTRACTION axis (X [M, 4d] bf16
    # against W_cat [4d_in, 4d_out]), so the limb planes feed one matmul and
    # are materialized once, not 16 times.
    # W_cat[(b*d + i), (a*d + j)] = limb a of (W[j, i] * 2^(8b) mod q)
    Wcat = np.empty((4 * d, 4 * d), dtype=np.float32)
    for b in range(4):
        for a in range(4):
            Wcat[b * d : (b + 1) * d, a * d : (a + 1) * d] = planes[a, b].T
    # numpy bf16 (ml_dtypes): converting INSIDE a trace would cache tracers
    return Wcat.astype(ml_dtypes.bfloat16), fold, fold_sh


def ntt_inv_u_mxu(plan: NTTPlan, x):
    """Dense inverse negacyclic NTT on unsigned residues — bit-exact twin of
    :func:`ntt_inv_u` computed as one exact bf16 limb matmul + a 4-term
    modular fold.

    Off the production path (the lattice stage uses the :func:`ntt_inv_u`
    stage sweep); kept as the exact dense form a tensor-core INTT would start
    from.  The products are exact only with f32 accumulation at full
    precision, so the dot pins both: a GPU backend may otherwise pick a
    reduced-precision algorithm."""
    F = plan.field
    d = plan.degree
    Wcat, fold, fold_sh = _intt_mxu_tables(plan)
    shape = x.shape
    xm = x.reshape(-1, d)
    # limbs along the contraction axis: X [M, 4d] bf16, one dot, one output
    xl = jnp.concatenate(
        [((xm >> np.uint32(8 * b)) & np.uint32(0xFF)).astype(jnp.bfloat16)
         for b in range(4)],
        axis=1,
    )
    t = jax.lax.dot_general(
        xl, jnp.asarray(Wcat), (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # [M, 4d]: column block a = P_a, exact integer f32 (< 4 * 2^24)
    acc = None
    for a in range(4):
        p_u = t[:, a * d : (a + 1) * d].astype(jnp.uint32)
        term = F.mul_mod_shoup(
            p_u, jnp.asarray(np.uint32(fold[a])), jnp.asarray(np.uint32(fold_sh[a]))
        )
        acc = term if acc is None else F.add_mod(acc, term)
    return acc.reshape(shape)


@lru_cache(maxsize=None)
def _jitted(plan: NTTPlan):
    """Per-plan jitted entry points (plans are interned, so this caches one
    compiled executable per transform size per input shape)."""
    import jax

    F = plan.field

    def fwd(x):
        return F.to_centered(ntt_fwd_u(plan, F.to_unsigned(x)))

    def inv(x):
        return F.to_centered(ntt_inv_u(plan, F.to_unsigned(x)))

    def polymul(f, g):
        fu = ntt_fwd_u(plan, F.to_unsigned(f))
        gu = ntt_fwd_u(plan, F.to_unsigned(g))
        prod = F.mont_mul(F.to_mont(fu), gu)
        return F.to_centered(ntt_inv_u(plan, prod))

    return jax.jit(fwd), jax.jit(inv), jax.jit(polymul)


def ntt_fwd(plan: NTTPlan, x):
    """Centered int32 coefficients -> centered int32 NTT values (bit-rev order)."""
    return _jitted(plan)[0](x)


def ntt_inv(plan: NTTPlan, x):
    """Centered int32 NTT values (bit-rev order) -> centered int32 coefficients."""
    return _jitted(plan)[1](x)


def negacyclic_poly_mult(plan: NTTPlan, f, g):
    """INTT(NTT(f) ⊙ NTT(g)) — one-shot negacyclic product of coefficient-domain
    polynomials on the trailing axis (the working part of algebra/ntt.py:380-484,
    without its side effect of INTT-ing the inputs in place)."""
    return _jitted(plan)[2](f, g)
