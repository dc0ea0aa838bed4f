"""Modular arithmetic for prime fields Z_q (q < 2**31 odd prime) on uint32.

The reference implementation (/root/reference/algebra/ntt.py:93, ``cent``) does all
field arithmetic on arbitrary-precision CPython ints.  This module implements the
field directly on ``uint32`` elements, with no 64-bit integer type anywhere:

* values are carried as *unsigned residues* in ``[0, q)`` inside kernels,
* the public/serialized representation is the *centered representative* in
  ``[-(q//2), q//2]`` exactly as produced by the reference's ``cent`` (a residue
  has a unique centered representative, so any op sequence that preserves residues
  and centers at the end is bit-identical to the reference),
* products use 16x16-bit limb decomposition (exact 32x32->64 widening multiply
  built from four 32-bit multiplies), reduced with either
  - Montgomery reduction (R = 2**32) for value*value products, or
  - Shoup multiplication for value*constant products (NTT twiddles), and
* long modular sums use 16-bit limb accumulators in int32 so thousands of terms
  can be added before a single fold-and-reduce.

A :class:`Field` instance bundles the per-modulus constants; ``FUSION_FIELD`` is
the production instance for the Fusion prime q = 2147465729 (fusion/fusion.py:17),
and the module-level functions are bound to it for convenience.  Everything is
shape-polymorphic, jit-friendly, and branch-free (data-dependent selects only);
no ``jax_enable_x64`` required on any backend.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
_I32 = jnp.int32
_MASK16 = np.uint32(0xFFFF)

# The Fusion prime: q - 1 = 2**9 * 4194269, so Z_q has roots of unity of order 512,
# enough for the degree-256 negacyclic NTT (reference fusion/fusion.py:17).
Q: int = 2147465729
HALF_Q: int = Q // 2


def widening_mul(a, b) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact 32x32 -> 64-bit product of uint32 tensors as a (hi, lo) uint32 pair.

    Built from four 16x16-bit partial products; each partial fits uint32 exactly
    because (2**16 - 1)**2 < 2**32.  Modulus-independent.
    """
    a0 = a & _MASK16
    a1 = a >> 16
    b0 = b & _MASK16
    b1 = b >> 16
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = lh + hl  # may wrap once
    mid_carry = (mid < lh).astype(_U32)  # contributes 2**32 -> 2**16 in hi
    lo = ll + (mid << 16)
    lo_carry = (lo < ll).astype(_U32)
    hi = hh + (mid >> 16) + (mid_carry << 16) + lo_carry
    return hi, lo


@dataclass(frozen=True)
class Field:
    """Constants and primitive ops for one odd prime modulus q < 2**31."""

    q: int

    def __post_init__(self):
        if not (3 <= self.q < (1 << 31)) or self.q % 2 == 0:
            raise ValueError(f"modulus must be an odd prime below 2**31, got {self.q}")

    # ---- host-side derived constants -------------------------------------
    @property
    def half(self) -> int:
        return self.q // 2

    @property
    def r_mod_q(self) -> int:
        return (1 << 32) % self.q

    @property
    def r2_mod_q(self) -> int:
        return (1 << 64) % self.q

    @property
    def neg_q_inv(self) -> int:
        return (-pow(self.q, -1, 1 << 32)) % (1 << 32)

    def shoup(self, s: int) -> int:
        """floor(s * 2**32 / q): the Shoup companion word for constant ``s``
        (Harvey's variant of the Longa–Naehrig butterflies the reference cites
        at algebra/ntt.py:224-227)."""
        return (s << 32) // self.q

    # cached numpy scalars for kernel capture
    @property
    def _qu(self):
        return np.uint32(self.q)

    @property
    def _halfu(self):
        return np.uint32(self.half)

    # ---- representation changes ------------------------------------------
    def to_unsigned(self, x):
        """Centered int32 representative in [-(q//2), q//2] -> residue in [0, q)."""
        x = jnp.asarray(x, _I32)
        u = x.astype(_U32)
        return jnp.where(x < 0, u + self._qu, u)

    def to_centered(self, u):
        """Residue in [0, q) -> centered int32 representative, matching the range
        contract of the reference's ``cent`` (algebra/ntt.py:93-123)."""
        u = jnp.asarray(u, _U32)
        return jnp.where(u > self._halfu, u - self._qu, u).astype(_I32)

    def cent(self, x):
        """Vectorized centered reduction of arbitrary int32 values mod q.

        A negative int32 reads as ``x + 2**32`` when reinterpreted unsigned, so
        its residue is off by ``2**32 mod q``; subtract that back.
        """
        xi = jnp.asarray(x, _I32)
        u = xi.astype(_U32)
        r = u % self._qu
        r_wrap = self.sub_mod(r, jnp.asarray(np.uint32(self.r_mod_q)))
        return self.to_centered(jnp.where(xi < 0, r_wrap, r))

    # ---- ring ops on residues in [0, q) ----------------------------------
    def add_mod(self, a, b):
        s = a + b  # < 2q < 2**32: no wrap
        return jnp.where(s >= self._qu, s - self._qu, s)

    def sub_mod(self, a, b):
        return jnp.where(a >= b, a - b, a + (self._qu - b))

    def neg_mod(self, a):
        return jnp.where(a == 0, a, self._qu - a)

    def mul_mod_shoup(self, a, s, s_shoup):
        """(a * s) mod q where ``s`` is a constant residue with a precomputed
        Shoup word.  Valid for any uint32 ``a`` and s in [0, q); output in [0, q)."""
        hi, _ = widening_mul(a, s_shoup)
        r = a * s - hi * self._qu  # wrapping; true value < 2q so exact in u32
        return jnp.where(r >= self._qu, r - self._qu, r)

    def mont_reduce(self, hi, lo):
        """REDC: T = hi*2**32 + lo with T < q*2**32  ->  T * 2**-32 mod q."""
        m = lo * jnp.asarray(np.uint32(self.neg_q_inv))  # wrapping
        mq_hi, _ = widening_mul(m, jnp.asarray(self._qu))
        t = hi + mq_hi + (lo != 0).astype(_U32)
        return jnp.where(t >= self._qu, t - self._qu, t)

    def mont_mul(self, a, b):
        """(a * b * 2**-32) mod q.  With one operand pre-lifted by
        :meth:`to_mont` this is the plain modular product."""
        hi, lo = widening_mul(a, b)
        return self.mont_reduce(hi, lo)

    def to_mont(self, a):
        return self.mont_mul(a, jnp.asarray(np.uint32(self.r2_mod_q)))

    def from_mont(self, a):
        return self.mont_reduce(jnp.zeros_like(a), a)

    def mul_mod(self, a, b):
        """Plain-domain modular product (two REDC passes; prefer mont_mul with a
        pre-lifted operand in hot loops)."""
        return self.mont_mul(self.to_mont(a), b)

    # ---- long reductions ---------------------------------------------------
    # Largest number of [0, q) terms the int32 limb accumulators absorb before
    # folding: low limbs are < 2**16 so 2**15 terms stay < 2**31.
    SUM_TERMS_LIMIT = 1 << 15

    def sum_mod(self, x, axis: int):
        """Modular sum of residues in [0, q) along ``axis`` via 16-bit limb
        accumulation — the vectorized replacement for the reference's sequential
        cent-per-add aggregation loops (fusion/fusion.py:670-677, :709-714).

        Reductions longer than the limb headroom (2**15 terms) recurse
        hierarchically: the axis is zero-padded to a multiple of the limit and
        folded in two stages (zero terms are exact no-ops mod q)."""
        n = x.shape[axis]
        if n > self.SUM_TERMS_LIMIT:
            ax = axis % x.ndim
            k = self.SUM_TERMS_LIMIT
            n_pad = -(-n // k) * k
            if n_pad != n:
                widths = [(0, 0)] * x.ndim
                widths[ax] = (0, n_pad - n)
                x = jnp.pad(x, widths)
            shape = x.shape[:ax] + (n_pad // k, k) + x.shape[ax + 1 :]
            partial = self.sum_mod(x.reshape(shape), axis=ax + 1)
            return self.sum_mod(partial, axis=ax)
        pow16 = np.uint32((1 << 16) % self.q)
        pow16_sh = np.uint32(self.shoup(int(pow16)))
        lo = (x & _MASK16).astype(_I32)
        hi = (x >> 16).astype(_I32)
        lo_sum = jnp.sum(lo, axis=axis).astype(_U32)  # < 2**31
        hi_sum = jnp.sum(hi, axis=axis).astype(_U32)  # < 2**30
        folded = self.mul_mod_shoup(hi_sum, jnp.asarray(pow16), jnp.asarray(pow16_sh))
        lo_red = self.mul_mod_shoup(lo_sum >> 16, jnp.asarray(pow16), jnp.asarray(pow16_sh))
        lo_red = self.add_mod(lo_red, lo_sum & _MASK16)
        return self.add_mod(folded, lo_red)

    def dot_mod(self, a_mont, b, axis: int):
        """sum_k a_mont[k] * b[k] mod q along ``axis``, ``a_mont`` pre-lifted —
        the workhorse of A@sk, A@agg_sig and the verify target sum (replacing the
        reference's schoolbook loops, matrices.py:125-130)."""
        return self.sum_mod(self.mont_mul(a_mont, b), axis=axis)


@lru_cache(maxsize=None)
def get_field(q: int) -> Field:
    return Field(q)


FUSION_FIELD = get_field(Q)

# ---------------------------------------------------------------------------
# Module-level convenience bindings for the production Fusion field.
# ---------------------------------------------------------------------------
R_MOD_Q: int = FUSION_FIELD.r_mod_q
R2_MOD_Q: int = FUSION_FIELD.r2_mod_q
NEG_Q_INV_MOD_R: int = FUSION_FIELD.neg_q_inv
SUM_TERMS_LIMIT: int = Field.SUM_TERMS_LIMIT

to_unsigned = FUSION_FIELD.to_unsigned
to_centered = FUSION_FIELD.to_centered
cent = FUSION_FIELD.cent
add_mod = FUSION_FIELD.add_mod
sub_mod = FUSION_FIELD.sub_mod
neg_mod = FUSION_FIELD.neg_mod
mul_mod_shoup = FUSION_FIELD.mul_mod_shoup
mont_reduce = FUSION_FIELD.mont_reduce
mont_mul = FUSION_FIELD.mont_mul
to_mont = FUSION_FIELD.to_mont
from_mont = FUSION_FIELD.from_mont
mul_mod = FUSION_FIELD.mul_mod
sum_mod = FUSION_FIELD.sum_mod
dot_mod = FUSION_FIELD.dot_mod
shoup_precompute = FUSION_FIELD.shoup
