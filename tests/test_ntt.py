"""NTT/INTT property tests against brute-force oracles, mirroring the oracle
strategy of the reference's tests/test_ntt.py (schoolbook negacyclic products,
round-trips, monomials) but vectorized and with the evaluation-point oracle:

    CT-NTT output[i] == f(psi^(2*bitrev(i)+1)) mod q   (verified vs reference)
"""
import random

import numpy as np
import jax.numpy as jnp
import pytest

from fusion_cryptography_tpu.ops import field as F
from fusion_cryptography_tpu.ops.ntt import make_plan, ntt_fwd, ntt_inv, negacyclic_poly_mult
from fusion_cryptography_tpu.ops.numtheory import bit_reverse_indices, find_primitive_root

pytestmark = pytest.mark.fast

# (degree, modulus) sweep mirroring the reference's coverage design
# (tests/test_ntt.py:18-49: every d = 2^2..2^6 with the first ascending primes
# q < 2^17, q ≡ 1 (mod 2d)), plus the two production configurations.
def _sweep_cases(primes_per_degree=2):
    out = []
    for log_d in range(2, 7):
        d = 1 << log_d
        q = 2 * d + 1
        found = 0
        while found < primes_per_degree and q < (1 << 17):
            from fusion_cryptography_tpu.ops.numtheory import is_odd_prime

            if is_odd_prime(q):
                out.append((d, q))
                found += 1
            q += 2 * d
    return out


SMALL_CASES = _sweep_cases()
PROD_CASES = [(64, F.Q, 23584283), (256, F.Q, 3337519)]


def centered(x, q):
    y = x % q
    return y - q if y > q // 2 else y


def eval_oracle(f, q, psi, d):
    """Evaluate the polynomial at psi^(2*brv(i)+1): the CT output semantics."""
    idx = bit_reverse_indices(d)
    out = []
    for i in range(d):
        pt = pow(psi, 2 * idx[i] + 1, q)
        out.append(centered(sum(c * pow(pt, j, q) for j, c in enumerate(f)), q))
    return out


def schoolbook_negacyclic(f, g, q):
    d = len(f)
    c = [0] * (2 * d)
    for i, x in enumerate(f):
        for j, y in enumerate(g):
            c[i + j] += x * y
    return [centered(c[k] - c[k + d], q) for k in range(d)]


@pytest.mark.parametrize("d,q", SMALL_CASES)
def test_fwd_matches_evaluation_oracle(d, q):
    psi = find_primitive_root(q, 2 * d)
    plan = make_plan(q, d, psi)
    rng = random.Random(d * q)
    f = [rng.randrange(-(q // 2), q // 2 + 1) for _ in range(d)]
    out = np.asarray(ntt_fwd(plan, jnp.asarray(np.array(f, dtype=np.int32)))).tolist()
    assert out == eval_oracle(f, q, psi, d)


@pytest.mark.parametrize("d,q", SMALL_CASES)
def test_roundtrip_small(d, q):
    psi = find_primitive_root(q, 2 * d)
    plan = make_plan(q, d, psi)
    rng = np.random.default_rng(d + q)
    x = rng.integers(-(q // 2), q // 2 + 1, size=(5, d)).astype(np.int32)
    back = np.asarray(ntt_inv(plan, ntt_fwd(plan, jnp.asarray(x))))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("d,q,root", PROD_CASES)
def test_roundtrip_production(d, q, root):
    plan = make_plan(q, d, root)
    rng = np.random.default_rng(d)
    x = rng.integers(-(q // 2), q // 2 + 1, size=(4, 3, d), dtype=np.int64).astype(np.int32)
    back = np.asarray(ntt_inv(plan, ntt_fwd(plan, jnp.asarray(x))))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("d,q", SMALL_CASES)
def test_poly_mult_vs_schoolbook(d, q):
    psi = find_primitive_root(q, 2 * d)
    plan = make_plan(q, d, psi)
    rng = random.Random(d ^ q)
    f = [rng.randrange(-(q // 2), q // 2 + 1) for _ in range(d)]
    g = [rng.randrange(-(q // 2), q // 2 + 1) for _ in range(d)]
    got = np.asarray(
        negacyclic_poly_mult(
            plan, jnp.asarray(np.array(f, dtype=np.int32)), jnp.asarray(np.array(g, dtype=np.int32))
        )
    ).tolist()
    assert got == schoolbook_negacyclic(f, g, q)


@pytest.mark.parametrize("d,q,root", PROD_CASES)
def test_poly_mult_production_vs_schoolbook(d, q, root):
    plan = make_plan(q, d, root)
    rng = random.Random(d)
    f = [rng.randrange(-(q // 2), q // 2 + 1) for _ in range(d)]
    g = [rng.randrange(-(q // 2), q // 2 + 1) for _ in range(d)]
    got = np.asarray(
        negacyclic_poly_mult(
            plan, jnp.asarray(np.array(f, dtype=np.int32)), jnp.asarray(np.array(g, dtype=np.int32))
        )
    ).tolist()
    assert got == schoolbook_negacyclic(f, g, q)


def test_monomial_products_wraparound():
    """X^i * X^j == X^(i+j) or -X^(i+j-d): the negacyclic sign wrap (mirrors the
    reference's monomial sweep, tests/test_ntt.py:121-203)."""
    d, q = 16, 97
    psi = find_primitive_root(q, 2 * d)
    plan = make_plan(q, d, psi)
    pairs = [(i, j) for i in range(d) for j in range(d)]
    f = np.zeros((len(pairs), d), dtype=np.int32)
    g = np.zeros((len(pairs), d), dtype=np.int32)
    expect = np.zeros((len(pairs), d), dtype=np.int32)
    for k, (i, j) in enumerate(pairs):
        f[k, i] = 1
        g[k, j] = 1
        if i + j < d:
            expect[k, i + j] = 1
        else:
            expect[k, i + j - d] = -1
    got = np.asarray(negacyclic_poly_mult(plan, jnp.asarray(f), jnp.asarray(g)))
    np.testing.assert_array_equal(got, expect)


def test_multiply_by_one():
    d, q, root = 64, F.Q, 23584283
    plan = make_plan(q, d, root)
    rng = np.random.default_rng(0)
    f = rng.integers(-(q // 2), q // 2 + 1, size=d, dtype=np.int64).astype(np.int32)
    one = np.zeros(d, dtype=np.int32)
    one[0] = 1
    got = np.asarray(negacyclic_poly_mult(plan, jnp.asarray(f), jnp.asarray(one)))
    np.testing.assert_array_equal(got, f)


def test_linearity_and_pointwise_homomorphism():
    """NTT(a)*NTT(b) pointwise == NTT(a*b negacyclic) — the transform is a ring
    homomorphism (mirrors tests/test_polynomials.py:792-879)."""
    d, q, root = 256, F.Q, 3337519
    plan = make_plan(q, d, root)
    rng = np.random.default_rng(1)
    a = rng.integers(-50, 51, size=d).astype(np.int32)
    b = rng.integers(-50, 51, size=d).astype(np.int32)
    fa = F.to_unsigned(ntt_fwd(plan, jnp.asarray(a)))
    fb = F.to_unsigned(ntt_fwd(plan, jnp.asarray(b)))
    pointwise = F.to_centered(F.mont_mul(F.to_mont(fa), fb))
    direct = ntt_fwd(plan, jnp.asarray(np.array(schoolbook_negacyclic(a.tolist(), b.tolist(), q), dtype=np.int32)))
    np.testing.assert_array_equal(np.asarray(pointwise), np.asarray(direct))


def test_ntt_inv_mxu_matches_butterfly():
    """The dense limb-matmul inverse transform (off the production path;
    see its docstring) is a bit-exact twin of ntt_inv_u."""
    import jax.numpy as jnp

    from fusion_cryptography_tpu.ops.ntt import make_plan, ntt_inv_u, ntt_inv_u_mxu

    Q = F.Q
    for d, root in [(256, 3337519), (64, 23584283)]:
        plan = make_plan(Q, d, root)
        rng = np.random.default_rng(d)
        x = rng.integers(0, Q, size=(9, 7, d), dtype=np.int64).astype(np.uint32)
        a = np.asarray(ntt_inv_u(plan, jnp.asarray(x)))
        b = np.asarray(ntt_inv_u_mxu(plan, jnp.asarray(x)))
        assert np.array_equal(a, b)
