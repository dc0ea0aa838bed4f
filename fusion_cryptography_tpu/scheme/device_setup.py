"""On-device benchmark fleet construction: keygen -> sign -> aggregate.

Building a benchmark fleet through the host object path means rendering
every vk's repr string on the host just to compute the reference's
sort-by-str(vk) aggregation order.  This module keeps everything on the
device:

  host:   C MT19937 sampling of the short secret coefficients
          (native/fusion_native.c — bit-exact stdlib `random` semantics),
          raw ``dst + "," + message`` byte packing
  device: NTT keygen + vk = A·sk (fusion.py:338-373), the sort-by-str(vk)
          ranks (:func:`vk_sort_ranks` — only [G, N] rank ints leave the
          device), the full challenge hash pipeline (the SAME compiled signer/
          group stages the verifier uses, scheme/device_pipeline), sig =
          sk_l⊙c + sk_r (fusion.py:534-557), alpha derivation + aggregate sum
          (fusion.py:632-677)

Exactness notes:
* with integer seeds the reference's per-entry reseed makes all ``rank``
  entries of a key identical (SURVEY.md §2.13), so sk/sig tensors carry one
  polynomial per side and vk = (Σ_r A_r)·sk — mont_mul is linear mod q in its
  first argument, so this equals the rank-wise dot bit-for-bit;
* the aggregate inherits the same rank-degeneracy, so it is broadcast to the
  full int32[G, rank, d] layout the (rank-general) verifier consumes;
* tests/test_device_setup.py asserts vk/sig/aggregate equality against the
  host lifecycle path, and device sort ranks against host ``sorted(str(vk))``.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..hashing.sampler import sample_short_poly_coeffs
from ..ops.ntt import ntt_fwd_u
from ..params import Params
from . import device_pipeline as dp

_I32 = jnp.int32
_U32 = jnp.uint32


def _sample_sk(params: Params, seeds: Sequence[int]) -> np.ndarray:
    """Short secret coefficients int32[B, 2, d]: left from seed, right from
    seed+1 (reference keygen, fusion.py:339-362)."""
    from .. import native

    B = len(seeds)
    d = params.degree
    if native.available():
        interleaved = [x for s in seeds for x in (s, s + 1)]
        return native.sample_short_batch(
            interleaved, d, params.beta_sk, params.omega_sk, params.modulus
        ).reshape(B, 2, d)
    out = np.empty((B, 2, d), dtype=np.int32)
    for b, s in enumerate(seeds):
        out[b, 0] = sample_short_poly_coeffs(params.modulus, d, params.beta_sk, params.omega_sk, s)
        out[b, 1] = sample_short_poly_coeffs(params.modulus, d, params.beta_sk, params.omega_sk, s + 1)
    return out


@lru_cache(maxsize=8)
def _keygen_fn(params: Params):
    plan = params.plan
    F = plan.field
    a_mont_sum = F.sum_mod(
        F.to_mont(F.to_unsigned(jnp.asarray(params.public_challenge))), axis=0
    )  # [d]: Σ_r A_r in Montgomery form — exact vs the rank-wise dot because
    # all rank entries of sk are identical (per-entry reseed quirk)

    @jax.jit
    def keygen(sk_coeffs):
        """int32/int8[B, 2, d] -> (sk_hat_u u32[B, 2, d], vk i32[B, 2, d])."""
        sk_u = ntt_fwd_u(plan, F.to_unsigned(sk_coeffs.astype(jnp.int32)))
        vk_u = F.mont_mul(a_mont_sum, sk_u)
        return sk_u, F.to_centered(vk_u)

    return keygen


# ---------------------------------------------------------------------------
# On-device sort-by-str(vk) ranks (fusion.py:661-663 aggregation order)
# ---------------------------------------------------------------------------


def _bswap32(x):
    return (
        ((x & np.uint32(0xFF)) << np.uint32(24))
        | ((x & np.uint32(0xFF00)) << np.uint32(8))
        | ((x >> np.uint32(8)) & np.uint32(0xFF00))
        | (x >> np.uint32(24))
    )


def _first_nonzero(x):
    """Order-preserving first-nonzero tree reduce along axis 0 (identity 0)."""
    while x.shape[0] > 1:
        n = x.shape[0]
        if n % 2:
            x = jnp.concatenate([x, jnp.zeros_like(x[:1])])
            n += 1
        p = x.reshape(n // 2, 2, *x.shape[1:])
        e, o = p[:, 0], p[:, 1]
        x = jnp.where(e == 0, o, e)
    return x[0]


@lru_cache(maxsize=8)
def _vk_rank_fn(params: Params, n_signers: int):
    """jit: vk int32[B, 2, d] (centered, groups of N contiguous) ->
    ranks int32[G, N] — element i's position in its group under the
    reference's stable sort by str(vk) (fusion.py:661-663).

    Comparison key per rendered number: ``render(v) ++ terminator`` packed
    big-endian (see interop/device_serial.number_terminators); per-pair
    outcome is the sign at the first differing key word, ties broken by
    original index (= the reference sort's stability).  Only the [G, N] rank
    ints ever leave the device.
    """
    from ..interop import device_serial as ds
    from ..ops import ragged_words as rw

    spec = ds.vk_body_spec(params)
    terms = np.asarray(ds.number_terminators(spec), dtype=np.uint32)  # [2d]
    d = params.degree
    N = n_signers

    @jax.jit
    def ranks_of(vk):
        vals_t = vk.reshape(-1, 2 * d).T
        B = vals_t.shape[-1]
        G = B // N
        cells = rw.render_decimal_cells_w(vals_t, b"")  # [2d, 3, B] u32 LE
        field, length = cells.buf, cells.length
        # drop each number's terminator byte at position ``length``
        wi = jax.lax.broadcasted_iota(_I32, field.shape, 1)
        t_val = jnp.asarray(terms)[:, None, None] << (
            np.uint32(8) * (length & 3).astype(_U32)[:, None, :]
        )
        field = field | jnp.where(
            wi == (length >> 2)[:, None, :], t_val, np.uint32(0)
        )
        keys = _bswap32(field).reshape(2 * d * rw.DEC_WW, B)  # lexicographic words
        kg = keys.reshape(-1, G, N)
        rank = jnp.zeros((G, N), _I32)
        for i in range(N):
            for j in range(i + 1, N):
                c = (kg[:, :, i] > kg[:, :, j]).astype(jnp.int8) - (
                    kg[:, :, i] < kg[:, :, j]
                ).astype(jnp.int8)
                s = _first_nonzero(c)  # [G]: <0 i first, >0 j first, 0 tie
                rank = rank.at[:, j].add((s <= 0).astype(_I32))
                rank = rank.at[:, i].add((s > 0).astype(_I32))
        return rank

    return ranks_of


def vk_sort_ranks(params: Params, vk, n_signers: int):
    """Device sort order: vk int32[B, 2, d] with groups of ``n_signers``
    contiguous -> ranks int32[G, N] (see :func:`_vk_rank_fn`)."""
    return _vk_rank_fn(params, n_signers)(jnp.asarray(vk))


# ---------------------------------------------------------------------------
# Sign + aggregate on the verifier's compiled hash stages
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _concat_fn(params: Params):
    @jax.jit
    def cat(*parts):
        """Interleaved (sk_hat_u, vk) slice pairs -> two concatenated tensors
        in ONE launch."""
        sks = parts[0::2]
        vks = parts[1::2]
        return jnp.concatenate(sks, axis=0), jnp.concatenate(vks, axis=0)

    return cat


@lru_cache(maxsize=8)
def _take_fn(params: Params):
    @partial(jax.jit, static_argnums=(3, 4))
    def take(sk_hat_u, vk, oflat, G, N):
        """Sort-order gather for both key tensors in ONE launch."""
        d = params.degree
        return (
            jnp.take(sk_hat_u, oflat, axis=0),
            jnp.take(vk, oflat, axis=0).reshape(G, N, 2, d),
        )

    return take


@lru_cache(maxsize=16)
def _math_fn(params: Params, n_signers: int):
    plan = params.plan
    F = plan.field
    d = params.degree
    N = n_signers

    @jax.jit
    def j_math(sk_hat_u, c_hat_u, al):
        """sig = sk_l⊙c + sk_r; agg = Σ α̂⊙sig (rank-degenerate layout)."""
        B = sk_hat_u.shape[0]
        G = B // N
        sig_u = F.add_mod(
            F.mont_mul(F.to_mont(c_hat_u), sk_hat_u[:, 0]), sk_hat_u[:, 1]
        )  # [B, d]
        alpha_u = ntt_fwd_u(plan, F.to_unsigned(al))
        agg_u = F.sum_mod(
            F.mont_mul(F.to_mont(alpha_u), sig_u.reshape(G, N, d)), axis=1
        )  # [G, d]
        aggs = jnp.broadcast_to(
            F.to_centered(agg_u)[:, None, :], (G, params.rank, d)
        )
        return F.to_centered(sig_u), aggs

    return j_math


def build_fleet(
    params: Params,
    n_groups: int,
    n_signers: int,
    *,
    seed0: int = 1,
    messages: Sequence[str] = None,
    group_chunk: int = dp.GROUP_CHUNK,
) -> Tuple[jnp.ndarray, List[str], jnp.ndarray]:
    """Build G aggregate-signature groups of N signers for benchmarking.

    Returns (vks int32[G, N, 2, d] sorted within groups by str(vk),
    messages flat G*N strings in that order, aggs int32[G, rank, d]) — all
    device-resident, valid under scheme.verify / device_pipeline semantics.

    The hash half runs on the verifier's pipeline stages (same jits, same
    ``group_chunk`` launch shapes), so a bench process compiles each stage
    once for both halves.
    """
    G, N = n_groups, n_signers
    B = G * N
    d = params.degree
    if messages is None:
        messages = [f"group{g}:msg{i}" for g in range(G) for i in range(N)]

    # Sample + keygen in slices: host MT19937 sampling of slice k+1 overlaps
    # the device keygen of slice k (dispatch is asynchronous), and the short
    # coefficients upload as int8 (beta_sk <= 52, fusion.py:30-31 — 4x
    # smaller, the fleet's largest transfer).
    n_slices = 4 if B >= 16384 else 1
    step = -(-B // n_slices)
    parts = []
    for lo in range(0, B, step):
        hi = min(B, lo + step)
        sk = _sample_sk(params, [seed0 + k for k in range(lo, hi)])
        parts.append(_keygen_fn(params)(jnp.asarray(sk.astype(np.int8))))
    if len(parts) == 1:
        sk_hat_u, vk = parts[0]
    else:
        sk_hat_u, vk = _concat_fn(params)(*[x for p in parts for x in p])

    # the reference sorts signer tuples by str(vk) inside each group; the
    # ranks come off the device as G*N ints (no vk pull, no host repr
    # rendering)
    ranks = np.asarray(vk_sort_ranks(params, vk, N))  # [G, N]
    order = np.argsort(ranks, axis=1)  # ranks are a permutation per group
    flat = (order + np.arange(G)[:, None] * N).reshape(-1)
    s_msgs = [messages[i] for i in flat]

    oflat = jnp.asarray(flat)
    sk_s, vks = _take_fn(params)(sk_hat_u, vk, oflat, G, N)

    P = dp.get_pipeline(params, N)
    j_math = _math_fn(params, N)
    chunk = dp._fused_chunk(G, group_chunk)
    if P.device_prehash:
        # ONE packed upload + the verifier's fused hash program + one math
        # launch
        packed = jnp.asarray(P.prep_packed(s_msgs).reshape(G, N, -1))
        _, c_hat_u, al = P.fused_hash(vks, packed, chunk)
        sigs, aggs = j_math(sk_s, c_hat_u, al)
        return vks, s_msgs, aggs
    sig_parts, agg_parts = [], []
    for lo, hi in dp._launch_chunks(G, group_chunk):
        pb, pl = P.prep(s_msgs[lo * N : hi * N])
        pb = jnp.asarray(pb.reshape(hi - lo, N, -1))
        pl = jnp.asarray(pl.reshape(hi - lo, N))
        _, c_hat_u, tbuf, tlen = P.signer(vks[lo:hi], pb, pl)
        al = P.group(tbuf.reshape(-1, hi - lo, N), tlen.reshape(hi - lo, N))
        sigs, aggs = j_math(sk_s[lo * N : hi * N], c_hat_u, al)
        sig_parts.append(sigs)
        agg_parts.append(aggs)
    aggs = jnp.concatenate(agg_parts) if len(agg_parts) > 1 else agg_parts[0]
    return vks, s_msgs, aggs
