"""Batched Fusion lifecycle: keygen -> sign -> aggregate -> verify on tensors.

This is the tensor-native re-architecture of the reference scheme layer
(/root/reference/fusion/fusion.py:298-728).  Where the reference walks Python
object graphs one polynomial at a time, here a batch of B one-time keys is a
dense ``int32[B, 2, rank, d]`` tensor and every ring operation is a vectorized
device kernel:

* keygen:  NTT(sk coefficient batch), then vk = A·sk as a Montgomery-lifted
  pointwise product reduced over the rank axis (fusion.py:338-373);
* sign:    sig = left_sk ⊙ c + right_sk with the challenge NTT'd and lifted
  once per signature, broadcast over rank (fusion.py:534-557);
* aggregate: Σ_i sig_i ⊙ α_i as a limb-accumulated modular reduction over the
  signer axis (fusion.py:655-677);
* verify:  target/observed sums, mod-q equality, then INTT + norm/weight bound
  checks, returning the reference's exact reason strings (fusion.py:680-728).

Hashing (SHA3/SHAKE), repr serialization and byte decoding stay on the host
(see hashing/ and interop/serial.py); the host/device boundary is exactly
"bytes in -> coefficient tensors out".  Device functions are jit-compiled once
per (params, batch-shape) and cached.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..hashing.decode import decode_bytes_to_coefficients
from ..hashing.sampler import sample_short_poly_coeffs
from ..hashing.xof import (
    agg_block_len,
    challenge_xof_len,
    hash_message_to_int,
    shake_digest,
)
from ..interop import serial
from ..ops.ntt import ntt_fwd_u, ntt_inv_u
from ..params import Params

# ---------------------------------------------------------------------------
# Device contexts (cached per parameter set)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _ctx(params: Params):
    """Device-resident constants + jitted kernels for one parameter set."""
    plan = params.plan
    F = plan.field
    a_u = F.to_unsigned(jnp.asarray(params.public_challenge))
    a_mont = F.to_mont(a_u)  # uint32 [rank, d], Montgomery domain

    @jax.jit
    def keygen_core(sk_coeffs):
        """int32[B, 2, rank, d] coefficients -> (sk_hat, vk) centered int32."""
        sk_u = ntt_fwd_u(plan, F.to_unsigned(sk_coeffs))
        vk_u = F.dot_mod(a_mont, sk_u, axis=-2)  # reduce rank -> [B, 2, d]
        return F.to_centered(sk_u), F.to_centered(vk_u)

    @jax.jit
    def sign_core(sk_hat, c_coeffs):
        """(int32[B,2,rank,d], int32[B,d]) -> (sig int32[B,rank,d], c_hat int32[B,d])."""
        c_u = ntt_fwd_u(plan, F.to_unsigned(c_coeffs))
        c_mont = F.to_mont(c_u)[..., None, :]  # [B, 1, d] broadcast over rank
        sk_u = F.to_unsigned(sk_hat)
        sig_u = F.add_mod(F.mont_mul(c_mont, sk_u[..., 0, :, :]), sk_u[..., 1, :, :])
        return F.to_centered(sig_u), F.to_centered(c_u)

    @jax.jit
    def aggregate_core(sigs, alpha_coeffs):
        """(int32[..., N, rank, d], int32[..., N, d]) -> agg int32[..., rank, d]."""
        alpha_u = ntt_fwd_u(plan, F.to_unsigned(alpha_coeffs))
        alpha_mont = F.to_mont(alpha_u)[..., None, :]  # [..., N, 1, d]
        sig_u = F.to_unsigned(sigs)
        agg_u = F.sum_mod(F.mont_mul(alpha_mont, sig_u), axis=-3)
        return F.to_centered(agg_u)

    @jax.jit
    def sign_from_c_hat(sk_hat, c_hat):
        """NTT-domain variant for the object API (challenge already transformed)."""
        c_mont = F.to_mont(F.to_unsigned(c_hat))[..., None, :]
        sk_u = F.to_unsigned(sk_hat)
        sig_u = F.add_mod(F.mont_mul(c_mont, sk_u[..., 0, :, :]), sk_u[..., 1, :, :])
        return F.to_centered(sig_u)

    @jax.jit
    def aggregate_from_alpha_hat(sigs, alpha_hat):
        """NTT-domain variant: (int32[N, rank, d], int32[N, d]) -> int32[rank, d]."""
        alpha_mont = F.to_mont(F.to_unsigned(alpha_hat))[..., None, :]
        sig_u = F.to_unsigned(sigs)
        return F.to_centered(F.sum_mod(F.mont_mul(alpha_mont, sig_u), axis=-3))

    @jax.jit
    def verify_core(agg, vks, c_coeffs, alpha_coeffs):
        """Verify the lattice equation and bound checks.

        agg:   int32[..., rank, d]   aggregate signature (NTT domain)
        vks:   int32[..., N, 2, d]
        c/alpha coeffs: int8 or int32 [..., N, d] (coefficient domain,
            host-decoded; the production bounds are ±1 so int8 transfers
            quarter the host->device traffic)
        Returns bool[...] (eq, norm_ok, weight_ok).
        """
        agg_u = F.to_unsigned(agg)
        c_u = ntt_fwd_u(plan, F.to_unsigned(c_coeffs.astype(jnp.int32)))
        alpha_u = ntt_fwd_u(plan, F.to_unsigned(alpha_coeffs.astype(jnp.int32)))
        vk_u = F.to_unsigned(vks)
        # per-signer target term: vk_left ⊙ c + vk_right
        t = F.add_mod(F.mont_mul(F.to_mont(c_u), vk_u[..., 0, :]), vk_u[..., 1, :])
        target = F.sum_mod(F.mont_mul(F.to_mont(alpha_u), t), axis=-2)  # [..., d]
        observed = F.dot_mod(a_mont, agg_u, axis=-2)  # [..., d]
        eq = jnp.all(target == observed, axis=-1)
        coef = F.to_centered(ntt_inv_u(plan, agg_u))  # [..., rank, d]
        norm = jnp.max(jnp.abs(coef), axis=(-2, -1))
        norm_ok = norm <= np.int32(min(params.beta_vf, 2**31 - 1))
        weight = jnp.max(jnp.sum((coef % np.int32(params.modulus)) != 0, axis=-1), axis=-1)
        weight_ok = weight <= np.int32(params.omega_vf)
        return eq, norm_ok, weight_ok

    return dict(
        plan=plan,
        field=F,
        a_mont=a_mont,
        keygen_core=keygen_core,
        sign_core=sign_core,
        aggregate_core=aggregate_core,
        verify_core=verify_core,
        sign_from_c_hat=sign_from_c_hat,
        aggregate_from_alpha_hat=aggregate_from_alpha_hat,
    )


# ---------------------------------------------------------------------------
# Key / signature batch containers
# ---------------------------------------------------------------------------


@dataclass
class KeyBatch:
    """A batch of one-time key pairs as dense tensors.

    sk_hat: int32[B, 2, rank, d] NTT-domain signing keys (left, right)
    vk:     int32[B, 2, d]       NTT-domain verification keys (left, right)
    """

    params: Params
    seeds: List[Optional[int]]
    sk_hat: jnp.ndarray
    vk: jnp.ndarray

    def __len__(self) -> int:
        return self.vk.shape[0]

    def vk_np(self) -> np.ndarray:
        return np.asarray(self.vk)

    def vk_strs(self) -> List[str]:
        vk = self.vk_np()
        return [serial.vk_str(self.params, vk[i]) for i in range(len(self))]


@dataclass
class SignatureBatch:
    """sig: int32[B, rank, d] NTT-domain signatures (rank x 1 matrices)."""

    params: Params
    sig: jnp.ndarray

    def __len__(self) -> int:
        return self.sig.shape[0]


# ---------------------------------------------------------------------------
# Host-side hash pipeline pieces
# ---------------------------------------------------------------------------


def _challenge_coeffs(params: Params, vk_repr: str, message: str) -> Tuple[int, np.ndarray]:
    """(prehashed message int, challenge coefficient vector int32[d]) — the host
    half of hash_ch (fusion.py:511-531)."""
    i = hash_message_to_int(params.sign_pre_hash_dst, message)
    n = challenge_xof_len(params.secpar, params.degree, params.modulus, params.beta_ch, params.omega_ch)
    payload = params.sign_hash_dst + b"," + vk_repr.encode("utf-8") + b"," + str(i).encode()
    b = shake_digest(payload, n)
    coefs = decode_bytes_to_coefficients(
        b,
        log2_bias=params.secpar,
        modulus=params.modulus,
        degree=params.degree,
        norm_bound=params.beta_ch,
        weight_bound=params.omega_ch,
    )
    return i, coefs


def _xof_geometry(params: Params) -> Tuple[int, int, int, int]:
    """(bound, bytes_per_coefficient, bytes_per_index, xof_len) for the
    challenge pipeline (fusion.py:541-550 length arithmetic)."""
    from math import ceil, log2

    bound = max(1, min(params.modulus // 2, params.beta_ch))
    bpc = ceil((log2(bound) + 1 + params.secpar) / 8)
    bpi = ceil((log2(params.degree) + params.secpar) / 8)
    n = challenge_xof_len(
        params.secpar, params.degree, params.modulus, params.beta_ch, params.omega_ch
    )
    return bound, bpc, bpi, n


def _agg_alpha_coeffs(
    params: Params,
    key_reprs: Sequence[str],
    prehashed: Sequence[int],
    chall_reprs: Sequence[str],
) -> np.ndarray:
    """Aggregation coefficient vectors int32[N, d] — host half of hash_ag
    (fusion.py:573-652).  ``key_reprs`` are the reprs actually hashed (vk reprs
    in the scheme path; the KAT generator hashes (sk, vk) tuple reprs)."""
    from math import ceil, log2

    from .. import native

    n_keys = len(key_reprs)
    block = agg_block_len(params.secpar, params.degree, params.modulus, params.beta_ag, params.omega_ag)
    body = serial.zip_triples_str(key_reprs, prehashed, chall_reprs)
    payload = params.agg_xof_dst + b"," + body.encode("utf-8")
    b = shake_digest(payload, n_keys * block)
    if native.available():
        bound = max(1, min(params.modulus // 2, params.beta_ag))
        bpc = ceil((log2(bound) + 1 + params.secpar) / 8)
        bpi = ceil((log2(params.degree) + params.secpar) / 8)
        return native.decode_blocks(
            b, block, n_keys, params.degree, params.omega_ag, bound, bpc, bpi
        )
    out = np.empty((n_keys, params.degree), dtype=np.int32)
    for i in range(n_keys):
        out[i] = decode_bytes_to_coefficients(
            b[i * block : (i + 1) * block],
            log2_bias=params.secpar,
            modulus=params.modulus,
            degree=params.degree,
            norm_bound=params.beta_ag,
            weight_bound=params.omega_ag,
        )
    return out


def _challenges_native(
    params: Params, vk_reprs, messages: Sequence[str]
) -> Tuple[np.ndarray, np.ndarray]:
    """Native fused challenge sweep: (coeffs int32[n, d], digests uint8[n, 32]).
    ``vk_reprs`` may be a list of strs or a pre-packed (blob, offsets) pair."""
    from .. import native

    bound, bpc, bpi, n_xof = _xof_geometry(params)
    packed = vk_reprs if isinstance(vk_reprs, tuple) else native.pack_reprs(vk_reprs)
    return native.derive_challenges(
        params.sign_pre_hash_dst, params.sign_hash_dst,
        packed,
        [m.encode("utf-8") for m in messages],
        params.degree, params.omega_ch, bound, bpc, bpi, n_xof,
    )


def _challenges_for(
    params: Params, vk_reprs: Sequence[str], messages: Sequence[str]
) -> Tuple[List[int], np.ndarray]:
    from .. import native

    if native.available() and len(vk_reprs) > 0:
        coeffs, pre_digests = _challenges_native(params, vk_reprs, messages)
        pre = [int.from_bytes(bytes(pre_digests[k]), "little") for k in range(len(vk_reprs))]
        return pre, coeffs
    pre = []
    coeffs = np.empty((len(vk_reprs), params.degree), dtype=np.int32)
    for k, (vkr, msg) in enumerate(zip(vk_reprs, messages)):
        i, c = _challenge_coeffs(params, vkr, msg)
        pre.append(i)
        coeffs[k] = c
    return pre, coeffs


def derive_alphas_grouped(
    params: Params,
    vk_reprs_flat: Sequence[str],
    messages_flat: Sequence[str],
    n_groups: int,
    group_size: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched hash pipeline for G independent aggregation groups of N signers
    each (inputs already sorted within each group): returns
    (challenge coeffs int32[G, N, d], alpha coeffs int32[G, N, d]).

    One native challenge sweep over all G*N items, ONE device NTT launch for
    the challenge reprs, then per-group aggregation XOF + native block decode —
    this amortizes device round-trips, which dominate when the chip is remote.
    """
    from math import ceil, log2

    from .. import native

    G, N = n_groups, group_size
    assert len(vk_reprs_flat) == G * N == len(messages_flat)
    ctx = _ctx(params)

    if native.available():
        packed = native.pack_reprs(vk_reprs_flat)  # one encode+join for both stages
        cc, digests = _challenges_native(params, packed, messages_flat)
        # host-side NTT keeps the hash pipeline off the device (no mid-stream
        # host<->device round trip just to serialize challenge reprs)
        c_hat = native.ntt_fwd_batch(cc, ctx["plan"].brp, params.modulus)
        block = agg_block_len(
            params.secpar, params.degree, params.modulus, params.beta_ag, params.omega_ag
        )
        bound = max(1, min(params.modulus // 2, params.beta_ag))
        bpc = ceil((log2(bound) + 1 + params.secpar) / 8)
        bpi = ceil((log2(params.degree) + params.secpar) / 8)
        meta = serial._ring_meta(
            params.modulus, params.degree, params.root, params.inv_root, params.root_order
        )
        alphas = native.derive_alphas_fused(
            params.agg_xof_dst,
            packed,
            digests, meta, c_hat, G, N, block,
            params.degree, params.omega_ag, bound, bpc, bpi,
        )
        return cc.reshape(G, N, params.degree), alphas

    pre, cc = _challenges_for(params, vk_reprs_flat, messages_flat)
    c_hat = np.asarray(
        ctx["field"].to_centered(
            ntt_fwd_u(ctx["plan"], ctx["field"].to_unsigned(jnp.asarray(cc)))
        )
    )
    chall_reprs = [serial.challenge_str(params, c_hat[i]) for i in range(G * N)]
    alphas = np.empty((G, N, params.degree), dtype=np.int32)
    for g in range(G):
        sl = slice(g * N, (g + 1) * N)
        alphas[g] = _agg_alpha_coeffs(params, vk_reprs_flat[sl], pre[sl], chall_reprs[sl])
    return cc.reshape(G, N, params.degree), alphas


def derive_alphas(
    params: Params,
    vk_reprs: Sequence[str],
    messages: Sequence[str],
    key_reprs: Optional[Sequence[str]] = None,
) -> Tuple[List[int], np.ndarray, np.ndarray]:
    """Full hash_ag pipeline on already-sorted inputs: returns (prehashed ints,
    challenge coeffs int32[N,d], alpha coeffs int32[N,d]).

    ``key_reprs`` overrides the reprs hashed throughout (both the challenge
    derivation and the zip-triples preimage — the reference's hash_ag uses the
    same key objects for both, fusion.py:632-652; the KAT generator exercises
    this with (sk, vk) tuple reprs)."""
    reprs = list(key_reprs) if key_reprs is not None else list(vk_reprs)
    N = len(reprs)
    pre = [hash_message_to_int(params.sign_pre_hash_dst, m) for m in messages]

    from .. import native

    if native.available() and N > 0:
        cc, alphas = derive_alphas_grouped(params, reprs, list(messages), 1, N)
        return pre, cc[0], alphas[0]

    ctx = _ctx(params)
    _, c_coeffs = _challenges_for(params, reprs, list(messages))
    c_hat = np.asarray(
        ctx["field"].to_centered(ntt_fwd_u(ctx["plan"], ctx["field"].to_unsigned(jnp.asarray(c_coeffs))))
    )
    chall_reprs = [serial.challenge_str(params, c_hat[i]) for i in range(N)]
    alphas = _agg_alpha_coeffs(params, reprs, pre, chall_reprs)
    return pre, c_coeffs, alphas


# ---------------------------------------------------------------------------
# Public lifecycle
# ---------------------------------------------------------------------------


def keygen(params: Params, seeds: Sequence[Optional[int]]) -> KeyBatch:
    """Batched one-time keygen (fusion.py:338-373 semantics per key).

    Each key samples its left matrix from ``seed`` and right from ``seed + 1``;
    with integer seeds the reference's per-entry reseed makes all rank entries
    identical, so we sample one polynomial per side and broadcast (bit-identical,
    O(rank) less host work).  ``seed=None`` is rejected exactly like the
    reference (it crashes on ``seed + 1``, fusion.py:351-362).
    """
    from .. import native

    seeds = list(seeds)
    B = len(seeds)
    d, rank = params.degree, params.rank
    for seed in seeds:
        if seed is None:
            raise TypeError(
                "keygen requires an integer seed: the reference implementation "
                "fails on seed=None at fusion.py:352 (seed + 1)"
            )
    native_ok = native.available() and all(
        isinstance(s, int) and 0 <= s and s + 1 < 2**64 for s in seeds
    )
    if native_ok:
        interleaved = [x for s in seeds for x in (s, s + 1)]
        coeffs = native.sample_short_batch(
            interleaved, d, params.beta_sk, params.omega_sk, params.modulus
        ).reshape(B, 2, d)
        if B:
            # Side-effect parity: reference keygen leaves CPython's global
            # `random` in the state produced by its final seeded sample
            # (polynomials.py:447-448); downstream draws (e.g. the KAT
            # generator's randint interleaving) observe that state.  Re-run the
            # last sample through the stdlib path to reproduce it.
            last = sample_short_poly_coeffs(
                params.modulus, d, params.beta_sk, params.omega_sk, seeds[-1] + 1
            )
            if not np.array_equal(last, coeffs[-1, 1]):
                raise RuntimeError(
                    "native sampler disagrees with the stdlib reference sampler "
                    f"for seed {seeds[-1] + 1}; the native library is corrupt"
                )
    else:
        coeffs = np.empty((B, 2, d), dtype=np.int32)
        for b, seed in enumerate(seeds):
            coeffs[b, 0] = sample_short_poly_coeffs(params.modulus, d, params.beta_sk, params.omega_sk, seed)
            coeffs[b, 1] = sample_short_poly_coeffs(params.modulus, d, params.beta_sk, params.omega_sk, seed + 1)
    # rank-broadcast (general tensor layout kept so rank-distinct keys — e.g.
    # future non-degenerate sampling — use the same kernels)
    full = jnp.broadcast_to(jnp.asarray(coeffs)[:, :, None, :], (B, 2, rank, d))
    sk_hat, vk = _ctx(params)["keygen_core"](full)
    return KeyBatch(params=params, seeds=seeds, sk_hat=sk_hat, vk=vk)


def sign(params: Params, keys: KeyBatch, messages: Sequence[str],
         *, device_hash_threshold: int = 128) -> SignatureBatch:
    """Batched signing (fusion.py:534-557): one challenge hash per (vk, message),
    then sig = left_sk ⊙ c + right_sk on device.

    Batches of >= ``device_hash_threshold`` keys derive their challenges with
    the verifier's ON-DEVICE signer stage (SHA3 prehash + preimage assembly +
    SHAKE + decode on chip — no host repr rendering or host Keccak), which is
    what makes signing scale with the chip instead of the host (bit-exact
    twin of the host hash path; tests/test_scheme.py).
    """
    if len(messages) != len(keys):
        raise ValueError("need exactly one message per key")
    B = len(keys)
    msgs = list(messages)
    from . import device_pipeline as dp

    P = dp.get_pipeline(params, 1)
    if B >= device_hash_threshold and P.signer_at is not None:
        packed_full = jnp.asarray(P.prep_packed(msgs).reshape(B, 1, -1))
        vks4 = jnp.asarray(keys.vk).reshape(B, 1, 2, params.degree)
        parts = []
        for lo, hi in dp._launch_chunks(B, 8192):
            cc, _, _, _ = P.signer_at(vks4, packed_full, lo, hi - lo)
            parts.append(cc)
        c_coeffs = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        sig, _ = _ctx(params)["sign_core"](keys.sk_hat, c_coeffs)
        return SignatureBatch(params=params, sig=sig)
    vk_reprs = keys.vk_strs()
    _, c_coeffs = _challenges_for(params, vk_reprs, msgs)
    sig, _ = _ctx(params)["sign_core"](keys.sk_hat, jnp.asarray(c_coeffs))
    return SignatureBatch(params=params, sig=sig)


def _sorted_order(vk_reprs: Sequence[str]) -> List[int]:
    """Indices sorting signer tuples by str(vk) — the reference's canonical
    aggregation order (fusion.py:661-663)."""
    return sorted(range(len(vk_reprs)), key=lambda i: vk_reprs[i])


def aggregate(
    params: Params,
    vks: np.ndarray,
    messages: Sequence[str],
    sigs: jnp.ndarray,
) -> jnp.ndarray:
    """Aggregate N signatures: int32[N,2,d] vks, int32[N,rank,d] sigs ->
    int32[rank,d] aggregate (fusion.py:655-677)."""
    N = vks.shape[0]
    vk_reprs = [serial.vk_str(params, np.asarray(vks)[i]) for i in range(N)]
    order = _sorted_order(vk_reprs)
    s_reprs = [vk_reprs[i] for i in order]
    s_msgs = [messages[i] for i in order]
    _, _, alphas = derive_alphas(params, s_reprs, s_msgs)
    sigs_sorted = jnp.asarray(sigs)[np.array(order)]
    return _ctx(params)["aggregate_core"](sigs_sorted, jnp.asarray(alphas))


# Reference-exact verification failure strings (fusion.py:687-727).
REASON_TOO_MANY = "Too many keys."
REASON_LEN_MISMATCH = "Number of keys and messages must be equal."
REASON_TARGET = "Target doesn't match image of aggregate signature."
REASON_NORM = "Norm of aggregate signature too large."
REASON_WEIGHT = "Weight of aggregate signature too large."


def verify(
    params: Params,
    vks: np.ndarray,
    messages: Sequence[str],
    aggregate_signature: jnp.ndarray,
) -> Tuple[bool, str]:
    """Verify one aggregate signature; returns (ok, reason) with the reference's
    exact reason strings (fusion.py:680-728)."""
    N = vks.shape[0]
    if N > params.capacity:
        return False, REASON_TOO_MANY
    if N != len(messages):
        return False, REASON_LEN_MISMATCH
    vk_np = np.asarray(vks)
    vk_reprs = [serial.vk_str(params, vk_np[i]) for i in range(N)]
    order = _sorted_order(vk_reprs)
    s_reprs = [vk_reprs[i] for i in order]
    s_msgs = [messages[i] for i in order]
    _, c_coeffs, alphas = derive_alphas(params, s_reprs, s_msgs)
    vks_sorted = jnp.asarray(vk_np)[np.array(order)]
    eq, norm_ok, weight_ok = _ctx(params)["verify_core"](
        jnp.asarray(aggregate_signature), vks_sorted, jnp.asarray(c_coeffs), jnp.asarray(alphas)
    )
    if not bool(eq):
        return False, REASON_TARGET
    if not bool(norm_ok):
        return False, REASON_NORM
    if not bool(weight_ok):
        return False, REASON_WEIGHT
    return True, ""


def verify_many(
    params: Params,
    groups: Sequence[Tuple[np.ndarray, Sequence[str], jnp.ndarray]],
    *,
    device_bucket_threshold: int = 64,
) -> List[Tuple[bool, str]]:
    """Verify many independent aggregate signatures, possibly with different
    signer counts, with vectorized packing.

    ``groups`` is a sequence of (vks int32[N_i, 2, d], messages, agg
    int32[rank, d]).  Groups are bucketed by N; each bucket's sort-by-str(vk)
    order comes from the ON-DEVICE rank kernel (device_setup.vk_sort_ranks —
    no host repr rendering), ordering is applied with one take_along_axis per
    bucket, and then:

    * buckets with >= ``device_bucket_threshold`` groups run through the
      all-on-device hash pipeline (device_pipeline.verify_batch_device) —
      zero host hashing;
    * smaller buckets render reprs only for themselves, derive challenges and
      alphas on the host pipeline, and share ONE padded verify_core launch
      (zero alpha rows contribute nothing to the target sum, so padding to
      the common max N is exact).
    """
    from . import device_pipeline as dp
    from .device_setup import vk_sort_ranks

    G = len(groups)
    d, rank = params.degree, params.rank
    results: List[Optional[Tuple[bool, str]]] = [None] * G
    data: dict = {}
    live: List[int] = []
    for gi, (vks, messages, agg) in enumerate(groups):
        vk_np = np.asarray(vks)
        N = int(vk_np.shape[0])
        if N > params.capacity:
            results[gi] = (False, REASON_TOO_MANY)
            continue
        if N != len(messages):
            results[gi] = (False, REASON_LEN_MISMATCH)
            continue
        data[gi] = (vk_np, list(messages), np.asarray(agg))
        live.append(gi)
    if not live:
        return [r for r in results]

    by_n: dict = {}
    for gi in live:
        by_n.setdefault(data[gi][0].shape[0], []).append(gi)

    def fill(gis, eq, norm_ok, w_ok):
        for k, gi in enumerate(gis):
            if not eq[k]:
                results[gi] = (False, REASON_TARGET)
            elif not norm_ok[k]:
                results[gi] = (False, REASON_NORM)
            elif not w_ok[k]:
                results[gi] = (False, REASON_WEIGHT)
            else:
                results[gi] = (True, "")

    host_buckets = []  # (gis, vks_sorted [Gb,N,2,d], msgs_sorted, aggs [Gb,rank,d])
    for N, gis in sorted(by_n.items()):
        Gb = len(gis)
        vks_b = np.stack([data[gi][0] for gi in gis])  # [Gb, N, 2, d]
        aggs_b = np.stack([data[gi][2] for gi in gis])
        ranks = np.asarray(
            vk_sort_ranks(params, jnp.asarray(vks_b.reshape(Gb * N, 2, d)), N)
        )
        order = np.argsort(ranks, axis=1)  # [Gb, N] — exact stable sort order
        vks_s = np.take_along_axis(vks_b, order[:, :, None, None], axis=1)
        msgs_s = [data[gi][1][j] for k, gi in enumerate(gis) for j in order[k]]
        if Gb >= device_bucket_threshold:
            eq, nok, wok = dp.verify_batch_device(
                params, jnp.asarray(vks_s), msgs_s, jnp.asarray(aggs_b)
            )
            fill(gis, np.asarray(eq), np.asarray(nok), np.asarray(wok))
        else:
            host_buckets.append((gis, vks_s, msgs_s, aggs_b))

    if host_buckets:
        n_max = max(b[1].shape[1] for b in host_buckets)
        Gt = sum(len(b[0]) for b in host_buckets)
        cc_pad = np.zeros((Gt, n_max, d), dtype=np.int32)
        al_pad = np.zeros((Gt, n_max, d), dtype=np.int32)
        vk_pad = np.zeros((Gt, n_max, 2, d), dtype=np.int32)
        aggs = np.empty((Gt, rank, d), dtype=np.int32)
        all_gis: List[int] = []
        p = 0
        for gis, vks_s, msgs_s, aggs_b in host_buckets:
            Gb, N = vks_s.shape[0], vks_s.shape[1]
            # the host hash pipeline consumes repr strings (they ARE the
            # SHAKE preimages) — rendered only for these small buckets
            reprs = [
                serial.vk_str(params, vks_s[k, j])
                for k in range(Gb)
                for j in range(N)
            ]
            cc, al = derive_alphas_grouped(params, reprs, msgs_s, Gb, N)
            sl = slice(p, p + Gb)
            cc_pad[sl, :N] = cc
            al_pad[sl, :N] = al
            vk_pad[sl, :N] = vks_s
            aggs[sl] = aggs_b
            all_gis.extend(gis)
            p += Gb
        eq, norm_ok, w_ok = _ctx(params)["verify_core"](
            jnp.asarray(aggs), jnp.asarray(vk_pad), jnp.asarray(cc_pad),
            jnp.asarray(al_pad),
        )
        fill(all_gis, np.asarray(eq), np.asarray(norm_ok), np.asarray(w_ok))
    return [r for r in results]


def verify_batch(
    params: Params,
    vks: jnp.ndarray,
    c_coeffs: jnp.ndarray,
    alpha_coeffs: jnp.ndarray,
    aggs: jnp.ndarray,
):
    """Throughput-oriented grouped verify: G independent aggregates with
    pre-derived (sorted) challenge/alpha coefficient tensors.

    vks int32[G,N,2,d], c/alpha int32[G,N,d], aggs int32[G,rank,d] ->
    (eq, norm_ok, weight_ok) bool[G] device arrays.
    """
    return _ctx(params)["verify_core"](aggs, vks, c_coeffs, alpha_coeffs)
