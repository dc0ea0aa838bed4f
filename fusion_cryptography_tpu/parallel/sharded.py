"""Sharded lifecycle step: the full keygen→sign→aggregate→verify pipeline under
``shard_map`` on a (dp, tp) mesh.

Sharding layout (SURVEY.md §2 parallelism table):

* batch axis B  -> ``dp`` (keys/signatures data-parallel across chips);
* rank axis     -> ``tp`` (sk/sig rank rows tensor-parallel; A·x and the verify
  target become per-shard partial reductions + ``psum`` over ``tp``);
* the aggregate signature's signer-sum stays local per dp shard and is reduced
  with ``psum`` over ``dp`` (each dp shard owns a slice of the signer batch).

The rank (195 or 83) is not divisible by typical mesh sizes, so the rank axis is
zero-padded to a multiple of tp: zero rows of A and sk contribute nothing to any
reduction, keeping results bit-identical to the unsharded kernels (asserted in
tests/test_sharded.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.ntt import ntt_fwd_u, ntt_inv_u
from ..params import Params


def _pad_rank(x: np.ndarray, axis: int, rank_padded: int) -> np.ndarray:
    pad = rank_padded - x.shape[axis]
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


def sharded_lifecycle_step(params: Params, mesh: Mesh):
    """Build a jitted, mesh-sharded full lifecycle step.

    Returns ``(step, prepare)`` where ``prepare(B)`` builds example inputs and
    ``step(sk_coeffs, c_coeffs, alpha_coeffs)`` runs keygen + sign + aggregate +
    verify for a batch of B signers treated as one aggregation group:

      sk_coeffs:    int32[B, 2, rank_p, d]   (rank-padded short key coefficients)
      c_coeffs:     int32[B, d]              (host-decoded challenge coefficients)
      alpha_coeffs: int32[B, d]              (host-decoded aggregation coefficients)

    and returns (vk int32[B,2,d], agg int32[rank_p,d], eq bool, norm_ok bool,
    weight_ok bool)  — everything needed to check the sharded pipeline against
    the single-device kernels bit-for-bit.
    """
    plan = params.plan
    F = plan.field
    dp = mesh.shape["dp"]
    tp = mesh.shape["tp"]
    rank_p = -(-params.rank // tp) * tp

    a_pad = _pad_rank(np.asarray(params.public_challenge), 0, rank_p).astype(np.int32)
    a_mont_host = np.asarray(F.to_mont(F.to_unsigned(jnp.asarray(a_pad))))

    def step_local(a_mont, sk_coeffs, c_coeffs, alpha_coeffs):
        """Runs on each (dp, tp) shard: B/dp signers, rank_p/tp rank rows."""
        # --- keygen ---
        sk_u = ntt_fwd_u(plan, F.to_unsigned(sk_coeffs))  # [b, 2, r_loc, d]
        vk_partial = F.sum_mod(F.mont_mul(a_mont, sk_u), axis=-2)  # [b, 2, d]
        # rank rows are tp-sharded: the A·sk reduction spans tp
        vk_u = _psum_mod(F, vk_partial, "tp")
        # --- sign ---
        c_u = ntt_fwd_u(plan, F.to_unsigned(c_coeffs))  # [b, d]
        c_mont = F.to_mont(c_u)[:, None, :]
        sig_u = F.add_mod(F.mont_mul(c_mont, sk_u[:, 0]), sk_u[:, 1])  # [b, r_loc, d]
        # --- aggregate (batch = one aggregation group) ---
        alpha_u = ntt_fwd_u(plan, F.to_unsigned(alpha_coeffs))
        alpha_mont = F.to_mont(alpha_u)[:, None, :]
        agg_partial = F.sum_mod(F.mont_mul(alpha_mont, sig_u), axis=0)  # [r_loc, d]
        agg_u = _psum_mod(F, agg_partial, "dp")
        # --- verify ---
        t = F.add_mod(F.mont_mul(F.to_mont(c_u), vk_u[:, 0]), vk_u[:, 1])  # [b, d]
        target_partial = F.sum_mod(F.mont_mul(F.to_mont(alpha_u), t), axis=0)  # [d]
        # vk/c/alpha are replicated across tp, so the signer sum only spans dp
        target = _psum_mod(F, target_partial, "dp")
        observed_partial = F.sum_mod(F.mont_mul(a_mont, agg_u), axis=0)  # [d]
        observed = _psum_mod(F, observed_partial, "tp")
        eq = jnp.all(target == observed)
        coef = F.to_centered(ntt_inv_u(plan, agg_u))  # [r_loc, d]
        norm = jax.lax.pmax(jnp.max(jnp.abs(coef)), "tp")
        weight = jax.lax.pmax(jnp.max(jnp.sum(coef % np.int32(params.modulus) != 0, axis=-1)), "tp")
        return (
            F.to_centered(vk_u),
            F.to_centered(agg_u),
            eq,
            norm <= np.int32(min(params.beta_vf, 2**31 - 1)),
            weight <= np.int32(params.omega_vf),
        )

    step_sharded = jax.jit(
        jax.shard_map(
            step_local,
            mesh=mesh,
            in_specs=(
                P("tp", None),          # a_mont [rank_p, d]
                P("dp", None, "tp", None),  # sk_coeffs [B, 2, rank_p, d]
                P("dp", None),          # c_coeffs [B, d]
                P("dp", None),          # alpha_coeffs [B, d]
            ),
            out_specs=(
                P("dp", None, None),    # vk [B, 2, d]
                P("tp", None),          # agg [rank_p, d]
                P(),                    # eq
                P(),                    # norm_ok
                P(),                    # weight_ok
            ),
            check_vma=False,
        )
    )

    a_mont_dev = jnp.asarray(a_mont_host)

    def step(sk_coeffs, c_coeffs, alpha_coeffs):
        return step_sharded(a_mont_dev, sk_coeffs, c_coeffs, alpha_coeffs)

    def prepare(B: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        sk = rng.integers(-52, 53, size=(B, 2, params.rank, params.degree)).astype(np.int32)
        sk = _pad_rank(sk, 2, rank_p)
        c = rng.integers(-1, 2, size=(B, params.degree)).astype(np.int32)
        al = rng.integers(-1, 2, size=(B, params.degree)).astype(np.int32)
        return jnp.asarray(sk), jnp.asarray(c), jnp.asarray(al)

    return step, prepare, rank_p


def prepare_real(params: Params, rank_p: int, seeds, messages):
    """REAL-data inputs for ``sharded_lifecycle_step``: secret coefficients
    from the reference-exact MT19937 sampler and challenge/aggregation
    coefficients from the actual hash pipeline (SHA3 prehash -> SHAKE XOF ->
    decode), sorted by str(vk) like the reference aggregation order
    (fusion.py:661-663, :511-531, :632-652).

    Unlike ``prepare``'s random +/-1 tensors — for which the lattice equation
    holds identically — these coefficients tie the sharded path to the
    KAT-verified host hash pipeline.

    Returns (sk int32[B, 2, rank_p, d], c int32[B, d], alpha int32[B, d],
    keys KeyBatch, order list[int]) with sk/c/alpha in sorted order.
    """
    from ..hashing.sampler import sample_short_poly_coeffs
    from ..scheme import lifecycle as lc

    seeds = list(seeds)
    B = len(seeds)
    d, rank = params.degree, params.rank
    keys = lc.keygen(params, seeds)
    reprs = keys.vk_strs()
    order = sorted(range(B), key=lambda i: reprs[i])
    s_reprs = [reprs[i] for i in order]
    s_msgs = [messages[i] for i in order]
    cc, al = lc.derive_alphas_grouped(params, s_reprs, s_msgs, 1, B)
    coeffs = np.empty((B, 2, d), dtype=np.int32)
    for b, s in enumerate(seeds):
        coeffs[b, 0] = sample_short_poly_coeffs(
            params.modulus, d, params.beta_sk, params.omega_sk, s
        )
        coeffs[b, 1] = sample_short_poly_coeffs(
            params.modulus, d, params.beta_sk, params.omega_sk, s + 1
        )
    coeffs = coeffs[order]
    # the reference's per-entry reseed makes all rank entries identical
    sk = np.broadcast_to(coeffs[:, :, None, :], (B, 2, rank, d))
    sk = _pad_rank(np.ascontiguousarray(sk), 2, rank_p)
    return jnp.asarray(sk), jnp.asarray(cc[0]), jnp.asarray(al[0]), keys, order


def sharded_verify_device(params: Params, mesh: Mesh, vks, messages, aggs,
                          *, group_chunk: int = None, axis: str = "dp"):
    """The flagship all-on-device verify pipeline
    (scheme/device_pipeline.verify_batch_device) under ``shard_map`` over the
    ``dp`` mesh axis on the GROUPS dimension.

    Every aggregate group's verify — SHA3 prehash, preimage assembly, SHAKE
    XOFs, challenge/alpha decode, NTTs, lattice equation, norm/weight — is
    independent of every other group's, so the groups axis shards with ZERO
    collectives: each chip runs the same fused one-launch program on its
    G/dp local groups (the per-group hash stage is the scaling wall at 2^20
    signatures — SURVEY.md §7 hard-part 5; reference loop:
    /root/reference/fusion/fusion.py:680-728).

    vks int32[G, N, 2, d], messages G*N strings, aggs int32[G, rank, d];
    G must be divisible by the dp axis size.  Returns (eq, norm_ok,
    weight_ok) bool[G].  Bitwise equal to the single-device path
    (tests/test_sharded.py::test_sharded_device_verify).  Host inputs go
    straight to their shards; device-resident inputs are resharded.
    """
    from jax.sharding import NamedSharding

    from ..scheme import device_pipeline as dpl

    G, N = int(vks.shape[0]), int(vks.shape[1])
    ndp = mesh.shape[axis]
    if G % ndp:
        raise ValueError(f"G={G} must be divisible by the {axis} axis ({ndp})")
    Gl = G // ndp
    P = dpl.get_pipeline(params, N)
    chunk = dpl._fused_chunk(
        Gl, dpl.GROUP_CHUNK if group_chunk is None else group_chunk
    )
    msgs = list(messages)
    if len(msgs) != G * N:
        raise ValueError(f"need {G * N} messages, got {len(msgs)}")
    packed_np = P.prep_packed(msgs).reshape(G, N, -1)

    fn = _sharded_verify_fn(params, mesh, N, chunk, axis, dpl._env_flags())
    sh = NamedSharding(mesh, jax.sharding.PartitionSpec(axis))
    return fn(
        jax.device_put(vks, sh),
        jax.device_put(packed_np, sh),
        jax.device_put(aggs, sh),
    )


from functools import lru_cache as _lru_cache


@_lru_cache(maxsize=32)
def _sharded_verify_fn(params: Params, mesh: Mesh, n_signers: int, chunk: int,
                       axis: str, flags: tuple):
    """Compiled shard_map program cache for :func:`sharded_verify_device`
    (one entry per mesh/shape/pipeline-flavor combination)."""
    from ..scheme import device_pipeline as dpl

    P = dpl._pipeline_cached(params, n_signers, *flags)
    P_spec = jax.sharding.PartitionSpec
    return jax.jit(
        jax.shard_map(
            lambda v, p, a: P.fused_core(v, p, a, chunk),
            mesh=mesh,
            in_specs=(P_spec(axis), P_spec(axis), P_spec(axis)),
            out_specs=(P_spec(axis), P_spec(axis), P_spec(axis)),
            check_vma=False,
        )
    )


def _psum_mod(F, x_u32, axis_name: str):
    """Modular psum: partial residues in [0, q) summed over a mesh axis then
    reduced.  Safe for axis sizes up to 2**15 (limb headroom, see Field.sum_mod);
    here axis sizes are chip counts (<= 256), so a single int32 psum + fold works:
    each partial < q < 2**31, so sum < chips * 2**31 — split 16-bit limbs first.
    """
    lo = (x_u32 & jnp.uint32(0xFFFF)).astype(jnp.int32)
    hi = (x_u32 >> 16).astype(jnp.int32)
    lo_sum = jax.lax.psum(lo, axis_name).astype(jnp.uint32)
    hi_sum = jax.lax.psum(hi, axis_name).astype(jnp.uint32)
    pow16 = np.uint32((1 << 16) % F.q)
    pow16_sh = np.uint32(F.shoup(int(pow16)))
    folded = F.mul_mod_shoup(hi_sum, jnp.asarray(pow16), jnp.asarray(pow16_sh))
    lo_red = F.mul_mod_shoup(lo_sum >> 16, jnp.asarray(pow16), jnp.asarray(pow16_sh))
    lo_red = F.add_mod(lo_red, lo_sum & jnp.uint32(0xFFFF))
    return F.add_mod(folded, lo_red)
