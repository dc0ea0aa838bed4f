"""Whole-verify-on-device pipeline: hashing, decoding, and lattice math in one jit.

The host path (scheme/lifecycle.py) keeps SHAKE on the CPU, which caps
end-to-end throughput at the host's Keccak rate.  This module moves the
*entire* grouped-verify dataflow onto the device:

  vks int32[G, N, 2, d], prehash digits, aggs int32[G, rank, d]
    -> challenge preimages  (interop/device_serial templates + render_decimal)
    -> SHAKE256 XOFs        (ops/keccak_triton on a GPU, ops/keccak elsewhere)
    -> challenge coeffs     (ops/xof_decode signums/Fisher-Yates)
    -> challenge NTT        (ops/ntt)
    -> triple + aggregation preimages (nested ragged assembly)
    -> aggregation XOF + alpha decode
    -> target/observed sums, norm/weight bounds  (ops/field)

One ``jax.jit`` per (params, N, G-shape): a verify batch is one device
program with no host hashing, no serialization, and no per-signer
transfers — the only inputs are the key/signature tensors plus the raw
``dst + "," + message`` bytes.  The SHA3-256 message prehash AND its
``str(int)`` decimal rendering (fusion/fusion.py:405-409) run on device too
(keccak.sha3_256_words + ragged_words.render_bigint_dec_w);
``FUSION_HOST_PREHASH=1`` restores the host prehash.

Bit-exactness: every stage is the device twin of a host stage that is itself
KAT-verified; tests/test_device_pipeline.py asserts equality of challenge and
alpha coefficients and of verify verdicts against the host path.

Device memory is bounded by ``group_chunk``: the fused program runs the
hash half and the lattice check as a ``lax.map`` over chunks of
``group_chunk`` groups, so the working set — including the [3d, B]
triple-value and [Lt, B] triple-preimage buffers of the signer half,
B = group_chunk * N — never scales with total G.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..interop import device_serial as ds
from ..ops import ragged_words as rw
from ..ops import xof_decode
from ..ops.keccak import (
    RATE,
    sha3_256_words,
    shake256_absorb_lanes_lm,
    shake256_absorb_words,
    shake256_squeeze_lanes_lm,
    shake256_squeeze_words,
)
from ..ops.keccak_triton import shake256_words_triton
from ..ops.ntt import ntt_fwd_u, ntt_inv_u
from ..params import Params
from ..hashing.xof import agg_block_len, challenge_xof_len, hash_message_to_int

_I32 = jnp.int32


def _pad_rate(n: int) -> int:
    return -(-(n + 1) // RATE) * RATE  # +1: the 0x1F pad byte may start a block


def _shake_lm(buf, lens, n_out: int):
    """Lane-major SHAKE256: buf uint8[W, B] -> uint8[n_out, B]."""
    return shake256_squeeze_lanes_lm(shake256_absorb_lanes_lm(buf, lens), n_out)


def sponge_impl() -> str:
    """The word sponge for the default backend: the fused Triton kernel on a
    GPU, the XLA lane sponge elsewhere (identical output words)."""
    return "triton" if jax.default_backend() == "gpu" else "xla"


def make_stages(params: Params, n_signers: int, use_words: bool = None,
                sponge: str = "xla"):
    """The lane-major hash stages shared by grouped verify (this module) and
    the on-device benchmark setup (scheme/device_setup.py).

    signer_stage(vk2d_t i32[2d, B], pre_buf_t u8[78, B], pre_len i32[B]) ->
        (cc i32[B, d], c_hat_u u32[B, d], tbuf, tlen i32[B])
    group_stage(tbuf [Lt, G, N], tlen i32[G, N]) -> alphas i32[G, N, d]

    Two implementations per stage, byte-exact twins of each other:

    * the DEFAULT packed-word path (ops/ragged_words): preimages are carried
      as uint32 words, 4 bytes per element, end to end, so assembly barrel
      shifts cost ~4x fewer ops than the byte path and the sponge needs zero
      repacking (``tbuf`` between the stages is uint32[ceil(Lt/4), B]).  Its
      challenge and aggregation sponges are ``sponge``: "triton"
      (ops/keccak_triton) or "xla" (keccak.shake256_absorb_words);
    * the byte-carrier lane-major path (``FUSION_BYTE_PIPELINE=1``), kept as
      the A/B reference oracle (``tbuf`` is uint8[Lt, B]).
    """
    import os

    plan = params.plan
    F = plan.field
    g = _geometries(params)
    d = params.degree
    N = n_signers
    ch_spec, tri_spec = g["ch_spec"], g["tri_spec"]
    agg_spec = ds.agg_preimage_spec(params, N, tri_spec.out_max)
    agg_min = ds.spec_min_total(agg_spec, [g["tri_min"]] * N)
    pre_bounds = [(1, ds.PREHASH_W)]
    tri_bounds = [(g["tri_min"], tri_spec.out_max)] * N
    if use_words is None:
        use_words = not os.environ.get("FUSION_BYTE_PIPELINE")

    def _pad_rate_words(n_bytes: int) -> int:
        return _pad_rate(n_bytes) // 4

    def _sponge_words(wbuf, total, n_words: int, min_len: int):
        """Word-in/word-out SHAKE (identical output words either way)."""
        if sponge == "triton":
            return shake256_words_triton(wbuf, total, n_words)
        return shake256_squeeze_words(
            shake256_absorb_words(wbuf, total, min_len=min_len, assume_clean=True),
            n_words,
        )

    def _hash_stage(spec, values, extras, bounds, n_out: int, B: int):
        """preimage assembly + SHAKE -> uint8[n_out, B] XOF stream.

        ``extras`` are (words, len) pairs on the word path, (bytes, len)
        otherwise.
        """
        if use_words:
            wbuf, total = ds.assemble_chunks_words(
                spec, values=values, extras=extras, extra_bounds=bounds,
                pad_words=_pad_rate_words(spec.out_max),
            )
            state = shake256_absorb_words(wbuf, total)
            return shake256_squeeze_lanes_lm(state, n_out)
        extras = [(eb.astype(jnp.uint8), el) for eb, el in extras]
        buf, total = ds.assemble_chunks_lm(
            spec, values=values, extras=extras, extra_bounds=bounds
        )
        pad = _pad_rate(spec.out_max) - buf.shape[0]
        if pad > 0:
            buf = jnp.pad(buf, ((0, pad), (0, 0)))
        return _shake_lm(buf, total, n_out)

    def _signer_stage_words(vk2d_t, pre_chunk: "rw.WChunk"):
        """Word path with the str(vk) subtree assembled ONCE and folded into
        both the challenge preimage and the triple.  The XOF stays packed
        words end-to-end: squeeze_words -> decode_coeffs_w, no [n, B] byte
        tensor between the sponge and the coefficients."""
        vk_chunk = ds.vk_chunk_w(params, vk2d_t)
        wbuf, total = ds.fold_challenge_preimage_w(
            params, vk_chunk, pre_chunk, pad_words=_pad_rate_words(ch_spec.out_max)
        )
        xw = _sponge_words(wbuf, total, -(-g["n_xof_ch_used"] // 4), g["ch_min"])
        cc_t = xof_decode.decode_coeffs_w(xw, g["geom_ch"], g["n_xof_ch_used"])  # [d, B]
        cc = cc_t.T
        c_hat_u = ntt_fwd_u(plan, F.to_unsigned(cc))  # [B, d]
        c_hat_t = F.to_centered(c_hat_u).T  # [d, B]
        tbuf, tlen = ds.fold_triple_w(params, vk_chunk, pre_chunk, c_hat_t)
        return cc, c_hat_u, tbuf, tlen

    def prehash_stage(msg_words, msg_len):
        """Device prehash: RAW message preimage words (dst + "," + message)
        -> prehash digit words (uint32[20, B], int32[B]).  SHA3-256 runs on
        the same sponge as the challenge XOFs (keccak.sha3_256_words) and the
        78-digit decimal rendering is a u32 divmod chain
        (ragged_words.render_bigint_dec_w), so a verify call uploads
        ~(3 + len(msg)) bytes per signer instead of 82 digit bytes and spends
        zero host CPU on hashing.  The host uploads TIGHT word rows
        (msg_preimage_words); the static pad to a whole number of rate blocks
        happens here, on device, where it is free."""
        Wt = msg_words.shape[0]
        pad = _pad_rate(Wt * 4) // 4 - Wt
        if pad > 0:
            msg_words = jnp.pad(msg_words, ((0, pad), (0, 0)))
        digest = sha3_256_words(msg_words, msg_len)
        chunk = rw.render_bigint_dec_w(digest)
        return chunk.buf, chunk.length

    def signer_stage(vk2d_t, pre_buf_t, pre_len):
        """``pre_buf_t`` carries the prehash digits: uint8[78, B] host-rendered
        bytes, or uint32[20, B] packed words straight from prehash_stage."""
        B = vk2d_t.shape[1]
        if use_words:
            lo, hi = pre_bounds[0]
            pre_w = (
                pre_buf_t
                if pre_buf_t.dtype == jnp.uint32
                else rw.pack_bytes_to_words(pre_buf_t.astype(jnp.uint8))
            )
            pre_chunk = rw.WChunk(
                buf=pre_w, length=pre_len.astype(jnp.int32), max_len=hi, min_len=lo
            )
            return _signer_stage_words(vk2d_t, pre_chunk)
        xof = _hash_stage(
            ch_spec, vk2d_t, [(pre_buf_t, pre_len)], pre_bounds, g["n_xof_ch_used"], B
        )
        cc_t = xof_decode.decode_coeffs_lm(xof, g["geom_ch"])  # [d, B] int32
        cc = cc_t.T
        c_hat_u = ntt_fwd_u(plan, F.to_unsigned(cc))  # [B, d]
        c_hat_t = F.to_centered(c_hat_u).T  # [d, B]
        tvals_t = jnp.concatenate([vk2d_t, c_hat_t], axis=0)  # [3d, B]
        tbuf, tlen = ds.assemble_chunks_lm(
            tri_spec, values=tvals_t, extras=[(pre_buf_t, pre_len)],
            extra_bounds=pre_bounds,
        )
        return cc, c_hat_u, tbuf, tlen

    def group_stage_parts(tbs, tls):
        """N pre-split triple buffers ([Lt, G] each) + lengths -> alphas.

        The fused program passes per-chunk slices of its own triple buffers;
        the unfused path slices the [Lt, G, N] stack in a jit of its own."""
        G = tbs[0].shape[1]
        extras = [(tbs[k], tls[k]) for k in range(N)]
        if use_words:
            # packed words end-to-end: assemble -> absorb -> squeeze_words ->
            # per-signer realigned word streams -> decode_coeffs_w.  Replaces
            # the [N*block, G] byte blob + moveaxis shuffle of the byte path.
            wbuf, total = ds.assemble_chunks_words(
                agg_spec, values=None, extras=extras, extra_bounds=tri_bounds,
                pad_words=_pad_rate_words(agg_spec.out_max),
            )
            blob_w = _sponge_words(
                wbuf, total, -(-(N * g["block_ag"]) // 4), agg_min
            )  # [ceil(N*block/4), G]
            per_w = xof_decode.split_streams_w(blob_w, N, g["block_ag"])
            al_t = xof_decode.decode_coeffs_w(
                per_w.reshape(-1, G * N), g["geom_ag"], g["block_ag"]
            )  # [d, G*N]
            return al_t.T.reshape(G, N, d)
        blob = _hash_stage(agg_spec, None, extras, tri_bounds, N * g["block_ag"], G)
        per = jnp.moveaxis(blob.reshape(N, g["block_ag"], G), 0, 2)  # [block, G, N]
        al_t = xof_decode.decode_coeffs_lm(
            per.reshape(g["block_ag"], G * N), g["geom_ag"]
        )  # [d, G*N]
        return al_t.T.reshape(G, N, d)

    def group_stage(tbuf, tlen):
        return group_stage_parts(
            [tbuf[:, :, k] for k in range(N)], [tlen[:, k] for k in range(N)]
        )

    signer_stage.prehash = prehash_stage if use_words else None
    group_stage.parts = group_stage_parts
    return signer_stage, group_stage


def prehash_digits(params: Params, messages: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Host half: SHA3-256 prehash of each message rendered as ``str(int)``
    bytes (uint8[B, 78], int32[B]) for the device preimage assemblers."""
    from .. import native

    if native.available() and len(messages) > 64:
        return native.prehash_digits_batch(
            bytes(params.sign_pre_hash_dst), [m.encode("utf-8") for m in messages]
        )
    B = len(messages)
    buf = np.zeros((B, ds.PREHASH_W), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for k, m in enumerate(messages):
        s = str(hash_message_to_int(params.sign_pre_hash_dst, m)).encode()
        buf[k, : len(s)] = np.frombuffer(s, dtype=np.uint8)
        lens[k] = len(s)
    return buf, lens


@lru_cache(maxsize=16)
def _geometries(params: Params):
    bound_ch = max(1, min(params.modulus // 2, params.beta_ch))
    bound_ag = max(1, min(params.modulus // 2, params.beta_ag))
    ch_spec = ds.challenge_preimage_spec(params)
    tri_spec = ds.triple_spec(params)
    n_xof_ch = challenge_xof_len(
        params.secpar, params.degree, params.modulus, params.beta_ch, params.omega_ch
    )
    geom_ch = xof_decode.geometry(
        params.secpar, params.modulus, params.degree, bound_ch, params.omega_ch
    )
    return dict(
        ch_spec=ch_spec,
        tri_spec=tri_spec,
        tri_min=ds.spec_min_total(tri_spec, [1]),
        ch_min=ds.spec_min_total(ch_spec, [1]),
        n_xof_ch=n_xof_ch,
        # the decoder never reads the stream tail (see consumed_bytes):
        # squeezing only the consumed prefix is bit-exact and saves ~20% of
        # the challenge-XOF keccak permutations
        n_xof_ch_used=xof_decode.consumed_bytes(geom_ch, n_xof_ch),
        block_ag=agg_block_len(
            params.secpar, params.degree, params.modulus, params.beta_ag, params.omega_ag
        ),
        geom_ch=geom_ch,
        geom_ag=xof_decode.geometry(
            params.secpar, params.modulus, params.degree, bound_ag, params.omega_ag
        ),
    )


@lru_cache(maxsize=32)
def _pipeline_cached(params: Params, n_signers: int, use_words: bool,
                     device_prehash: bool, sponge: str = "xla"):
    """Build the grouped-verify stage functions for one (params, N) shape and
    one pipeline flavor (the env knobs and the backend's sponge are folded
    into this cache key by :func:`get_pipeline`, so toggling a knob
    mid-process takes effect on the next verify call).

    The whole hash half runs *lane-major* (byte axis major, batch minor) so
    every elementwise op runs over batch elements.

    ``fused_all`` (the default verify) is ONE jit; ``fused_hash`` (fleet
    build, the coefficient-returning path and ``FUSION_FUSED_MODE=hash``) is
    its hash half.  The unfused entry points (``signer``, ``group``,
    ``lattice`` and their ``*_at`` variants) compose separate jits for
    ``FUSION_FUSED_MODE=off`` and batches the fused chunking does not tile.
    """
    from types import SimpleNamespace

    plan = params.plan
    F = plan.field
    d = params.degree
    N = n_signers
    a_mont = F.to_mont(F.to_unsigned(jnp.asarray(params.public_challenge)))
    signer_stage, group_stage = make_stages(
        params, N, use_words=use_words, sponge=sponge
    )
    device_prehash = device_prehash and signer_stage.prehash is not None

    # input transposes [G, N, 2, d] -> [2d, B] (+ the on-device prehash)
    if device_prehash:
        j_prep = jax.jit(
            lambda vks, mw, ml: (vks.reshape(-1, 2 * d).T,)
            + signer_stage.prehash(mw.reshape(ml.size, -1).T, ml.reshape(-1))
        )

        def j_signer(vks, msg_words, msg_len):
            vk2d_t, digit_w, digit_len = j_prep(vks, msg_words, msg_len)
            return _j_core(vk2d_t, digit_w, digit_len)

    else:
        j_prep_h = jax.jit(
            lambda vks, pb, pl: (
                vks.reshape(-1, 2 * d).T,
                pb.reshape(pl.size, -1).T,
                pl.reshape(-1),
            )
        )

        def j_signer(vks, pre_buf, pre_len):
            return _j_core(*j_prep_h(vks, pre_buf, pre_len))

    @jax.jit
    def _j_core(vk2d_t, pre_t, pre_len):
        return signer_stage(vk2d_t, pre_t, pre_len)

    @jax.jit
    def _j_group_core(*parts):
        return group_stage.parts(list(parts[:N]), list(parts[N:]))

    # one launch for all 2N per-signer slices
    j_gsplit = jax.jit(
        lambda tbuf, tlen: tuple(
            [tbuf[:, :, k] for k in range(N)] + [tlen[:, k] for k in range(N)]
        )
    )

    def j_group(tbuf, tlen):
        return _j_group_core(*j_gsplit(tbuf, tlen))

    @jax.jit
    def j_lattice(vks, c_hat_u, al, aggs):
        """Lattice verification (reference fusion.py:680-728 semantics)."""
        G = vks.shape[0]
        vk_u = F.to_unsigned(vks)  # [G, N, 2, d]
        c_u = c_hat_u.reshape(G, N, d)
        alpha_u = ntt_fwd_u(plan, F.to_unsigned(al))  # [G, N, d]
        t = F.add_mod(F.mont_mul(F.to_mont(c_u), vk_u[..., 0, :]), vk_u[..., 1, :])
        target = F.sum_mod(F.mont_mul(F.to_mont(alpha_u), t), axis=-2)  # [G, d]
        agg_u = F.to_unsigned(aggs)
        observed = F.dot_mod(a_mont, agg_u, axis=-2)  # [G, d]
        eq = jnp.all(target == observed, axis=-1)
        coef = F.to_centered(ntt_inv_u(plan, agg_u))  # [G, rank, d]
        norm = jnp.max(jnp.abs(coef), axis=(-2, -1))
        # centered coefficients satisfy |coef| <= q//2 < q, so
        # coef % q != 0  <=>  coef != 0 (no 43M-element division);
        # reference semantics: fusion.py:726-727 over centered values
        weight = jnp.max(jnp.sum((coef != 0).astype(_I32), axis=-1), axis=-1)
        norm_ok = norm <= np.int32(min(params.beta_vf, 2**31 - 1))
        weight_ok = weight <= np.int32(params.omega_vf)
        return eq, norm_ok, weight_ok

    def prep(msgs_slice):
        """Host half for one chunk: message bytes -> (pre_buf, pre_len)."""
        if device_prehash:
            return msg_preimage_words(params, msgs_slice)
        return prehash_digits(params, msgs_slice)

    def prep_packed(msgs_slice):
        """One-array host prep: message preimage words with the byte lengths
        appended as a final u32 column, so a verify uploads ONE array."""
        if not device_prehash:
            raise RuntimeError("packed prep needs the device-prehash word path")
        pb, pl = msg_preimage_words(params, msgs_slice)
        return np.concatenate([pb, pl.astype("<u4")[:, None]], axis=1)

    # Unfused entry points: full device-resident tensors in, chunk offset
    # baked STATICALLY (one small executable per chunk offset, compiled once
    # and cached).
    if device_prehash:
        @partial(jax.jit, static_argnums=(2, 3))
        def j_prep_at(vks_full, packed_full, lo, size):
            vkc = vks_full[lo : lo + size]
            pk = packed_full[lo : lo + size]
            mw = pk[:, :, :-1]
            ml = pk[:, :, -1].astype(_I32)
            return (vkc.reshape(-1, 2 * d).T,) + signer_stage.prehash(
                mw.reshape(ml.size, -1).T, ml.reshape(-1)
            )

        def signer_at(vks_full, packed_full, lo, size):
            """packed_full: device u32[G, N, Wt+1] (one prep_packed upload
            for the whole verify)."""
            return _j_core(*j_prep_at(vks_full, packed_full, lo, size))
    else:
        signer_at = None

    @partial(jax.jit, static_argnums=(4, 5, 6))
    def lattice_at(vks_full, c_hat_u, al_window, aggs_full, lo, size, wlo):
        return j_lattice(
            vks_full[lo : lo + size],
            c_hat_u,
            jax.lax.slice_in_dim(al_window, lo - wlo, lo - wlo + size, axis=0),
            aggs_full[lo : lo + size],
        )

    # ------------------------------------------------------------------
    # Fused pipeline: the whole verify as ONE device program.  The working
    # set stays bounded by running it as a lax.map over complete-group
    # chunks INSIDE the jit.
    # ------------------------------------------------------------------

    def _signer_chunk_body(vkc, pkc):
        """One chunk: vkc i32[c, N, 2, d], pkc u32[c, N, Wt+1] ->
        (cc i32[cN, d], c_hat_u u32[cN, d], al i32[c, N, d]).

        The GROUP hash runs here too, per chunk: every chunk holds complete
        groups (all N signers), so its aggregation preimages close over the
        chunk's own triple buffers — the [Lw, G, N] triple stack, its
        moveaxis, and the per-signer slice copies never materialize.
        """
        c = vkc.shape[0]
        ml = pkc[:, :, -1].astype(_I32)
        mw = pkc[:, :, :-1]
        pre_w, pre_len = signer_stage.prehash(
            mw.reshape(ml.size, -1).T, ml.reshape(-1)
        )
        vk2d_t = vkc.reshape(-1, 2 * d).T
        cc, c_hat_u, tbuf, tlen = signer_stage(vk2d_t, pre_w, pre_len)
        tb = tbuf.reshape(tbuf.shape[0], c, N)
        tl = tlen.reshape(c, N)
        al = group_stage.parts(
            [tb[:, :, k] for k in range(N)],
            [tl[:, k] for k in range(N)],
        )
        return cc, c_hat_u, al

    def _chunk_verify(vkc, pkc, aggc):
        _cc, c_hat_u, al = _signer_chunk_body(vkc, pkc)
        return j_lattice(vkc, c_hat_u, al, aggc)

    def _map_chunks(fn, chunk: int, *xs):
        """``fn`` over complete-group chunks of the leading (groups) axis as
        a lax.map; each output's chunk axes merge back into one."""
        G = xs[0].shape[0]
        nc = G // chunk
        if nc == 1:
            return fn(*xs)
        out = jax.lax.map(
            lambda c: fn(*c), tuple(x.reshape(nc, chunk, *x.shape[1:]) for x in xs)
        )
        return jax.tree_util.tree_map(lambda y: y.reshape(-1, *y.shape[2:]), out)

    @partial(jax.jit, static_argnums=(2,))
    def fused_hash(vks, packed, chunk):
        """signer + group hashing -> (challenge coeffs cc i32[G*N, d],
        their NTT c_hat_u u32[G*N, d], alpha coeffs al i32[G, N, d])."""
        return _map_chunks(_signer_chunk_body, chunk, vks, packed)

    def _fused_all_core(vks, packed, aggs, chunk):
        """Traceable whole-verify body (also the per-shard body of
        parallel/sharded.sharded_verify_device — each group's verify is
        independent, so dp-sharding the groups axis needs no collectives)."""
        return _map_chunks(_chunk_verify, chunk, vks, packed, aggs)

    fused_all = jax.jit(_fused_all_core, static_argnums=(3,))

    @partial(jax.jit, static_argnums=(4, 5))
    def lattice_at_full(vks_full, c_hat_full, al, aggs_full, lo, size):
        """lattice_at with the challenge NTT values sliced from the fused
        hash output."""
        return j_lattice(
            vks_full[lo : lo + size],
            jax.lax.slice_in_dim(c_hat_full, lo * N, (lo + size) * N, axis=0),
            jax.lax.slice_in_dim(al, lo, lo + size, axis=0),
            aggs_full[lo : lo + size],
        )

    return SimpleNamespace(
        signer=j_signer,
        signer_at=signer_at,
        group=j_group,
        lattice=j_lattice,
        lattice_at=lattice_at,
        lattice_at_full=lattice_at_full,
        fused_hash=fused_hash,
        fused_all=fused_all,
        fused_core=_fused_all_core,
        prep=prep,
        prep_packed=prep_packed,
        device_prehash=device_prehash,
        n_signers=N,
    )


def _env_flags():
    """The pipeline flavor: env knobs read PER CALL so toggles take effect on
    the next verify (they are part of the _pipeline_cached key), plus the
    backend's sponge."""
    import os

    use_words = not os.environ.get("FUSION_BYTE_PIPELINE")
    device_prehash = use_words and not _host_prehash_forced()
    return use_words, device_prehash, sponge_impl() if use_words else "xla"


def get_pipeline(params: Params, n_signers: int):
    """The production entry: stage functions for (params, N) under the
    current env knobs."""
    return _pipeline_cached(params, n_signers, *_env_flags())


def _fused_mode() -> str:
    """``FUSION_FUSED_MODE``: "all" (default — whole verify in one launch),
    "hash" (hash half fused, lattice per chunk), or "off" (per-chunk
    launches)."""
    import os

    mode = os.environ.get("FUSION_FUSED_MODE", "all").lower()
    if mode not in ("off", "hash", "all"):
        raise ValueError(f"FUSION_FUSED_MODE must be off/hash/all, got {mode!r}")
    return mode


# Groups per step of the fused program's lax.map.  The aggregation sponge's
# lanes are the chunk's group count, so small chunks starve the GPU: 8192
# groups give the sponge kernel 256 programs of 32 lanes (PERF.md).
GROUP_CHUNK = 8192


def _fused_chunk(G: int, group_chunk: int) -> int:
    """Chunk size of the fused program's lax.map: the largest power-of-two
    fraction of ``group_chunk`` that divides G."""
    chunk = max(1, min(group_chunk, G))
    while G % chunk:
        chunk //= 2
    return chunk


def _host_prehash_forced() -> bool:
    """``FUSION_HOST_PREHASH=1`` keeps the SHA3 message prehash on the host
    (the round-2 behavior); the default word path hashes and renders the
    prehash digits on device."""
    import os

    return bool(os.environ.get("FUSION_HOST_PREHASH"))


def msg_preimage_words(params: Params, messages: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Host prep for the device prehash: ``dst + "," + message`` preimages as
    packed words (uint32[B, Wt], int32[B]).

    Wt is the tight word count for the longest message in the batch, rounded
    up to 8 words so nearby chunk maxima share one compiled shape (the device
    pads to a whole number of SHAKE rate blocks for free).  A verify call
    uploads ~(4 + len(msg)) bytes per signer instead of a full 136-byte rate
    block — the host->device transfer is the serial prefix of every verify
    call, so its size is throughput-critical over slow links.  Fully
    vectorized (no per-message Python in the packing loop).
    """
    prefix = bytes(params.sign_pre_hash_dst) + b","
    bufs = [prefix + m.encode("utf-8") for m in messages]
    B = len(bufs)
    lens = np.fromiter((len(b) for b in bufs), np.int32, B)
    L = int(lens.max(initial=1))
    Wt = -(-(-(-L // 4)) // 8) * 8  # tight words, bucketed to 8
    arr = np.zeros((B, Wt * 4), dtype=np.uint8)
    if B:
        mask = np.arange(Wt * 4) < lens[:, None]
        arr[mask] = np.frombuffer(b"".join(bufs), np.uint8)
    return arr.view("<u4"), lens


def _launch_chunks(G: int, group_chunk: int):
    """Launch-size schedule: as many full ``group_chunk`` launches as fit, then
    one remainder launch (its shape compiles separately, once)."""
    out = []
    lo = 0
    while lo < G:
        hi = min(G, lo + group_chunk)
        out.append((lo, hi))
        lo = hi
    return out


def _verify_windows(params, P, vks, messages, aggs, group_chunk, group_hash_chunk,
                    want_coeffs: bool):
    """Shared chunked-verify driver.

    The default ("all") runs the fused one-program verify.  The unfused
    structures run the SIGNER half (working set ~40 KB per signer) in
    ``group_chunk`` launches; the GROUP hash, whose lanes are the group
    count, runs over ``group_hash_chunk`` groups at once.  The lattice stage
    is chunked with the signers (its INTT coefficient buffer is the other
    large allocation).
    """
    G, N = vks.shape[0], vks.shape[1]
    d = params.degree
    vks = jnp.asarray(vks)
    aggs = jnp.asarray(aggs)
    msgs = messages if isinstance(messages, list) else list(messages)
    if len(msgs) != G * N:
        raise ValueError(f"need {G * N} messages, got {len(msgs)}")
    group_hash_chunk = max(group_chunk, (group_hash_chunk // group_chunk) * group_chunk)
    chunks = _launch_chunks(G, group_chunk)
    packed_path = P.signer_at is not None

    # Fused fast path: the whole hash half (and, in "all" mode, the lattice)
    # as ONE launch — see _pipeline_cached's fused builders.  The
    # coefficient-returning path runs the same fused hash program (the one
    # build_fleet compiles) and the lattice per chunk.
    mode = _fused_mode()
    if mode != "off" and packed_path and G % min(group_chunk, G) == 0:
        packed_full = jnp.asarray(P.prep_packed(msgs).reshape(G, N, -1))
        chunk_f = _fused_chunk(G, group_chunk)
        if mode == "all" and not want_coeffs:
            return P.fused_all(vks, packed_full, aggs, chunk_f)
        cc, c_hat_full, al = P.fused_hash(vks, packed_full, chunk_f)
        outs = [
            P.lattice_at_full(vks, c_hat_full, al, aggs, lo, hi - lo)
            for lo, hi in chunks
        ]
        verdicts = outs[0] if len(outs) == 1 else tuple(
            jnp.concatenate([o[k] for o in outs]) for k in range(3)
        )
        if not want_coeffs:
            return verdicts
        return (*verdicts, cc.reshape(G, N, d), al)
    sparts = []
    if packed_path:
        # ONE packed upload for the whole verify; every chunk slices it (and
        # vks) at a static offset inside the producer jit
        packed_full = jnp.asarray(P.prep_packed(msgs).reshape(G, N, -1))
        for lo, hi in chunks:
            sparts.append(P.signer_at(vks, packed_full, lo, hi - lo))
    else:
        for lo, hi in chunks:
            pb, pl = P.prep(msgs[lo * N : hi * N])
            pb = jnp.asarray(pb.reshape(hi - lo, N, -1))
            pl = jnp.asarray(pl.reshape(hi - lo, N))
            sparts.append(P.signer(vks[lo:hi], pb, pl))
    outs = []
    alphas = []
    for wlo, whi in _launch_chunks(G, group_hash_chunk):
        idx = [i for i, (lo, hi) in enumerate(chunks) if lo >= wlo and hi <= whi]
        if len(idx) == 1:
            tbuf, tlen = sparts[idx[0]][2], sparts[idx[0]][3]
        else:
            tbuf = jnp.concatenate([sparts[i][2] for i in idx], axis=-1)
            tlen = jnp.concatenate([sparts[i][3] for i in idx], axis=-1)
        Gw = whi - wlo
        al = P.group(tbuf.reshape(-1, Gw, N), tlen.reshape(Gw, N))
        if want_coeffs:
            alphas.append(al)
        for i in idx:
            lo, hi = chunks[i]
            outs.append(
                P.lattice_at(vks, sparts[i][1], al, aggs, lo, hi - lo, wlo)
            )
    if len(outs) == 1:
        eq, norm_ok, weight_ok = outs[0]
    else:
        eq, norm_ok, weight_ok = (
            jnp.concatenate([o[k] for o in outs]) for k in range(3)
        )
    if not want_coeffs:
        return eq, norm_ok, weight_ok
    cc = (
        sparts[0][0]
        if len(sparts) == 1
        else jnp.concatenate([p[0] for p in sparts])
    ).reshape(G, N, d)
    al = alphas[0] if len(alphas) == 1 else jnp.concatenate(alphas)
    return eq, norm_ok, weight_ok, cc, al


def verify_batch_device(
    params: Params,
    vks,
    messages: Sequence[str],
    aggs,
    *,
    group_chunk: int = GROUP_CHUNK,
    group_hash_chunk: int = 16384,
):
    """Grouped verify with the full hash pipeline on device.

    vks int32[G, N, 2, d] (sorted within each group by vk repr — the
    reference's canonical order, fusion.py:661-663); messages flat G*N strings
    in the same order; aggs int32[G, rank, d].
    Returns (eq, norm_ok, weight_ok) bool[G] device arrays.

    ``group_chunk`` bounds the batch of one step of the fused program's
    lax.map (its device-memory working set).
    """
    P = get_pipeline(params, vks.shape[1])
    return _verify_windows(
        params, P, vks, messages, aggs, group_chunk, group_hash_chunk, False
    )


def derive_coeffs_device(
    params: Params, vks, messages: Sequence[str], aggs, *,
    group_chunk: int = GROUP_CHUNK,
):
    """Debug/test entry: returns (eq, norm_ok, weight_ok, challenge coeffs
    int32[G, N, d], alpha coeffs int32[G, N, d])."""
    P = get_pipeline(params, vks.shape[1])
    return _verify_windows(
        params, P, vks, messages, aggs, group_chunk, group_chunk, True
    )
