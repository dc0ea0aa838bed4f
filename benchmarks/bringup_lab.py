#!/usr/bin/env python
"""GPU bring-up measurements for the verify pipeline (secpar 256, N=4).

Parts (``--parts``, default all):

  sponge   each sponge of ``--impls`` alone at the production widths of
           ``--widths`` (challenge 32,768 lanes, aggregation 8,192 lanes):
           compile seconds, seconds per call, permutations/s and bytes/s.
           ``triton:U:BL`` is the fused kernel with round unroll U and BL
           lanes per program; ``xla`` the XLA scan sponge, whose round
           unroll is ``FUSION_KECCAK_UNROLL``
  verify   the fused verify at G=8192 for each sponge of ``--sponges`` x
           each ``--chunks`` group chunk
  lattice  the stage-sweep lattice check (INTT + norm/weight) alone
  unroll   the on-device prehash (SHA3 + decimal render) at 32,768 lanes
           for each Keccak round unroll of ``--unrolls``: compile and run

Needs a GPU; one process.  Every result line (JSON, on standard output and
in ``--out`` if given) names the card.  A variant whose compile may be slow
is best run in a process of its own under ``timeout``.

Usage: python benchmarks/bringup_lab.py [--parts sponge verify ...] [--reps R]
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", nargs="*",
                    default=["sponge", "verify", "lattice", "unroll"])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--groups", type=int, default=8192)
    ap.add_argument("--chunks", type=int, nargs="*", default=[512, 2048, 8192])
    ap.add_argument("--sponges", nargs="*", default=["triton", "xla"])
    ap.add_argument("--impls", nargs="*",
                    default=["triton:4:32", "triton:4:64", "triton:4:128", "xla"])
    ap.add_argument("--widths", nargs="*", default=["challenge", "aggregation"])
    ap.add_argument("--unrolls", type=int, nargs="*", default=[2, 4])
    ap.add_argument("--out", help="also append each JSON result line to this file")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from fusion_cryptography_tpu.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bringup_lab: needs a GPU, default device is {dev.platform}")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    def emit(**rec):
        rec = {"card": card, "device_kind": dev.device_kind, **rec}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def timed(fn, *a, reps=args.reps):
        jax.block_until_ready(fn(*a))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*a)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps

    import fusion_cryptography_tpu as ftpu
    from fusion_cryptography_tpu.interop import device_serial as ds
    from fusion_cryptography_tpu.ops import keccak
    from fusion_cryptography_tpu.ops import ragged_words as rw
    from fusion_cryptography_tpu.ops.keccak_triton import shake256_words_triton
    from fusion_cryptography_tpu.scheme import device_pipeline as dp
    from fusion_cryptography_tpu.scheme import device_setup as dset

    params = ftpu.fusion_setup(256, 42)
    G, N = args.groups, 4
    g = dp._geometries(params)

    if "sponge" in args.parts:
        agg_spec = ds.agg_preimage_spec(params, N, g["tri_spec"].out_max)
        agg_min = ds.spec_min_total(agg_spec, [g["tri_min"]] * N)
        for name, B, spec, lo, n_words in [
            ("challenge", 4 * G, g["ch_spec"], g["ch_min"], -(-g["n_xof_ch_used"] // 4)),
            ("aggregation", G, agg_spec, agg_min, -(-(N * g["block_ag"]) // 4)),
        ]:
            if name not in args.widths:
                continue
            rows = dp._pad_rate(spec.out_max) // 4
            k1, k2 = jax.random.split(jax.random.PRNGKey(B))
            words = jax.random.bits(k1, (rows, B), jnp.uint32)
            lens = jax.random.randint(k2, (B,), lo, spec.out_max + 1, jnp.int32)
            out_blocks = -(-n_words // keccak.RATE_WORDS)
            perms = int(np.sum(np.asarray(lens) // keccak.RATE + 1)) + B * (out_blocks - 1)
            nbytes = 4 * rows * B + 4 * out_blocks * keccak.RATE_WORDS * B
            want = None
            for label in args.impls:
                if label == "xla":
                    label = f"xla:{keccak._round_unroll()}"
                    fn = jax.jit(lambda w, n: keccak.shake256_squeeze_words(
                        keccak.shake256_absorb_words(w, n), n_words))
                else:
                    _, u, bl = label.split(":")
                    fn = jax.jit(lambda w, n, u=int(u), bl=int(bl): shake256_words_triton(
                        w, n, n_words, unroll=u, block_lanes=bl))
                t0 = time.time()
                fn.lower(words, lens).compile()
                compile_s = time.time() - t0
                out = np.asarray(fn(words, lens))
                if want is None:
                    import hashlib

                    w_np, l_np = np.asarray(words), np.asarray(lens)
                    for i in range(0, B, B // 8):
                        ref = np.frombuffer(hashlib.shake_256(
                            w_np[:, i].astype("<u4").tobytes()[: l_np[i]]
                        ).digest(4 * n_words), "<u4")
                        assert np.array_equal(out[:, i], ref), (label, i)
                    want = out
                assert np.array_equal(out, want), label
                s = timed(fn, words, lens)
                emit(part="sponge", sponge=name, impl=label, lanes=B, rows=rows,
                     n_words=n_words, compile_s=compile_s, seconds=s,
                     perms_per_s=perms / s, bytes_per_s=nbytes / s)

    if "verify" in args.parts or "lattice" in args.parts:
        vks, msgs, aggs = dset.build_fleet(params, G, N, seed0=1)
        jax.block_until_ready(aggs)

    if "verify" in args.parts:
        variants = [(sp, c) for sp in args.sponges for c in args.chunks]
        for sweep in range(2):
            for sp, chunk in variants:
                P = dp._pipeline_cached(params, N, True, True, sp)

                def run(P=P, chunk=chunk):
                    packed = jnp.asarray(P.prep_packed(msgs).reshape(G, N, -1))
                    return P.fused_all(vks, packed, aggs, chunk)

                t0 = time.time()
                eq, nok, wok = jax.block_until_ready(run())
                first = time.time() - t0
                assert bool(np.asarray(eq).all() & np.asarray(nok).all()
                            & np.asarray(wok).all()), (sp, chunk)
                s = timed(run)
                emit(part="verify", sweep=sweep, sponge=sp, group_chunk=chunk,
                     groups=G, first_call_s=first, seconds=s,
                     verifies_per_s=G / s)

    if "lattice" in args.parts:
        P = dp.get_pipeline(params, N)
        packed = jnp.asarray(P.prep_packed(msgs).reshape(G, N, -1))
        _, c_hat_u, al = P.fused_hash(vks, packed, dp._fused_chunk(G, dp.GROUP_CHUNK))
        F = params.plan.field
        from fusion_cryptography_tpu.ops.ntt import ntt_inv_u

        @jax.jit
        def intt_norm_weight(a):
            coef = F.to_centered(ntt_inv_u(params.plan, F.to_unsigned(a)))
            return (jnp.max(jnp.abs(coef), axis=(-2, -1)),
                    jnp.max(jnp.sum((coef != 0).astype(jnp.int32), axis=-1), axis=-1))

        for chunk in args.chunks:
            nl = G // chunk
            lat = jax.jit(lambda v, c, a_, g_, nl=nl, chunk=chunk: jax.lax.map(
                lambda x: P.lattice(*x),
                (v.reshape(nl, chunk, N, 2, -1), c.reshape(nl, chunk * N, -1),
                 a_.reshape(nl, chunk, N, -1), g_.reshape(nl, chunk, *g_.shape[1:]))))
            s = timed(lat, vks, c_hat_u, al, aggs)
            emit(part="lattice", stage="j_lattice", group_chunk=chunk, groups=G,
                 seconds=s, us_per_group=1e6 * s / G)
        s = timed(intt_norm_weight, aggs)
        emit(part="lattice", stage="intt_norm_weight", groups=G, seconds=s,
             us_per_group=1e6 * s / G,
             agg_bytes=int(aggs.size) * 4)

    if "unroll" in args.parts:
        B = 4 * G
        msgs_u = [f"group{i // N}:msg{i % N}" for i in range(B)]
        mw, ml = dp.msg_preimage_words(params, msgs_u)
        Wt = mw.shape[1]
        pad = dp._pad_rate(Wt * 4) // 4 - Wt
        mw_t = jnp.asarray(np.pad(mw.T, ((0, pad), (0, 0))))
        ml_d = jnp.asarray(ml)
        for u in args.unrolls:
            os.environ["FUSION_KECCAK_UNROLL"] = str(u)  # read at trace time
            fn = jax.jit(lambda w, n: rw.render_bigint_dec_w(
                keccak.sha3_256_words(w, n)).buf)
            t0 = time.time()
            fn.lower(mw_t, ml_d).compile()
            compile_s = time.time() - t0
            s = timed(fn, mw_t, ml_d)
            emit(part="unroll", keccak_unroll=u, lanes=B, compile_s=compile_s,
                 seconds=s)


if __name__ == "__main__":
    main()
