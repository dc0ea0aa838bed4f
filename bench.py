#!/usr/bin/env python
"""Benchmark: aggregate-signature verify throughput per device, secpar=256.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Measures the END-TO-END grouped verify for G independent aggregate signatures
of N signers each, with the ENTIRE hash pipeline on the GPU
(scheme/device_pipeline.py): SHA3-256 message prehash + decimal rendering,
preimage assembly, SHAKE256 XOFs (the fused Triton sponge), challenge and
aggregation-coefficient decoding, NTTs, and the lattice equation all execute
on the device.  The only host work per timed iteration is building the raw
``dst + "," + message`` byte batch — exactly the host/device split a
production verifier would run.

Fleet construction (keygen/sign/aggregate for G*N one-time keys) also runs
on-device (scheme/device_setup.py); its warm rate is reported in ``extras``.

Every timed section ends in ``block_until_ready`` on the verdict arrays.  The
JSON line names the device (JAX's platform, kind and count, and the card's
name and power limit from ``nvidia-smi``).  The benchmark needs a GPU; only
the ``--force-cpu-devices`` rehearsal runs on the CPU, and says so.

``vs_baseline`` is the speedup over the reference CPython implementation on
this host class (BASELINE.md: verify secpar=256 N=4 ~= 0.41 s -> ~2.4
aggregate-verifies/s/core).

Usage: python bench.py [--groups G] [--signers N] [--secpar S]
                       [--host-pipeline] [--reps R] [--force-cpu-devices D]
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

REFERENCE_VERIFIES_PER_SEC = 1.0 / 0.41  # BASELINE.md, secpar=256, N=4


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=8192)
    ap.add_argument("--signers", type=int, default=4)
    ap.add_argument("--secpar", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--host-pipeline", action="store_true",
                    help="use the host-keccak hash path (scheme/lifecycle) "
                         "instead of the on-device pipeline")
    ap.add_argument("--force-cpu-devices", type=int, default=0,
                    help="rehearsal: run on N virtual CPU devices (exercises "
                         "the multi-device sharded branch without a GPU)")
    args = ap.parse_args()

    if args.force_cpu_devices:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.force_cpu_devices}"
        )

    import jax

    if args.force_cpu_devices:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from fusion_cryptography_tpu.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.force_cpu_devices:
        raise SystemExit(f"bench: needs a GPU; JAX's default device is {dev.platform}")
    enable_compile_cache()
    card = None
    if dev.platform == "gpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]

    import fusion_cryptography_tpu as ftpu
    from fusion_cryptography_tpu import native
    from fusion_cryptography_tpu.scheme import device_pipeline as dp
    from fusion_cryptography_tpu.scheme import device_setup as dset

    G, N = args.groups, args.signers
    log(f"native host lib: {native.available()}; device: {dev}; card: {card}")
    params = ftpu.fusion_setup(args.secpar, 42)

    # ---- build G aggregate groups on device ---------------------------------
    # pass 1 pays the stage compiles (shared with the verifier's jits); pass 2
    # re-runs with fresh seeds for the warm keygen+sign+aggregate metric
    t0 = time.time()
    vks, msgs, aggs = dset.build_fleet(params, G, N, seed0=1)
    aggs.block_until_ready()
    log(f"on-device keygen+sign+aggregate for {G*N} keys: {time.time()-t0:.1f}s "
        f"(incl. compile)")
    t0 = time.time()
    vks2, msgs2, aggs2 = dset.build_fleet(params, G, N, seed0=1 + 2 * G * N)
    aggs2.block_until_ready()
    fleet_dt = time.time() - t0
    fleet_rate = G * N / fleet_dt
    log(f"warm keygen+sign+aggregate: {G*N} keys in {fleet_dt:.2f}s "
        f"-> {fleet_rate:,.0f} keys/s/device")
    del vks2, msgs2, aggs2

    # Multi-device: with several devices attached, run the sharded flagship
    # pipeline (shard_map over dp on the groups axis) and report scaling
    # efficiency alongside the single-device number.
    n_dev = len(jax.devices())
    sharding_extras = {}
    if n_dev > 1 and not args.host_pipeline:
        from jax.sharding import Mesh

        from fusion_cryptography_tpu.parallel.sharded import sharded_verify_device

        mesh = Mesh(np.array(jax.devices()), ("dp",))

        def run_sharded():
            eq, _, _ = sharded_verify_device(params, mesh, vks, msgs, aggs)
            return eq

        assert np.asarray(run_sharded().block_until_ready()).all()
        t0 = time.time()
        eqs = [run_sharded() for _ in range(args.reps)]
        jax.block_until_ready(eqs)
        dt = time.time() - t0
        for e in eqs:
            assert np.asarray(e).all()
        sharded_vps = args.reps * G / dt
        sharding_extras = {
            "sharded_verifies_per_s": round(sharded_vps, 1),
            "n_devices": n_dev,
        }
        log(f"sharded over {n_dev} devices: {sharded_vps:,.0f} verifies/s")

    if args.host_pipeline:
        from fusion_cryptography_tpu.interop import serial
        from fusion_cryptography_tpu.scheme import lifecycle as lc

        vk_np = np.asarray(vks).reshape(G * N, 2, -1)
        reprs = [serial.vk_str(params, vk_np[i]) for i in range(G * N)]

        def run_e2e():
            cc, al = lc.derive_alphas_grouped(params, reprs, msgs, G, N)
            eq, _, _ = ftpu.verify_batch(
                params, vks, jnp.asarray(cc), jnp.asarray(al), aggs
            )
            return eq
    else:
        def run_e2e():
            eq, _, _ = dp.verify_batch_device(params, vks, msgs, aggs)
            return eq

    # warm (compiles)
    t0 = time.time()
    eq = np.asarray(run_e2e().block_until_ready())
    assert eq.all(), "benchmark aggregates failed to verify"
    log(f"verify warm (incl. compile): {time.time()-t0:.1f}s")

    times = []
    for _ in range(args.reps):
        t0 = time.time()
        eq = run_e2e().block_until_ready()
        times.append(time.time() - t0)
        assert np.asarray(eq).all()
    log(f"per-call latency: {min(times):.3f}s for {G} verifies "
        f"({[f'{t:.3f}' for t in times]})")
    # Steady-state throughput: R back-to-back verify calls with ONE final
    # sync — call k+1's host prep overlaps call k's device tail, exactly how
    # a production verifier drains a queue.  This is the headline metric;
    # per-call latency is logged above.
    R = max(args.reps, 5)
    t0 = time.time()
    eqs = [run_e2e() for _ in range(R)]
    jax.block_until_ready(eqs)
    dt = time.time() - t0
    for e in eqs:
        assert np.asarray(e).all()
    vps = R * G / dt
    metric = ("aggregate_verify_throughput_hostpipe" if args.host_pipeline
              else "aggregate_verify_throughput")
    if "sharded_verifies_per_s" in sharding_extras:
        sharding_extras["scaling_efficiency"] = round(
            sharding_extras["sharded_verifies_per_s"] / (vps * n_dev), 3
        )
    log(f"steady-state: {R*G} verifies in {dt:.3f}s")
    print(json.dumps({
        "metric": f"{metric}_secpar{args.secpar}_N{N}",
        "value": round(vps, 2),
        "unit": "verifies/s/device",
        "vs_baseline": round(vps / REFERENCE_VERIFIES_PER_SEC, 1),
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": n_dev,
            "card": card,
        },
        # secondary metric: on-device keygen+sign+aggregate fleet construction
        # (reference keygen alone is ~0.8 s/key single-core, BASELINE.md)
        "extras": {
            "keygen_sign_aggregate_keys_per_s": round(fleet_rate, 1),
            "keygen_sign_aggregate_keys": G * N,
            **sharding_extras,
        },
    }))


if __name__ == "__main__":
    main()
