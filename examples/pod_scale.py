#!/usr/bin/env python
"""Pod-scale configuration walkthrough (BASELINE.json configs 4 & 5).

Demonstrates the multi-chip wiring for the large configurations:
  * secpar=256 with 2^16 one-time keys sharded across a device mesh (config 4);
  * a 2^20-signature workload as batched aggregation groups with psum-reduced
    aggregate signatures (config 5; multi-host runs add
    parallel.distributed.initialize() per host — shard_map code is unchanged).

Shapes default to a scaled-down smoke size so this also runs on the 8-device
CPU simulator:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/pod_scale.py
Pass --keys 65536 on real hardware.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _throughput(params, mesh, B, reps=3):
    """min-wall-clock keys/s of the sharded lifecycle step on ``mesh``."""
    from fusion_cryptography_tpu.parallel import sharded_lifecycle_step

    step, prepare, _ = sharded_lifecycle_step(params, mesh)
    sk, c, al = prepare(B, seed=0)
    vk, *_ = step(sk, c, al)
    vk.block_until_ready()
    best = None
    for _ in range(reps):
        t0 = time.time()
        vk, *_ = step(sk, c, al)
        vk.block_until_ready()
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    return B / best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, default=1024, help="total one-time keys (config 4: 65536)")
    ap.add_argument("--secpar", type=int, default=256)
    ap.add_argument("--efficiency", action="store_true",
                    help="emit the scaling-efficiency JSON line "
                         "(throughput_N / (N * throughput_1))")
    args = ap.parse_args()

    import jax

    from fusion_cryptography_tpu import fusion_setup
    from fusion_cryptography_tpu.parallel import make_mesh, sharded_lifecycle_step
    from fusion_cryptography_tpu.parallel.distributed import initialize

    initialize()  # no-op single-process; per-host bootstrap on several hosts

    n_dev = len(jax.devices())
    mesh = make_mesh()  # (dp, tp) over all devices
    print(f"devices: {n_dev}, mesh: {dict(mesh.shape)}")

    params = fusion_setup(args.secpar, 42)
    step, prepare, rank_p = sharded_lifecycle_step(params, mesh)

    B = args.keys
    sk, c, al = prepare(B, seed=0)
    t0 = time.time()
    vk, agg, eq, norm_ok, w_ok = step(sk, c, al)
    vk.block_until_ready()
    print(f"first step (incl. compile): {time.time()-t0:.1f}s")
    t0 = time.time()
    vk, agg, eq, norm_ok, w_ok = step(sk, c, al)
    vk.block_until_ready()
    dt = time.time() - t0
    print(
        f"sharded keygen+sign+aggregate+verify for {B} keys: {dt*1e3:.1f} ms "
        f"({B/dt:.0f} keys/s across {n_dev} devices)"
    )
    assert bool(eq) and bool(norm_ok) and bool(w_ok)
    print("lifecycle verified:", bool(eq))

    if args.efficiency:
        # Scaling efficiency (BASELINE.json north-star clause: >= 80% from 1
        # host to N hosts): same per-device batch at mesh sizes 1 and n_dev,
        # efficiency = throughput_N / (N * throughput_1).  On the virtual
        # 8-device CPU mesh the "devices" share physical cores, so this
        # measures the sharding/collective overhead structure rather than
        # real device scaling; on a multi-GPU host the same invocation
        # reports true scaling.
        import json

        from fusion_cryptography_tpu.parallel import make_mesh as mk

        per_dev = B  # weak scaling: constant per-device batch
        mesh1 = mk((1, 1), devices=jax.devices()[:1])
        thr1 = _throughput(params, mesh1, per_dev)
        thr_n = _throughput(params, mesh, per_dev * n_dev)
        eff = thr_n / (n_dev * thr1)
        line = {
            "metric": "scaling_efficiency_lifecycle",
            "value": round(eff, 4),
            "unit": f"throughput_{n_dev}dev / ({n_dev} x throughput_1dev)",
            "devices": n_dev,
            "keys_per_s_1dev": round(thr1, 1),
            f"keys_per_s_{n_dev}dev": round(thr_n, 1),
        }
        if jax.default_backend() == "cpu":
            line["note"] = (
                "virtual CPU mesh: devices share physical cores, so this "
                "bounds sharding overhead, not real device scaling"
            )
        print(json.dumps(line))


if __name__ == "__main__":
    main()
