#!/usr/bin/env python
"""BASELINE.json config 3: secpar=256 batched aggregate of 2^10 signatures,
single-device NTT-domain verify.

One aggregation group with N=1024 signers (capacity at secpar=256 is 2818):
batched keygen + device-hash sign, host-pipeline alpha derivation for the
single giant group, NTT-domain aggregate sum and verify on the device.

Usage: python benchmarks/config3_aggregate1k.py [--signers 1024]
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--signers", type=int, default=1024)
    ap.add_argument("--secpar", type=int, default=256)
    args = ap.parse_args()

    import jax

    from fusion_cryptography_tpu.utils.cache import enable_compile_cache

    print(f"device: {jax.devices()[0].platform} {jax.devices()[0].device_kind}")
    enable_compile_cache()

    import fusion_cryptography_tpu as ftpu

    N = args.signers
    params = ftpu.fusion_setup(args.secpar, 42)
    assert N <= params.capacity, (N, params.capacity)
    msgs = [f"c3:{i}" for i in range(N)]

    t0 = time.time()
    keys = ftpu.keygen(params, list(range(1, N + 1)))
    sigs = ftpu.sign(params, keys, msgs)
    sigs.sig.block_until_ready()
    print(f"keygen+sign {N} keys: {time.time()-t0:.2f}s", flush=True)

    t0 = time.time()
    agg = ftpu.aggregate(params, keys.vk_np(), msgs, sigs.sig)
    agg_np = np.asarray(agg)
    print(f"aggregate of {N} signatures: {time.time()-t0:.2f}s "
          f"(one rank x d tensor, {agg_np.nbytes} bytes)", flush=True)

    t0 = time.time()
    ok, why = ftpu.verify(params, keys.vk_np(), msgs, agg)
    print(f"verify N={N}: ok={ok} in {time.time()-t0:.2f}s", flush=True)
    assert ok, why

    # tamper check: any coefficient perturbation must fail
    bad = agg_np.copy()
    bad[0, 0] += 1
    ok2, why2 = ftpu.verify(params, keys.vk_np(), msgs, bad)
    assert not ok2 and why2, "tampered aggregate must fail"
    print(f"tamper rejected: {why2!r}")


if __name__ == "__main__":
    main()
