#!/usr/bin/env python
"""Two-signer lifecycle walkthrough (the tensor-native analogue of the reference's
misc/demo.py): setup -> keygen -> sign -> aggregate -> verify, shown on both API
levels."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root import

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu.interop import api


def batched_api_demo():
    print("=== tensor-native batched API ===")
    params = ftpu.fusion_setup(256, seed=42)
    keys = ftpu.keygen(params, seeds=[1, 2])
    messages = ["Hello world!", "Hello sailor!"]
    sigs = ftpu.sign(params, keys, messages)
    agg = ftpu.aggregate(params, keys.vk_np(), messages, sigs.sig)
    ok, reason = ftpu.verify(params, keys.vk_np(), messages, agg)
    print(f"aggregate of {len(keys)} signatures verifies: {ok} {reason!r}")
    assert ok


def object_api_demo():
    print("=== object compat API (reference surface) ===")
    params = api.fusion_setup(128, seed=42)
    key_one = api.keygen(params, seed=7)
    key_two = api.keygen(params, seed=8)
    m1, m2 = "Hello world!", "Hello sailor!"
    sig_one = api.sign(params, key_one, m1)
    sig_two = api.sign(params, key_two, m2)
    agg = api.aggregate(params, [key_one[1], key_two[1]], [m1, m2], [sig_one, sig_two])
    ok, reason = api.verify(params, [key_one[1], key_two[1]], [m1, m2], agg)
    print(f"aggregate of 2 signatures verifies: {ok} {reason!r}")
    assert ok


if __name__ == "__main__":
    batched_api_demo()
    object_api_demo()
