#!/usr/bin/env python
"""On-card smoke test: the main path end to end on one NVIDIA GPU.

Usage: python chip_smoke.py               (one card: every phase below)
       python chip_smoke.py --four-cards  (four cards: the multi-device paths)

Phases, in order; any failure ends the run with a nonzero exit code:

1. device check: JAX's default device must be a GPU (no CPU fallback);
2. the fused SHAKE256 kernel (ops/keccak_triton.py) compiled at production
   widths (challenge sponge 32,768 lanes, aggregation sponge 8,192 lanes),
   compared with hashlib on sampled lanes and with the XLA sponge on all;
3. fleet build (scheme/device_setup.build_fleet) and fused grouped verify
   (scheme/device_pipeline.verify_batch_device) at secpar 256, N=4,
   G=8192: every valid aggregate accepted, tampered ones rejected, challenge
   and alpha coefficients equal to the host oracle; then a secpar-128 pass
   at G=1024;
4. the frozen KAT corpus regenerated through the object API (interop/api),
   byte for byte;
5. informational timings, each beside the card's name and power limit.

The last line of standard output is one JSON object naming the device.
"""
import argparse
import filecmp
import json
import runpy
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def card_name_and_power_limit() -> str:
    """``nvidia-smi`` name and power limit of the first card (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check_device(jax, count: int = 1):
    """The default device must be a GPU, and ``count`` of them present."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX's default device is "
            f"{devs[0].platform}"
        )
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {len(devs)}")
    return devs


def _random_payloads(jax, rows: int, B: int, lo: int, hi: int, seed: int):
    """Device-made ragged payloads: uint32[rows, B] words, lengths in [lo, hi]."""
    import jax.numpy as jnp

    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    words = jax.random.bits(k1, (rows, B), jnp.uint32)
    lens = jax.random.randint(k2, (B,), lo, hi + 1, jnp.int32)
    return words, lens


def phase_sponges(jax, params, n_signers: int, lanes_ch: int, lanes_ag: int):
    """The fused kernel at both production widths vs hashlib and XLA."""
    import hashlib

    import numpy as np

    from fusion_cryptography_tpu.interop import device_serial as ds
    from fusion_cryptography_tpu.ops import keccak
    from fusion_cryptography_tpu.ops.keccak_triton import shake256_words_triton
    from fusion_cryptography_tpu.scheme import device_pipeline as dp

    g = dp._geometries(params)
    agg_spec = ds.agg_preimage_spec(params, n_signers, g["tri_spec"].out_max)
    agg_min = ds.spec_min_total(agg_spec, [g["tri_min"]] * n_signers)
    cases = [
        ("challenge", lanes_ch, g["ch_spec"], g["ch_min"],
         -(-g["n_xof_ch_used"] // 4)),
        ("aggregation", lanes_ag, agg_spec, agg_min,
         -(-(n_signers * g["block_ag"]) // 4)),
    ]
    timings = {}
    for name, B, spec, lo, n_words in cases:
        rows = dp._pad_rate(spec.out_max) // 4
        words, lens = _random_payloads(jax, rows, B, lo, spec.out_max, seed=B)
        kern = jax.jit(lambda w, n, k=n_words: shake256_words_triton(w, n, k))
        xla = jax.jit(lambda w, n, k=n_words: keccak.shake256_squeeze_words(
            keccak.shake256_absorb_words(w, n), k))
        for label, fn in (("triton", kern), ("xla", xla)):
            t0 = time.time()
            compiled = fn.lower(words, lens).compile()
            log(f"{name} sponge [{label}] B={B} rows={rows} n_words={n_words}: "
                f"compiled in {time.time() - t0:.1f}s; "
                f"memory_analysis: {compiled.memory_analysis()}")
        got = kern(words, lens).block_until_ready()
        want = xla(words, lens).block_until_ready()
        for label, fn in (("triton", kern), ("xla", xla)):
            t0 = time.perf_counter()
            for _ in range(3):
                fn(words, lens).block_until_ready()
            timings[(name, label)] = (time.perf_counter() - t0) / 3
        got_np, want_np = np.asarray(got), np.asarray(want)
        if not np.array_equal(got_np, want_np):
            bad = int(np.sum(np.any(got_np != want_np, axis=0)))
            raise AssertionError(f"{name} sponge: {bad}/{B} lanes differ from XLA")
        w_np, l_np = np.asarray(words), np.asarray(lens)
        for i in np.random.default_rng(B).choice(B, 16, replace=False):
            payload = w_np[:, i].astype("<u4").tobytes()[: l_np[i]]
            ref = np.frombuffer(hashlib.shake_256(payload).digest(4 * n_words), "<u4")
            if not np.array_equal(got_np[:, i], ref):
                raise AssertionError(f"{name} sponge lane {i} differs from hashlib")
        log(f"{name} sponge: {B} lanes equal to XLA, 16 sampled lanes equal to "
            f"hashlib; triton {timings[(name, 'triton')] * 1e3:.3f} ms, "
            f"xla {timings[(name, 'xla')] * 1e3:.3f} ms per call")
    return timings


def _tamper(params, aggs, groups):
    import jax.numpy as jnp

    idx = jnp.asarray(groups)
    return aggs.at[idx, 0, 0].set((aggs[idx, 0, 0] + 1) % params.modulus)


def _host_coeffs(params, vks, msgs, groups, N):
    """Host-oracle challenge and alpha coefficients for ``groups``."""
    import numpy as np

    from fusion_cryptography_tpu.interop import serial
    from fusion_cryptography_tpu.scheme import lifecycle as lc

    vk_np = np.asarray(vks)[groups].reshape(len(groups) * N, 2, -1)
    reprs = [serial.vk_str(params, vk_np[i]) for i in range(len(vk_np))]
    sel = [msgs[g * N + i] for g in groups for i in range(N)]
    return lc.derive_alphas_grouped(params, reprs, sel, len(groups), N)


def phase_fleet_verify(jax, secpar: int, G: int, N: int, card: str, timed: bool):
    """Fleet build + fused verify + tamper + coefficient parity."""
    import numpy as np

    import fusion_cryptography_tpu as ftpu
    from fusion_cryptography_tpu.scheme import device_pipeline as dp
    from fusion_cryptography_tpu.scheme import device_setup as dset

    params = ftpu.fusion_setup(secpar, 42)
    t0 = time.time()
    vks, msgs, aggs = dset.build_fleet(params, G, N, seed0=1)
    aggs.block_until_ready()
    log(f"secpar {secpar}: fleet of {G}x{N} built in {time.time() - t0:.1f}s "
        f"(incl. compile)")

    t0 = time.time()
    eq, norm_ok, w_ok = jax.block_until_ready(
        dp.verify_batch_device(params, vks, msgs, aggs))
    first = time.time() - t0
    for name, x in (("eq", eq), ("norm_ok", norm_ok), ("weight_ok", w_ok)):
        if not bool(np.asarray(x).all()):
            raise AssertionError(f"secpar {secpar}: {name} false on a valid aggregate")
    bad_groups = sorted({1, G // 3, (G // 2 + 7) % G, G - 1})
    eq_t, _, _ = jax.block_until_ready(dp.verify_batch_device(
        params, vks, msgs, _tamper(params, aggs, bad_groups)))
    eq_t = np.asarray(eq_t)
    want = np.ones(G, bool)
    want[bad_groups] = False
    if not np.array_equal(eq_t, want):
        raise AssertionError(f"secpar {secpar}: tampered verdicts wrong")
    log(f"secpar {secpar}: {G} valid aggregates accepted, "
        f"{len(bad_groups)} tampered rejected")

    # coefficients of the whole batch (the fused hash program the fleet build
    # compiled), against the host oracle on the first 64 groups and on
    # groups spread over the batch
    eq_c, _, _, cc_dev, al_dev = dp.derive_coeffs_device(params, vks, msgs, aggs)
    if not bool(np.asarray(eq_c).all()):
        raise AssertionError(f"secpar {secpar}: derive_coeffs_device rejected a valid aggregate")
    groups = sorted(set(range(min(64, G))) | set(range(0, G, max(1, G // 128))))
    cc_host, al_host = _host_coeffs(params, vks, msgs, groups, N)
    if not (np.array_equal(np.asarray(cc_dev)[groups], cc_host)
            and np.array_equal(np.asarray(al_dev)[groups], al_host)):
        raise AssertionError(f"secpar {secpar}: derive_coeffs_device != host oracle")
    log(f"secpar {secpar}: challenge and alpha coefficients of {len(groups)} "
        f"groups (64 contiguous + spread) equal the host oracle")

    if not timed:
        return
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        jax.block_until_ready(dp.verify_batch_device(params, vks, msgs, aggs))
    warm = (time.time() - t0) / reps
    t0 = time.time()
    _, _, aggs2 = dset.build_fleet(params, G, N, seed0=1 + 2 * G * N)
    aggs2.block_until_ready()
    fleet = time.time() - t0
    log(f"fused verify compile (first call minus warm call): "
        f"{first - warm:.2f} s [{card}]")
    log(f"fused verify warm: {warm:.4f} s per call of {G} groups [{card}]")
    log(f"verifies/s: {G / warm:.1f} [{card}]")
    log(f"fleet build keys/s: {G * N / fleet:.1f} [{card}]")


def phase_kats():
    """Regenerate the frozen KAT corpus through the object API, byte for byte."""
    frozen = ROOT / "KATs" / "reference_frozen"
    with tempfile.TemporaryDirectory() as out:
        argv = sys.argv
        sys.argv = ["generate_kat_values.py", "--out-dir", out,
                    "--seed", "20260820", "--signers", "3"]
        try:
            runpy.run_path(str(ROOT / "KATs" / "generate_kat_values.py"),
                           run_name="__main__")
        finally:
            sys.argv = argv
        names = sorted(p.name for p in frozen.glob("*.csv"))
        bad = [n for n in names
               if not filecmp.cmp(frozen / n, Path(out) / n, shallow=False)]
    if len(names) != 18 or bad:
        raise AssertionError(f"KAT drift vs the frozen corpus: {bad or names}")
    log(f"frozen KAT corpus: {len(names)} files regenerated byte for byte")


def log_compiles():
    """Log each XLA compile of a second or more, and each persistent-cache
    hit, so that a run cut by its time limit shows where its time went."""
    from jax import monitoring

    def on_duration(event, secs, **kw):
        if event == "/jax/core/compile/backend_compile_duration" and secs >= 1:
            log(f"compiled {kw.get('fun_name')} in {secs:.1f}s")
        elif event == "/jax/compilation_cache/compile_time_saved_sec":
            log(f"compile cache hit ({secs:.1f}s saved)")

    monitoring.register_event_duration_secs_listener(on_duration)


def phase_four_cards(jax, card: str, per_card: int = 8192):
    """The dp x tp lifecycle + four-step NTT dry run, then the dp-sharded
    verify on a 4-card mesh at ``per_card`` groups per card vs one card.

    The dry run's own sharded verify (2 groups per card) is left out: the
    full-width check below covers the same program at the real shape, and
    each fused verify costs about two minutes of compile on the host."""
    import numpy as np
    from jax.sharding import Mesh

    import fusion_cryptography_tpu as ftpu
    from __graft_entry__ import dryrun_multichip
    from fusion_cryptography_tpu.parallel.sharded import sharded_verify_device
    from fusion_cryptography_tpu.scheme import device_pipeline as dp
    from fusion_cryptography_tpu.scheme import device_setup as dset

    log_compiles()
    t0 = time.time()
    dryrun_multichip(4, flagship=False)
    log(f"dryrun_multichip(4): sharded lifecycle + four-step NTT bitwise "
        f"equal to one device ({time.time() - t0:.1f}s)")

    # four one-card fleets of the one-card smoke's shape, side by side
    params = ftpu.fusion_setup(256, 42)
    N = 4
    t0 = time.time()
    parts = [dset.build_fleet(params, per_card, N, seed0=1 + k * per_card * N)
             for k in range(4)]
    jax.block_until_ready([p[2] for p in parts])
    log(f"4 fleets of {per_card}x{N} built in {time.time() - t0:.1f}s (incl. compile)")
    vks = jax.numpy.concatenate([p[0] for p in parts])
    msgs = [m for p in parts for m in p[1]]
    aggs = jax.numpy.concatenate([p[2] for p in parts])
    G = 4 * per_card
    bad = [3, G // 2, G - 2]
    aggs = aggs.at[jax.numpy.asarray(bad), 0, 0].add(1)
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    log(f"sharded verify over 4 cards, G={G}: first call (compile + run)")
    t0 = time.time()
    got = jax.block_until_ready(sharded_verify_device(params, mesh, vks, msgs, aggs))
    first = time.time() - t0
    for k in range(4):
        lo, hi = k * per_card, (k + 1) * per_card
        want = dp.verify_batch_device(
            params, vks[lo:hi], msgs[lo * N : hi * N], aggs[lo:hi])
        for a, b in zip(got, want):
            if not np.array_equal(np.asarray(a)[lo:hi], np.asarray(b)):
                raise AssertionError("sharded verify differs from the one-card verify")
    rejected = np.flatnonzero(~np.asarray(got[0])).tolist()
    if rejected != bad:
        raise AssertionError(f"expected groups {bad} rejected, got {rejected}")
    t0 = time.time()
    for _ in range(3):
        jax.block_until_ready(sharded_verify_device(params, mesh, vks, msgs, aggs))
    warm = (time.time() - t0) / 3
    log(f"sharded verify over 4 cards, G={G}: bitwise equal to one card, "
        f"groups {rejected} rejected; "
        f"first call {first:.1f}s, warm {warm:.4f}s ({G / warm:.1f} verifies/s) "
        f"[{card}]")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded verify and lifecycle checks")
    args = ap.parse_args()

    import jax

    from fusion_cryptography_tpu.utils.cache import enable_compile_cache

    devs = check_device(jax, 4 if args.four_cards else 1)
    enable_compile_cache()
    card = card_name_and_power_limit()
    log(f"device: {devs[0].platform} {devs[0].device_kind} x{len(devs)}; card: {card}")

    if args.four_cards:
        phase_four_cards(jax, card)
    else:
        import fusion_cryptography_tpu as ftpu
        from fusion_cryptography_tpu import native

        log(f"native host library loaded: {native.available()}")
        t0 = time.time()
        phase_sponges(jax, ftpu.fusion_setup(256, 42), 4, 32768, 8192)
        log(f"phase 2 (sponges) done at {time.time() - t0:.0f}s")
        phase_fleet_verify(jax, 256, 8192, 4, card, timed=True)
        log(f"phase 3 (secpar 256) done at {time.time() - t0:.0f}s")
        phase_fleet_verify(jax, 128, 1024, 4, card, timed=False)
        log(f"phase 3 (secpar 128) done at {time.time() - t0:.0f}s")
        phase_kats()
        log(f"phase 4 (KATs) done at {time.time() - t0:.0f}s")

    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()
