"""Word-carrier assembly + sponge vs the byte path and hashlib (bit-exactness).

The packed-word pipeline (ops/ragged_words + device_serial.assemble_chunks_words
+ keccak.shake256_absorb_words/squeeze_words) must reproduce the byte-carrier
lane-major path byte-for-byte for every spec and every ragged shape, and the
sponge must match ``hashlib.shake_256`` for every payload length class.
"""
from hashlib import shake_256

import numpy as np
import pytest

import jax.numpy as jnp

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu.interop import device_serial as ds
from fusion_cryptography_tpu.ops import ragged_words as rw
from fusion_cryptography_tpu.ops.keccak import (
    RATE,
    RATE_WORDS,
    shake256_absorb_words,
    shake256_squeeze_lanes_lm,
    shake256_squeeze_words,
)


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.integers(0, 256, size=(37, 6), dtype=np.uint8))
    w = rw.pack_bytes_to_words(b)
    assert w.shape == (10, 6)
    back = rw.unpack_words_to_bytes(w, 37)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(b))


def test_shift_left_w_matches_bytes():
    rng = np.random.default_rng(1)
    W, B = 52, 8
    max_s = 37
    by = rng.integers(0, 256, size=(W, B), dtype=np.uint8)
    s = rng.integers(0, max_s + 1, size=(B,)).astype(np.int32)
    w = rw.pack_bytes_to_words(jnp.asarray(by))
    shifted = rw.shift_left_w(w, jnp.asarray(s), max_s)
    got = np.asarray(rw.unpack_words_to_bytes(shifted, W))
    want = np.zeros_like(by)
    for b in range(B):
        k = int(s[b])
        want[: W - k, b] = by[k:, b]
    np.testing.assert_array_equal(got, want)


def test_render_decimal_cells_w_matches_str():
    rng = np.random.default_rng(3)
    vals = np.concatenate(
        [
            np.array([0, 1, -1, 9, 10, -10, 99, 100, 10**9, -(10**9), 1073732864, -1073732864]),
            rng.integers(-(2**30), 2**30, size=52),
        ]
    ).astype(np.int32)
    K = len(vals)
    cells = rw.render_decimal_cells_w(jnp.asarray(vals[:, None]), b", ")
    by = np.asarray(rw.unpack_words_to_bytes(cells.buf, cells.max_len))  # [K, W, 1]
    lens = np.asarray(cells.length)
    for k, v in enumerate(vals):
        want = b", " + str(int(v)).encode()
        assert lens[k, 0] == len(want)
        assert bytes(by[k, : len(want), 0]) == want
        assert not by[k, len(want):, 0].any(), f"scratch not zero for {v}"


@pytest.mark.parametrize("secpar", [128, 256])
def test_assemble_words_matches_bytes_challenge(secpar):
    params = ftpu.fusion_setup(secpar, 11)
    rng = np.random.default_rng(secpar)
    B, d = 6, params.degree
    q = params.modulus
    vks = rng.integers(-(q // 2), q // 2 + 1, size=(2 * d, B)).astype(np.int32)
    vks[:, 0] = 0  # min-width numbers
    pre = np.zeros((ds.PREHASH_W, B), dtype=np.uint8)
    pre_len = np.zeros(B, dtype=np.int32)
    for k in range(B):
        s = str(rng.integers(0, 10**18) if k else 0).encode()
        pre[: len(s), k] = np.frombuffer(s, dtype=np.uint8)
        pre_len[k] = len(s)
    spec = ds.challenge_preimage_spec(params)
    bounds = [(1, ds.PREHASH_W)]

    buf_b, tot_b = ds.assemble_chunks_lm(
        spec, values=jnp.asarray(vks), extras=[(jnp.asarray(pre), jnp.asarray(pre_len))],
        extra_bounds=bounds,
    )
    pre_w = rw.pack_bytes_to_words(jnp.asarray(pre))
    buf_w, tot_w = ds.assemble_chunks_words(
        spec, values=jnp.asarray(vks), extras=[(pre_w, jnp.asarray(pre_len))],
        extra_bounds=bounds,
    )
    np.testing.assert_array_equal(np.asarray(tot_w), np.asarray(tot_b))
    got = np.asarray(rw.unpack_words_to_bytes(buf_w, spec.out_max))
    np.testing.assert_array_equal(got, np.asarray(buf_b))


def test_assemble_words_matches_bytes_triple_and_agg():
    params = ftpu.fusion_setup(256, 11)
    rng = np.random.default_rng(7)
    N = 3
    G = 2
    B = G * N
    d = params.degree
    q = params.modulus
    tri_spec = ds.triple_spec(params)
    tvals = rng.integers(-(q // 2), q // 2 + 1, size=(3 * d, B)).astype(np.int32)
    pre = np.zeros((ds.PREHASH_W, B), dtype=np.uint8)
    pre_len = np.zeros(B, dtype=np.int32)
    for k in range(B):
        s = str(int.from_bytes(rng.integers(0, 256, 25, dtype=np.uint8).tobytes(), "little") + 1).encode()
        pre[: len(s), k] = np.frombuffer(s, dtype=np.uint8)
        pre_len[k] = len(s)
    bounds = [(1, ds.PREHASH_W)]

    tbuf_b, tlen_b = ds.assemble_chunks_lm(
        tri_spec, values=jnp.asarray(tvals),
        extras=[(jnp.asarray(pre), jnp.asarray(pre_len))], extra_bounds=bounds,
    )
    pre_w = rw.pack_bytes_to_words(jnp.asarray(pre))
    tbuf_w, tlen_w = ds.assemble_chunks_words(
        tri_spec, values=jnp.asarray(tvals), extras=[(pre_w, jnp.asarray(pre_len))],
        extra_bounds=bounds,
    )
    np.testing.assert_array_equal(np.asarray(tlen_w), np.asarray(tlen_b))
    np.testing.assert_array_equal(
        np.asarray(rw.unpack_words_to_bytes(tbuf_w, tri_spec.out_max)),
        np.asarray(tbuf_b),
    )

    # nest the triples into the aggregation preimage
    agg_spec = ds.agg_preimage_spec(params, N, tri_spec.out_max)
    tri_min = ds.spec_min_total(tri_spec, [1])
    tri_bounds = [(tri_min, tri_spec.out_max)] * N
    tb3 = np.asarray(tbuf_b).reshape(-1, G, N)
    tl3 = np.asarray(tlen_b).reshape(G, N)
    extras_b = [(jnp.asarray(tb3[:, :, k]), jnp.asarray(tl3[:, k])) for k in range(N)]
    gbuf_b, gtot_b = ds.assemble_chunks_lm(agg_spec, extras=extras_b, extra_bounds=tri_bounds)

    tw3 = np.asarray(tbuf_w).reshape(-1, G, N)
    extras_w = [(jnp.asarray(tw3[:, :, k]), jnp.asarray(tl3[:, k])) for k in range(N)]
    gbuf_w, gtot_w = ds.assemble_chunks_words(agg_spec, extras=extras_w, extra_bounds=tri_bounds)
    np.testing.assert_array_equal(np.asarray(gtot_w), np.asarray(gtot_b))
    np.testing.assert_array_equal(
        np.asarray(rw.unpack_words_to_bytes(gbuf_w, agg_spec.out_max)),
        np.asarray(gbuf_b),
    )


def test_shared_vk_subtree_fold_matches_specs():
    """fold_challenge_preimage_w / fold_triple_w (one shared str(vk) chunk)
    must be byte-identical to the flat-spec word evaluation."""
    params = ftpu.fusion_setup(256, 3)
    rng = np.random.default_rng(11)
    B, d = 4, params.degree
    q = params.modulus
    vk2d = rng.integers(-(q // 2), q // 2 + 1, size=(2 * d, B)).astype(np.int32)
    c_hat = rng.integers(-(q // 2), q // 2 + 1, size=(d, B)).astype(np.int32)
    pre = np.zeros((ds.PREHASH_W, B), dtype=np.uint8)
    pre_len = np.zeros(B, dtype=np.int32)
    for k in range(B):
        s = str(int.from_bytes(rng.integers(0, 256, 32, dtype=np.uint8).tobytes(), "little")).encode()
        pre[: len(s), k] = np.frombuffer(s, dtype=np.uint8)
        pre_len[k] = len(s)
    bounds = [(1, ds.PREHASH_W)]
    pre_w = rw.pack_bytes_to_words(jnp.asarray(pre))

    ch_spec = ds.challenge_preimage_spec(params)
    tri_spec = ds.triple_spec(params)
    want_ch, want_cht = ds.assemble_chunks_words(
        ch_spec, values=jnp.asarray(vk2d), extras=[(pre_w, jnp.asarray(pre_len))],
        extra_bounds=bounds,
    )
    tvals = np.concatenate([vk2d, c_hat], axis=0)
    want_tri, want_trit = ds.assemble_chunks_words(
        tri_spec, values=jnp.asarray(tvals), extras=[(pre_w, jnp.asarray(pre_len))],
        extra_bounds=bounds,
    )

    vk_chunk = ds.vk_chunk_w(params, jnp.asarray(vk2d))
    pre_chunk = rw.WChunk(buf=pre_w, length=jnp.asarray(pre_len), max_len=ds.PREHASH_W, min_len=1)
    got_ch, got_cht = ds.fold_challenge_preimage_w(params, vk_chunk, pre_chunk)
    got_tri, got_trit = ds.fold_triple_w(params, vk_chunk, pre_chunk, jnp.asarray(c_hat))
    np.testing.assert_array_equal(np.asarray(got_cht), np.asarray(want_cht))
    np.testing.assert_array_equal(np.asarray(got_ch), np.asarray(want_ch))
    np.testing.assert_array_equal(np.asarray(got_trit), np.asarray(want_trit))
    np.testing.assert_array_equal(np.asarray(got_tri), np.asarray(want_tri))


@pytest.mark.parametrize(
    "lens",
    [
        [0, 1, 4, 135, 136, 137, 271, 272, 300],  # block-boundary classes incl 0x9F
    ],
)
def test_shake_words_matches_hashlib(lens):
    rng = np.random.default_rng(5)
    B = len(lens)
    max_blocks = max(l // RATE + 1 for l in lens) + 1
    W = max_blocks * RATE
    by = np.zeros((W, B), dtype=np.uint8)
    payloads = []
    for k, l in enumerate(lens):
        p = rng.integers(0, 256, size=l, dtype=np.uint8).tobytes()
        payloads.append(p)
        by[:l, k] = np.frombuffer(p, dtype=np.uint8)
    words = rw.pack_bytes_to_words(jnp.asarray(by))
    st = shake256_absorb_words(words, jnp.asarray(np.array(lens, np.int32)))
    n_out_w = 75  # 300 bytes: 3 squeeze blocks
    out_w = np.asarray(shake256_squeeze_words(st, n_out_w))
    out_b = np.asarray(shake256_squeeze_lanes_lm(st, 4 * n_out_w))
    # word and byte squeezes agree with each other and with hashlib
    got = np.asarray(rw.unpack_words_to_bytes(jnp.asarray(out_w), 4 * n_out_w))
    np.testing.assert_array_equal(got, out_b)
    for k, p in enumerate(payloads):
        want = shake_256(p).digest(4 * n_out_w)
        assert bytes(got[:, k]) == want, f"payload len {lens[k]}"


def test_sha3_words_matches_hashlib():
    from hashlib import sha3_256

    from fusion_cryptography_tpu.ops.keccak import sha3_256_words

    rng = np.random.default_rng(17)
    lens = [0, 1, 13, 133, 134, 135, 136, 200]
    B = len(lens)
    W = (max(lens) // RATE + 2) * RATE
    by = np.zeros((W, B), dtype=np.uint8)
    payloads = []
    for k, l in enumerate(lens):
        p = rng.integers(0, 256, size=l, dtype=np.uint8).tobytes()
        payloads.append(p)
        by[:l, k] = np.frombuffer(p, dtype=np.uint8)
    words = rw.pack_bytes_to_words(jnp.asarray(by))
    dig = np.asarray(sha3_256_words(words, jnp.asarray(np.array(lens, np.int32))))
    got = np.asarray(rw.unpack_words_to_bytes(jnp.asarray(dig), 32))
    for k, p in enumerate(payloads):
        assert bytes(got[:, k]) == sha3_256(p).digest(), f"len {lens[k]}"


def test_render_bigint_dec_matches_str():
    rng = np.random.default_rng(23)
    digests = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(6)]
    digests += [b"\x00" * 32, b"\x01" + b"\x00" * 31, b"\xff" * 32, b"\x00" * 31 + b"\x01"]
    B = len(digests)
    limbs = np.zeros((8, B), dtype=np.uint32)
    for k, dg in enumerate(digests):
        limbs[:, k] = np.frombuffer(dg, dtype="<u4")
    chunk = rw.render_bigint_dec_w(jnp.asarray(limbs))
    by = np.asarray(rw.unpack_words_to_bytes(chunk.buf, 80))
    lens = np.asarray(chunk.length)
    for k, dg in enumerate(digests):
        want = str(int.from_bytes(dg, "little")).encode()
        assert lens[k] == len(want), (k, lens[k], len(want))
        assert bytes(by[: len(want), k]) == want
        assert not by[len(want):, k].any()


def test_device_prehash_pipeline_matches_host():
    """verify/derive through msg_preimage_words (device SHA3 + digit render)
    must produce identical coefficients to the host-prehash path."""
    import fusion_cryptography_tpu.scheme.device_pipeline as dp

    params = ftpu.fusion_setup(128, 5)
    rng = np.random.default_rng(8)
    G, N, d = 2, 2, params.degree
    q = params.modulus
    vks = jnp.asarray(rng.integers(-(q // 2), q // 2 + 1, size=(G, N, 2, d)).astype(np.int32))
    aggs = jnp.asarray(rng.integers(-(q // 2), q // 2 + 1, size=(G, params.rank, d)).astype(np.int32))
    msgs = ["", "hello", "a" * 140, "unicode: éß"]

    assert dp.get_pipeline(params, N).device_prehash, (
        "word path should default to device prehash")
    out_dev = dp.derive_coeffs_device(params, vks, msgs, aggs)

    import os
    os.environ["FUSION_HOST_PREHASH"] = "1"
    dp._pipeline_cached.cache_clear()
    try:
        out_host = dp.derive_coeffs_device(params, vks, msgs, aggs)
    finally:
        del os.environ["FUSION_HOST_PREHASH"]
        dp._pipeline_cached.cache_clear()
    for a, b in zip(out_dev[3:], out_host[3:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_absorb_words_scratch_garbage_ignored():
    # bytes at or beyond ``lens`` must not affect the digest
    rng = np.random.default_rng(9)
    l = 200
    p = rng.integers(0, 256, size=l, dtype=np.uint8).tobytes()
    W = (l // RATE + 2) * RATE
    by = np.zeros((W, 1), dtype=np.uint8)
    by[:l, 0] = np.frombuffer(p, dtype=np.uint8)
    clean = rw.pack_bytes_to_words(jnp.asarray(by))
    by[l:, 0] = rng.integers(0, 256, size=W - l, dtype=np.uint8)
    dirty = rw.pack_bytes_to_words(jnp.asarray(by))
    lens = jnp.asarray(np.array([l], np.int32))
    a = np.asarray(shake256_squeeze_words(shake256_absorb_words(clean, lens), 8))
    b = np.asarray(shake256_squeeze_words(shake256_absorb_words(dirty, lens), 8))
    np.testing.assert_array_equal(a, b)
    assert bytes(np.asarray(rw.unpack_words_to_bytes(jnp.asarray(a), 32))[:, 0]) == shake_256(p).digest(32)


def test_merge_w_scatter_matches_barrel():
    """Small-b merges take the block-scatter placement path; outputs must be
    bit-identical to the barrel path on ragged inputs that span the whole
    slack window."""
    import numpy as np
    import jax.numpy as jnp

    from fusion_cryptography_tpu.ops import ragged_words as rw

    rng = np.random.default_rng(33)
    B = 16
    # left chunk: max 1200 bytes, min 120 -> slack 1080 >> b.max 30
    a_max, a_min, b_max = 1200, 120, 30
    a_len = rng.integers(a_min, a_max + 1, B).astype(np.int32)
    b_len = rng.integers(1, b_max + 1, B).astype(np.int32)
    a_by = np.zeros((rw.words_for(a_max) * 4, B), np.uint8)
    b_by = np.zeros((rw.words_for(b_max) * 4, B), np.uint8)
    for k in range(B):
        a_by[: a_len[k], k] = rng.integers(1, 255, a_len[k])
        b_by[: b_len[k], k] = rng.integers(1, 255, b_len[k])
    a = rw.WChunk(rw.pack_bytes_to_words(jnp.asarray(a_by)),
                  jnp.asarray(a_len), a_max, a_min)
    b = rw.WChunk(rw.pack_bytes_to_words(jnp.asarray(b_by)),
                  jnp.asarray(b_len), b_max, 1)
    got = rw.merge_w(a, b)
    # force the barrel path for the oracle
    ratio = rw._SCATTER_MIN_SLACK_RATIO
    try:
        rw._SCATTER_MIN_SLACK_RATIO = 10**9
        want = rw.merge_w(a, b)
    finally:
        rw._SCATTER_MIN_SLACK_RATIO = ratio
    np.testing.assert_array_equal(np.asarray(got.length), np.asarray(want.length))
    np.testing.assert_array_equal(np.asarray(got.buf), np.asarray(want.buf))
    assert (got.max_len, got.min_len) == (want.max_len, want.min_len)
