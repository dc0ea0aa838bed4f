"""The fused Pallas-Triton SHAKE256 sponge (ops/keccak_triton.py): interpret
mode against hashlib and the XLA sponge, the wrapper's lane padding, and the
pipeline's choice of sponge.  The compiled kernel runs in the ``gpu`` test
and in chip_smoke.py."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fusion_cryptography_tpu.ops import keccak
from fusion_cryptography_tpu.ops.keccak_triton import shake256_words_triton

ROWS = 3 * keccak.RATE_WORDS  # room for payloads up to 407 bytes
LENGTHS = [0, 1, 135, 136, 137, 271, 272, 273]


def _payload_words(payloads, rows=ROWS, garbage=False):
    """Payloads -> (uint32[rows, B] packed words, int32[B] byte lengths)."""
    buf = np.zeros((len(payloads), 4 * rows), np.uint8)
    for i, p in enumerate(payloads):
        buf[i, : len(p)] = np.frombuffer(p, np.uint8)
        if garbage:
            buf[i, len(p):] = 0xA5  # scratch beyond the length is ignored
    lens = np.array([len(p) for p in payloads], np.int32)
    return np.ascontiguousarray(buf.view("<u4").T), lens


def _want(p: bytes, n_words: int) -> np.ndarray:
    return np.frombuffer(hashlib.shake_256(p).digest(4 * n_words), "<u4")


def _sponge(words, lens, n_words, **kw):
    return np.asarray(
        shake256_words_triton(words, lens, n_words, unroll=1, interpret=True, **kw)
    )


@pytest.mark.parametrize("n_out", [32, 136, 300])
@pytest.mark.parametrize("length", LENGTHS + ["ragged"])
def test_triton_sponge_matches_hashlib(length, n_out):
    rng = np.random.default_rng(n_out)
    lens = LENGTHS + [5, 407] if length == "ragged" else [length]
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]
    words, lens = _payload_words(payloads, garbage=True)
    n_words = -(-n_out // 4)
    out = _sponge(words, lens, n_words)
    assert out.shape == (n_words, len(payloads))
    for i, p in enumerate(payloads):
        np.testing.assert_array_equal(out[:, i], _want(p, n_words), err_msg=f"len {len(p)}")


@pytest.mark.parametrize("B", [1, 127, 129, 2050])
def test_triton_sponge_lane_padding(B):
    payloads = [f"lane{i}".encode() * (i % 7) for i in range(B)]
    words, lens = _payload_words(payloads, rows=keccak.RATE_WORDS)
    out = _sponge(words, lens, 8)
    assert out.shape == (8, B)
    for i in sorted({0, B // 2, B - 1}):
        np.testing.assert_array_equal(out[:, i], _want(payloads[i], 8))


@pytest.mark.parametrize("secpar", [128, 256])
def test_triton_matches_xla_sponge_on_challenge_preimages(secpar):
    import fusion_cryptography_tpu as ftpu
    from fusion_cryptography_tpu.interop import device_serial as ds
    from fusion_cryptography_tpu.ops import ragged_words as rw
    from fusion_cryptography_tpu.scheme import device_pipeline as dp

    params = ftpu.fusion_setup(secpar, 5)
    B = 3
    rng = np.random.default_rng(secpar)
    q2 = params.modulus // 2
    vk2d_t = jnp.asarray(
        rng.integers(-q2, q2 + 1, size=(2 * params.degree, B), dtype=np.int64).astype(np.int32)
    )
    digits, dlen = dp.prehash_digits(params, [f"m{i}" for i in range(B)])
    pre = rw.WChunk(
        buf=rw.pack_bytes_to_words(jnp.asarray(digits.T)),
        length=jnp.asarray(dlen), max_len=ds.PREHASH_W, min_len=1,
    )
    g = dp._geometries(params)
    wbuf, total = ds.fold_challenge_preimage_w(
        params, ds.vk_chunk_w(params, vk2d_t), pre,
        pad_words=dp._pad_rate(g["ch_spec"].out_max) // 4,
    )
    n_words = -(-g["n_xof_ch_used"] // 4)
    want = keccak.shake256_squeeze_words(
        keccak.shake256_absorb_words(wbuf, total), n_words
    )
    np.testing.assert_array_equal(_sponge(wbuf, total, n_words), np.asarray(want))


@pytest.mark.parametrize("backend,want", [("gpu", "triton"), ("cpu", "xla")])
def test_sponge_choice_follows_platform(monkeypatch, backend, want):
    from fusion_cryptography_tpu.scheme import device_pipeline as dp

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert dp.sponge_impl() == want
    assert dp._env_flags() == (True, True, want)


def test_triton_sponge_rejects_bad_arguments():
    words = np.zeros((keccak.RATE_WORDS, 4), np.uint32)
    lens = np.zeros(4, np.int32)
    with pytest.raises(ValueError, match="divide 24"):
        shake256_words_triton(words, lens, 8, unroll=5, interpret=True)
    with pytest.raises(ValueError, match="power of two"):
        shake256_words_triton(words, lens, 8, block_lanes=48, interpret=True)
    with pytest.raises(ValueError, match="multiple of 34"):
        shake256_words_triton(words[:30], lens, 8, interpret=True)


@pytest.mark.gpu
def test_triton_sponge_compiled_on_gpu(gpu_device):
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in range(0, 400, 3)]
    words, lens = _payload_words(payloads)
    out = np.asarray(shake256_words_triton(words, lens, 75))
    for i, p in enumerate(payloads):
        np.testing.assert_array_equal(out[:, i], _want(p, 75))
