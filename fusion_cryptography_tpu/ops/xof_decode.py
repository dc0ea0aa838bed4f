"""Device decode: XOF byte streams -> bounded-coefficient polynomials.

Bit-exact twin of the host decoder (hashing/decode.py, which itself mirrors
the reference fusion/fusion.py:422-481), vectorized over a batch of B streams
so the decode rides the same device pipeline as the XOF (ops/keccak.py):

  [ signum bytes ][ weight_bound magnitude blocks ][ Fisher-Yates index stream ]

* signums: bit i (LSB-first) of the big-endian integer over the signum bytes;
* magnitudes: each bpc-byte block big-endian, ``(block % bound) + 1`` (bound=1
  in production, where every magnitude is 1 but the bytes are still consumed);
* placement: partial Fisher-Yates from i = degree-1 down to weight_bound+1
  (exclusive-bound quirk preserved, fusion.py:473).  All swap indices are
  derived up-front by a vectorized Horner reduction of the index stream.  The
  swap chain only ever *relocates* the weight_bound live values (every other
  slot is zero), so instead of materializing int32[B, degree] swap states the
  ``lax.scan`` tracks the positions int32[B, weight_bound] of the live values
  through the chain (a swap (i, j) moves a tracked value at i to j and vice
  versa) and one final one-hot scatter places them — ~(degree/weight_bound)x
  less work per step than swapping full coefficient rows.

Geometry (byte offsets) is static per parameter set, so everything traces to
fixed shapes.
"""
from __future__ import annotations

from dataclasses import dataclass
from math import ceil, gcd, log2

import jax
import jax.numpy as jnp
import numpy as np

_I32 = jnp.int32
_U32 = jnp.uint32


@dataclass(frozen=True)
class DecodeGeometry:
    """Static byte layout of one XOF-decoded polynomial (fusion.py:541-550)."""

    degree: int
    weight_bound: int
    bound: int
    bytes_per_coefficient: int
    bytes_per_index: int
    bytes_for_signums: int

    @property
    def index_stream_offset(self) -> int:
        return self.bytes_for_signums + self.weight_bound * self.bytes_per_coefficient

    @property
    def num_swaps(self) -> int:
        # fusion.py:473: for i in range(degree - 1, weight_bound, -1)
        return max(0, self.degree - 1 - self.weight_bound)

    @property
    def min_bytes(self) -> int:
        return self.bytes_for_signums + (
            self.bytes_per_coefficient + self.bytes_per_index
        ) * self.weight_bound


def geometry(log2_bias: int, modulus: int, degree: int, norm_bound: int, weight_bound: int) -> DecodeGeometry:
    """Derive the static layout exactly as the host decoder does."""
    bound = max(1, min(modulus // 2, norm_bound))
    if bound >= 1 << 24:
        raise NotImplementedError(
            "device Horner reduction needs bound*256 < 2**32; production bounds are tiny"
        )
    if not (0 < weight_bound <= degree):
        raise NotImplementedError("device decoder assumes 0 < weight_bound <= degree")
    return DecodeGeometry(
        degree=degree,
        weight_bound=weight_bound,
        bound=bound,
        bytes_per_coefficient=ceil((log2(bound) + 1 + log2_bias) / 8),
        bytes_per_index=ceil((log2(degree) + log2_bias) / 8),
        bytes_for_signums=ceil(weight_bound / 8),
    )


def consumed_bytes(geom: DecodeGeometry, n_xof: int) -> int:
    """Bytes of an ``n_xof``-byte XOF stream the decoder actually reads.

    The reference's output-length arithmetic (fusion.py:541-550) asks for
    ``bytes_per_index * degree`` index bytes but the partial Fisher-Yates only
    performs ``num_swaps`` (< degree) swaps, so the stream tail is never read.
    Squeezing only this many bytes is bit-exact: every index slice the decoder
    takes is identical (truncated reads happen only when n_xof itself is
    shorter, and then this returns n_xof unchanged).
    """
    return min(n_xof, geom.index_stream_offset + geom.num_swaps * geom.bytes_per_index)


def _horner_mod(blocks, mods):
    """Big-endian bytes -> integer mod ``mods``, vectorized.

    blocks: uint8[..., nbytes]; mods: broadcastable int array (each < 2**24).
    Invariant: r < mod, so r*256 + byte < mod*256 + 256 fits uint32.
    """
    m = jnp.asarray(mods).astype(_U32)
    r = jnp.zeros(jnp.broadcast_shapes(blocks.shape[:-1], m.shape), _U32)
    for k in range(blocks.shape[-1]):
        r = (r * np.uint32(256) + blocks[..., k].astype(_U32)) % m
    return r


def decode_coeffs(xof_bytes, geom: DecodeGeometry):
    """uint8[B, n] XOF streams -> int32[B, degree] coefficient vectors."""
    d, w = geom.degree, geom.weight_bound
    B = xof_bytes.shape[0]
    if xof_bytes.shape[1] < geom.min_bytes:
        raise ValueError(
            f"Too few bytes to decode polynomial. Expected {geom.min_bytes} "
            f"but got {xof_bytes.shape[1]}"
        )

    # signums: bit i of the big-endian int over the first signum bytes
    nb = geom.bytes_for_signums
    i_arr = np.arange(w)
    src_byte = nb - 1 - i_arr // 8  # [w]
    shift = np.uint32(1) * (i_arr % 8).astype(np.uint32)
    sig_bytes = xof_bytes[:, src_byte].astype(_U32)  # [B, w]
    bits = (sig_bytes >> jnp.asarray(shift)) & np.uint32(1)
    signums = (2 * bits.astype(_I32)) - 1  # [B, w]

    # magnitudes
    if geom.bound == 1:
        mags = jnp.ones((B, w), _I32)
    else:
        off = nb
        blocks = xof_bytes[:, off : off + w * geom.bytes_per_coefficient].reshape(
            B, w, geom.bytes_per_coefficient
        )
        mags = _horner_mod(blocks, np.uint32(geom.bound)).astype(_I32) + 1

    vals = mags * signums  # [B, w]

    S = geom.num_swaps
    if S == 0:
        return jnp.concatenate([vals, jnp.zeros((B, d - w), _I32)], axis=1)

    # swap targets: j_t = int(index bytes) % (i_t + 1), i_t = d-1-t.
    # The reference reads the index stream with plain byte slicing
    # (fusion.py:474), so a stream shorter than num_swaps * bytes_per_index
    # yields *truncated* big-endian ints at the boundary and empty reads
    # (value 0 -> j = 0) past the end — e.g. the aggregation blocks supply only
    # weight_bound index slots.  The per-swap available-byte counts are static,
    # so this is a statically masked Horner reduction.
    off = geom.index_stream_offset
    bpi = geom.bytes_per_index
    n = xof_bytes.shape[1]
    pad = max(0, off + S * bpi - n)
    xb = jnp.pad(xof_bytes, ((0, 0), (0, pad))) if pad else xof_bytes
    idx_blocks = xb[:, off : off + S * bpi].reshape(B, S, bpi)
    i_vals = np.arange(d - 1, w, -1)  # [S]
    avail = np.clip(n - (off + np.arange(S) * bpi), 0, bpi)  # [S]
    mods = jnp.asarray((i_vals + 1).astype(np.uint32))
    r = jnp.zeros((B, S), _U32)
    for k in range(bpi):
        nxt = (r * np.uint32(256) + idx_blocks[..., k].astype(_U32)) % mods
        r = jnp.where(jnp.asarray(k < avail)[None, :], nxt, r)
    j_all = r.astype(_I32)  # [B, S]

    # Track the live values' positions through the swap chain: a swap (i, j)
    # sends a tracked value sitting at i to j and one sitting at j to i (a
    # value at both means i == j, where the two displacements cancel).
    p0 = jnp.broadcast_to(jnp.arange(w, dtype=_I32)[None, :], (B, w))

    def swap(p, xs):
        i_t, j_t = xs  # scalar int32, [B]
        j = j_t[:, None]  # [B, 1]
        at_i = (p == i_t).astype(_I32)
        at_j = (p == j).astype(_I32)
        return p + at_i * (j - i_t) + at_j * (i_t - j), None

    pos, _ = jax.lax.scan(swap, p0, (jnp.asarray(i_vals, _I32), j_all.T))
    # one-hot scatter of the w live values into their final slots (positions
    # are distinct, so the sum has at most one term per slot)
    iota_d = jax.lax.broadcasted_iota(_I32, (1, 1, d), 2)
    hits = (pos[:, :, None] == iota_d).astype(_I32)  # [B, w, d]
    return jnp.sum(vals[:, :, None] * hits, axis=1)


# ---------------------------------------------------------------------------
# Lane-major decode (production path): streams uint8[n, B], batch minor
# ---------------------------------------------------------------------------


def _horner_mod_lm(blocks, mods):
    """Lane-major :func:`_horner_mod`: blocks uint8[..., nbytes, B]; mods
    broadcastable against the [..., B] result."""
    m = jnp.asarray(mods).astype(_U32)
    shape = jnp.broadcast_shapes(blocks.shape[:-2] + blocks.shape[-1:], m.shape)
    r = jnp.zeros(shape, _U32)
    for k in range(blocks.shape[-2]):
        r = (r * np.uint32(256) + blocks[..., k, :].astype(_U32)) % m
    return r


def _fy_place_lm(vals, j_all, geom: DecodeGeometry):
    """Partial-Fisher-Yates placement (lane-major): live values ``vals``
    int32[w, B] + swap targets ``j_all`` int32[S, B] -> int32[d, B].

    Tracks the positions of the ``w`` live values through the swap chain
    (a swap (i, j) moves a tracked value at i to j and vice versa), then
    scatters them with one one-hot sum — see :func:`decode_coeffs` notes.
    """
    d, w = geom.degree, geom.weight_bound
    B = vals.shape[-1]
    S = geom.num_swaps

    # CLOSED FORM of the partial-Fisher-Yates swap chain (round 5): because
    # the swap sources i_t = d-1-t descend strictly and every live value
    # starts at a position m < w < w+1 <= i_t, a live value can only ever be
    # hit through j_t == m; the swap parks it at i_t, and NO later swap can
    # reach it (later i_t' < i_t and j_t' <= i_t' < i_t, while the zero that
    # arrived at slot m makes any later j_t' == m a no-op for live values).
    # So each value moves AT MOST ONCE, at the FIRST t with j_t == m:
    #
    #   pos[m] = d-1-first_t[m]  if first_t[m] < S else m
    #
    # One fused first-hit min-reduce over [S, w, B] replaces the round-4
    # sequential 195-step tracked-position chain (the chain's dependent
    # [w, B] passes were the decode stage's dominant cost — ~2.5 ms of the
    # 3.7 ms challenge decode at B=8192).  Bit-exactness vs the host decoder
    # is asserted in tests/test_xof_decode.py.
    t_idx = jnp.arange(S, dtype=_I32)[:, None, None]  # [S, 1, 1]
    m_idx = jnp.arange(w, dtype=_I32)[:, None]  # [w, 1]
    hit = j_all[:, None, :] == m_idx[None, :, :]  # [S, w, B]
    first_t = jnp.min(jnp.where(hit, t_idx, np.int32(S)), axis=0)  # [w, B]
    pos = jnp.where(first_t < S, np.int32(d - 1) - first_t, m_idx)  # [w, B]
    iota_d = jax.lax.broadcasted_iota(_I32, (1, d, 1), 1)
    hits = (pos[:, None, :] == iota_d).astype(_I32)  # [w, d, B]
    return jnp.sum(vals[:, None, :] * hits, axis=0)  # [d, B]


def decode_coeffs_lm(xof_bytes, geom: DecodeGeometry):
    """Lane-major :func:`decode_coeffs`: uint8[n, B] streams -> int32[d, B].

    Identical arithmetic, batch-minor layout; the swap chain is fully
    unrolled at trace time (static step count).
    """
    d, w = geom.degree, geom.weight_bound
    n, B = xof_bytes.shape
    if n < geom.min_bytes:
        raise ValueError(
            f"Too few bytes to decode polynomial. Expected {geom.min_bytes} "
            f"but got {n}"
        )

    nb = geom.bytes_for_signums
    i_arr = np.arange(w)
    src_byte = nb - 1 - i_arr // 8  # [w]
    shift = (i_arr % 8).astype(np.uint32)
    sig_bytes = xof_bytes[src_byte].astype(_U32)  # [w, B]
    bits = (sig_bytes >> jnp.asarray(shift)[:, None]) & np.uint32(1)
    signums = (2 * bits.astype(_I32)) - 1  # [w, B]

    if geom.bound == 1:
        vals = signums
    else:
        off = nb
        blocks = xof_bytes[off : off + w * geom.bytes_per_coefficient].reshape(
            w, geom.bytes_per_coefficient, B
        )
        mags = _horner_mod_lm(blocks, np.uint32(geom.bound)).astype(_I32) + 1
        vals = mags * signums  # [w, B]

    S = geom.num_swaps
    if S == 0:
        return jnp.concatenate([vals, jnp.zeros((d - w, B), _I32)], axis=0)

    off = geom.index_stream_offset
    bpi = geom.bytes_per_index
    pad = max(0, off + S * bpi - n)
    xb = jnp.pad(xof_bytes, ((0, pad), (0, 0))) if pad else xof_bytes
    idx_blocks = xb[off : off + S * bpi].reshape(S, bpi, B)
    i_vals = np.arange(d - 1, w, -1)  # [S]
    avail = np.clip(n - (off + np.arange(S) * bpi), 0, bpi)  # [S]
    mods = jnp.asarray((i_vals + 1).astype(np.uint32))[:, None]
    r = jnp.zeros((S, B), _U32)
    for k in range(bpi):
        nxt = (r * np.uint32(256) + idx_blocks[:, k].astype(_U32)) % mods
        r = jnp.where(jnp.asarray(k < avail)[:, None], nxt, r)
    j_all = r.astype(_I32)  # [S, B]
    return _fy_place_lm(vals, j_all, geom)


# ---------------------------------------------------------------------------
# Word-native decode (production path): streams uint32[W, B] packed words
# ---------------------------------------------------------------------------


def _block_powers(geom_off: int, count: int, bpb: int, mods: np.ndarray, n_bytes: int):
    """Per-(row, byte) power-of-256 tables for the masked big-endian reduce.

    Row t's value is the big-endian integer over its AVAILABLE bytes (the
    reference reads with plain slicing, so a truncated stream yields truncated
    ints and empty reads give 0 — see :func:`decode_coeffs` notes):

        v_t = sum_k byte[t, k] * 256^(avail_t - 1 - k)   (k < avail_t)

    so  v_t mod m_t = (sum_k byte[t, k] * P[t, k]) mod m_t with
    P[t, k] = 256^(avail_t-1-k) mod m_t for k < avail_t, else 0.  The sum
    fits uint32 whenever bpb * 255 * (max(m)-1) < 2**32 (checked by callers).
    """
    avail = np.clip(n_bytes - (geom_off + np.arange(count) * bpb), 0, bpb)
    P = np.zeros((count, bpb), dtype=np.uint32)
    for t in range(count):
        m = int(mods[t] if mods.ndim else mods)
        a = int(avail[t])
        for k in range(a):
            P[t, k] = pow(256, a - 1 - k, m)
    return P


def realign_words(words, byte_off: int, out_words: int):
    """Static sub-word realign of packed-word streams: returns
    uint32[out_words, B] whose byte j is byte ``byte_off + j`` of the input
    (zero-filled past the end).  ~3 elementwise ops — free next to any dynamic shift."""
    r0, w0 = byte_off % 4, byte_off // 4
    need = out_words + (1 if r0 else 0)
    reg = words[w0 : w0 + need]
    pad = need - reg.shape[0]
    if pad > 0:
        reg = jnp.pad(reg, ((0, pad), (0, 0)))
    if r0:
        sh = np.uint32(8 * r0)
        nxt = jnp.pad(reg[1:], ((0, 1), (0, 0)))
        reg = (reg >> sh) | (nxt << (np.uint32(32) - sh))
    return reg[:out_words]


def split_streams_w(blob_w, n_streams: int, stream_bytes: int):
    """Split concatenated fixed-length streams: uint32[Wtot, B] carrying
    ``n_streams`` consecutive ``stream_bytes``-byte streams ->
    uint32[ceil(stream_bytes/4), B, n_streams].  Stream k's word rows are
    statically realigned (stream boundaries need not be word-aligned)."""
    bw = -(-stream_bytes // 4)
    outs = [
        realign_words(blob_w, k * stream_bytes, bw) for k in range(n_streams)
    ]
    return jnp.stack(outs, axis=2)


def _block_horner_w(xof_words, n_bytes: int, off: int, count: int, bpb: int,
                    mods: np.ndarray):
    """Masked big-endian reduce of ``count`` consecutive ``bpb``-byte blocks
    starting at byte ``off`` of packed-word streams uint32[W, B] -> uint32
    [count, B] with row t reduced mod ``mods[t]``.

    Word-native: the blocks are regrouped so ``g = 4/gcd(bpb, 4)`` rows span a
    whole number of words, every byte is extracted with a STATIC shift, and
    the whole row reduces with ONE modulo (vs one per byte in the byte-path
    Horner) using precomputed 256^j mod m tables.
    """
    W, B = xof_words.shape
    mods = np.asarray(mods, dtype=np.uint32)
    if mods.ndim == 0:
        mods = np.broadcast_to(mods, (count,)).copy()
    if count == 0:
        return jnp.zeros((0, B), _U32)
    if int(mods.max()) > 1 and bpb * 255 * (int(mods.max()) - 1) >= 1 << 32:
        raise NotImplementedError(
            "word-native reduce needs bpb*255*(m-1) < 2**32; use the byte path"
        )
    g = 4 // gcd(bpb, 4)  # rows per whole-word block
    blk_w = g * bpb // 4  # words per block
    R = -(-count // g)  # padded block count
    region = realign_words(xof_words, off, R * blk_w).reshape(R, blk_w, B)

    mods_pad = np.concatenate([mods, np.ones(R * g - count, np.uint32)])
    P = _block_powers(off, R * g, bpb, mods_pad, n_bytes)  # [R*g, bpb]
    outs = []
    for s in range(g):
        acc = jnp.zeros((R, B), _U32)
        for k in range(bpb):
            q = s * bpb + k
            col = P[s::g, k][:, None]  # [R, 1] — row t = rr*g + s
            if not col.any():
                continue
            byte = (region[:, q // 4, :] >> np.uint32(8 * (q % 4))) & np.uint32(0xFF)
            acc = acc + byte * jnp.asarray(col)
        outs.append(acc % jnp.asarray(mods_pad[s::g][:, None]))
    out = jnp.stack(outs, axis=1).reshape(R * g, B)  # row t = rr*g + s
    return out[:count]


def decode_coeffs_w(xof_words, geom: DecodeGeometry, n_bytes: int):
    """Word-native :func:`decode_coeffs_lm`: packed-word XOF streams
    uint32[W, B] (ops/ragged_words layout, logical length ``n_bytes`` bytes,
    W >= ceil(n_bytes/4)) -> int32[degree, B].

    Bit-exact twin of the byte decoders for the same logical stream; consumes
    ops/keccak.shake256_squeeze_words output directly, so the production
    pipeline never materializes an [n, B] byte tensor between the sponge and
    the coefficients.
    """
    d, w = geom.degree, geom.weight_bound
    W, B = xof_words.shape
    if n_bytes < geom.min_bytes:
        raise ValueError(
            f"Too few bytes to decode polynomial. Expected {geom.min_bytes} "
            f"but got {n_bytes}"
        )
    if 4 * W < n_bytes:
        raise ValueError(f"{W} words carry fewer than {n_bytes} bytes")

    # signums: bit i of the big-endian int over the first signum bytes,
    # static word index + combined static shift per i
    nb = geom.bytes_for_signums
    i_arr = np.arange(w)
    src_byte = nb - 1 - i_arr // 8
    sig_words = xof_words[src_byte // 4]  # [w, B] (static gather, w <= 64)
    shift = (8 * (src_byte % 4) + i_arr % 8).astype(np.uint32)
    bits = (sig_words >> jnp.asarray(shift)[:, None]) & np.uint32(1)
    signums = (2 * bits.astype(_I32)) - 1  # [w, B]

    if geom.bound == 1:
        vals = signums
    else:
        mags = _block_horner_w(
            xof_words, n_bytes, nb, w, geom.bytes_per_coefficient,
            np.uint32(geom.bound),
        ).astype(_I32) + 1
        vals = mags * signums

    S = geom.num_swaps
    if S == 0:
        return jnp.concatenate([vals, jnp.zeros((d - w, B), _I32)], axis=0)

    i_vals = np.arange(d - 1, w, -1)  # [S]
    j_all = _block_horner_w(
        xof_words, n_bytes, geom.index_stream_offset, S, geom.bytes_per_index,
        (i_vals + 1).astype(np.uint32),
    ).astype(_I32)
    return _fy_place_lm(vals, j_all, geom)
