"""Batched Keccak-f[1600] / SHAKE256 as XLA elementwise programs.

The reference derives every challenge and aggregation coefficient from
SHAKE256 XOFs (fusion/fusion.py:412-419, :573-591) computed by ``hashlib`` on
the host.  At production batch sizes host Keccak is the end-to-end bottleneck,
so this module runs the sponge on-device: a batch of B independent sponges is
25 64-bit lanes carried as 50 ``uint32[B]`` tensors.

The lane dimension is *unrolled at trace time* (a Python tuple of arrays), so
the permutation lowers to pure elementwise ops with zero data movement:

* pi is free — it is Python-level renaming of the 25 lane variables;
* rho's per-lane rotations are static constant shift pairs (no selects);
* theta/chi are straight XOR/AND/NOT chains over ``[B]`` vectors.

The round (:func:`_keccak_round`) is shared with the fused GPU sponge kernel
(ops/keccak_triton.py), which the verify pipeline runs on a GPU.

Absorption handles ragged payload lengths with a masked ``lax.scan`` over rate
blocks: every sponge processes ``max_blocks`` block slots, but a lane's state
only advances while ``block_index < num_blocks(lane)``; multi-rate padding
(0x1F ... 0x80) is OR-ed into the byte buffer at data-dependent positions
before the scan, which reproduces ``hashlib.shake_256`` bit-exactly for every
payload length (including the 0x9F single-byte-pad case).

Layouts:
  state   uint32[25, 2, B]          flat lane l = x + 5*y, (lo, hi), batch
  payload uint8[B, max_blocks*136]  zero-padded bytes + per-lane length
  output  uint8[B, n_out]           SHAKE256 XOF stream per lane
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
RATE = 136  # SHAKE256 rate in bytes
RATE_WORDS = RATE // 4  # 34 uint32 words
RATE_LANES = RATE // 8  # 17 lanes

# ---------------------------------------------------------------------------
# Round constants and permutation tables (computed, then frozen as numpy)
# ---------------------------------------------------------------------------


def _round_constants() -> np.ndarray:
    """The 24 iota round constants as uint32 (lo, hi) pairs, from the standard
    degree-8 LFSR."""
    rc = []
    r = 1
    for _ in range(24):
        c = 0
        for j in range(7):
            r = ((r << 1) ^ ((r >> 7) * 0x71)) & 0xFF
            if r & 2:
                c ^= 1 << ((1 << j) - 1)
        rc.append((c & 0xFFFFFFFF, c >> 32))
    return np.array(rc, dtype=np.uint32)  # [24, 2]


def _rho_pi_tables():
    """(rotation offsets by flat lane, pi source index by flat destination lane).

    Flat lane order l = x + 5*y.  rho offsets follow the (t+1)(t+2)/2
    recurrence; pi maps A[x, y] -> B[y, (2x + 3y) % 5].
    """
    rot = np.zeros(25, dtype=np.int64)
    x, y = 1, 0
    for t in range(24):
        rot[x + 5 * y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    pi_src = np.zeros(25, dtype=np.int64)
    for xx in range(5):
        for yy in range(5):
            dest = yy + 5 * ((2 * xx + 3 * yy) % 5)
            pi_src[dest] = xx + 5 * yy
    return rot, pi_src


_RC = _round_constants()
_ROT, _PI_SRC = _rho_pi_tables()

# Lane-tuple form: state is a tuple of 25 (lo, hi) pairs of uint32[B].
Lanes = Tuple[Tuple[jnp.ndarray, jnp.ndarray], ...]


def _rotl_static(lo, hi, r: int):
    """64-bit rotate-left by the *static* amount r of a (lo, hi) uint32 pair."""
    if r == 0:
        return lo, hi
    if r == 32:
        return hi, lo
    if r > 32:
        lo, hi, r = hi, lo, r - 32
    rs, rc = np.uint32(r), np.uint32(32 - r)
    return (lo << rs) | (hi >> rc), (hi << rs) | (lo >> rc)


def _keccak_round(lanes: Lanes, rc_lo, rc_hi, i, rc=None) -> Lanes:
    """One Keccak round, fully unrolled over lanes (elementwise ops only).

    ``rc=(lo, hi)`` supplies immediate round constants (unrolled path);
    otherwise they are gathered from the (rc_lo, rc_hi) tables at index i."""
    # theta
    C = []
    for x in range(5):
        lo = lanes[x][0] ^ lanes[x + 5][0] ^ lanes[x + 10][0] ^ lanes[x + 15][0] ^ lanes[x + 20][0]
        hi = lanes[x][1] ^ lanes[x + 5][1] ^ lanes[x + 10][1] ^ lanes[x + 15][1] ^ lanes[x + 20][1]
        C.append((lo, hi))
    D = []
    for x in range(5):
        rlo, rhi = _rotl_static(C[(x + 1) % 5][0], C[(x + 1) % 5][1], 1)
        D.append((C[(x + 4) % 5][0] ^ rlo, C[(x + 4) % 5][1] ^ rhi))
    A = [(lanes[l][0] ^ D[l % 5][0], lanes[l][1] ^ D[l % 5][1]) for l in range(25)]
    # rho + pi: static rotation then lane renaming
    B = [None] * 25
    for dest in range(25):
        src = int(_PI_SRC[dest])
        B[dest] = _rotl_static(A[src][0], A[src][1], int(_ROT[src]))
    # chi
    out = []
    for y in range(5):
        for x in range(5):
            b0, b1, b2 = B[x + 5 * y], B[(x + 1) % 5 + 5 * y], B[(x + 2) % 5 + 5 * y]
            out.append((b0[0] ^ (~b1[0] & b2[0]), b0[1] ^ (~b1[1] & b2[1])))
    # iota
    if rc is not None:
        out[0] = (out[0][0] ^ rc[0], out[0][1] ^ rc[1])
    else:
        out[0] = (out[0][0] ^ jnp.take(rc_lo, i), out[0][1] ^ jnp.take(rc_hi, i))
    return tuple(out)


def _round_unroll() -> int:
    """Trace-time round-unroll factor (divides 24): 1 on the CPU, 2 elsewhere.

    Compile time decides it.  On an H100 (700 W limit) XLA took 118 s to
    compile the full 24-round unroll of the aggregation sponge's scan body,
    and the on-device prehash (SHA3 with a 24-round unroll, decimal render
    unrolled) did not compile within 120 s; with a 2-round unroll and the
    render as a scan the prehash compiled in 5.2 s and ran in 1.72 ms at
    32,768 lanes.  On another H100 (400 W limit) a 4-round unroll ran that
    prehash in 1.05 ms against 1.21 ms for 2 rounds, and compiled in 7.8 s:
    0.15 ms is 0.3 % of a G=8192 verify, so 2 stays.  On the CPU (the test
    suite) one round per loop step keeps every scan body small.  On a GPU the verify pipeline's SHAKE sponges are
    the fused kernel (ops/keccak_triton.py); this sponge runs the SHA3
    prehash there.  The arithmetic is identical either way.  Override with
    ``FUSION_KECCAK_UNROLL``.
    """
    import os

    v = os.environ.get("FUSION_KECCAK_UNROLL")
    if v:
        u = int(v)
    else:
        try:
            u = 2 if jax.default_backend() != "cpu" else 1
        except Exception:  # pragma: no cover - backendless tracing
            u = 1
    if 24 % u:
        raise ValueError(f"FUSION_KECCAK_UNROLL must divide 24, got {u}")
    return u


def keccak_f_lanes(lanes: Lanes) -> Lanes:
    """Keccak-f[1600] in lane-tuple form (the hot-path entry point)."""
    U = _round_unroll()
    if U >= 24:
        for i in range(24):
            lanes = _keccak_round(
                lanes, None, None, None,
                rc=(np.uint32(_RC[i, 0]), np.uint32(_RC[i, 1])),
            )
        return lanes
    rc_lo, rc_hi = jnp.asarray(_RC[:, 0]), jnp.asarray(_RC[:, 1])

    def block(i, ls):
        for k in range(U):
            ls = _keccak_round(ls, rc_lo, rc_hi, i * U + k)
        return ls

    return jax.lax.fori_loop(0, 24 // U, block, lanes)


def _to_lanes(state) -> Lanes:
    return tuple((state[l, 0], state[l, 1]) for l in range(25))


def _from_lanes(lanes: Lanes):
    return jnp.stack([jnp.stack(p) for p in lanes])  # [25, 2, B]


@jax.jit
def keccak_f(state):
    """Keccak-f[1600] over a batch of sponges.  state: uint32[25, 2, B]."""
    return _from_lanes(keccak_f_lanes(_to_lanes(state)))


# ---------------------------------------------------------------------------
# SHAKE256 sponge over ragged byte payloads
# ---------------------------------------------------------------------------


def _payload_to_blocks(buf, lens):
    """uint8[B, max_blocks*RATE] (+ per-lane byte length) -> uint32 rate blocks
    [max_blocks, RATE_LANES, 2, B] with SHAKE padding applied, plus block
    counts int32[B].

    Bytes at or beyond ``lens`` in ``buf`` are ignored (masked to zero), so
    callers may pass scratch garbage in the tail.
    """
    B, total = buf.shape
    if total % RATE:
        raise ValueError(f"payload buffer length {total} must be a multiple of {RATE}")
    max_blocks = total // RATE
    lens = lens.astype(jnp.int32)
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, total), 1)
    data = jnp.where(pos < lens[:, None], buf, 0)
    # pad10*1 appends at least one byte, so the final block index is
    # floor(len / RATE) and the block count is that + 1 (the 0x1F head marker
    # and 0x80 tail marker OR together into 0x9F when they share a byte).
    n_blocks = lens // RATE + 1
    pad_head = jnp.where(pos == lens[:, None], np.uint8(0x1F), np.uint8(0))
    last_byte = n_blocks * RATE - 1
    pad_tail = jnp.where(pos == last_byte[:, None], np.uint8(0x80), np.uint8(0))
    data = data | pad_head | pad_tail
    words = data.reshape(B, max_blocks, RATE_LANES, 2, 4).astype(_U32)
    w = (
        words[..., 0]
        | (words[..., 1] << np.uint32(8))
        | (words[..., 2] << np.uint32(16))
        | (words[..., 3] << np.uint32(24))
    )  # [B, max_blocks, 17, 2]
    return jnp.transpose(w, (1, 2, 3, 0)), n_blocks


def _payload_to_blocks_lm(buf, lens):
    """Lane-major :func:`_payload_to_blocks`: uint8[max_blocks*RATE, B] ->
    ([max_blocks, RATE_LANES, 2, B] uint32 blocks, int32[B] counts) with no
    transpose at all (the byte axis is already major)."""
    total, B = buf.shape
    if total % RATE:
        raise ValueError(f"payload buffer length {total} must be a multiple of {RATE}")
    max_blocks = total // RATE
    lens = lens.astype(jnp.int32)
    pos = jax.lax.broadcasted_iota(jnp.int32, (total, B), 0)
    data = jnp.where(pos < lens[None, :], buf, 0)
    n_blocks = lens // RATE + 1
    pad_head = jnp.where(pos == lens[None, :], np.uint8(0x1F), np.uint8(0))
    last_byte = n_blocks * RATE - 1
    pad_tail = jnp.where(pos == last_byte[None, :], np.uint8(0x80), np.uint8(0))
    data = data | pad_head | pad_tail
    words = data.reshape(max_blocks, RATE_LANES, 2, 4, B).astype(_U32)
    w = (
        words[:, :, :, 0]
        | (words[:, :, :, 1] << np.uint32(8))
        | (words[:, :, :, 2] << np.uint32(16))
        | (words[:, :, :, 3] << np.uint32(24))
    )  # [max_blocks, 17, 2, B]
    return w, n_blocks


def shake256_absorb_lanes_lm(buf, lens) -> Lanes:
    """Lane-major absorb: buf uint8[max_blocks*RATE, B] (zero-padded payload
    bytes, batch minor); lens int[B].  Returns lane-tuple states."""
    blocks, n_blocks = _payload_to_blocks_lm(jnp.asarray(buf, jnp.uint8), jnp.asarray(lens))
    return _absorb_blocks(blocks, n_blocks, buf.shape[-1])


def shake256_absorb_lanes(buf, lens) -> Lanes:
    """Absorb ragged payloads; returns post-absorb states in lane-tuple form.

    buf: uint8[B, max_blocks*RATE] zero-padded payload bytes; lens: int[B].
    """
    blocks, n_blocks = _payload_to_blocks(jnp.asarray(buf, jnp.uint8), jnp.asarray(lens))
    return _absorb_blocks(blocks, n_blocks, buf.shape[0])


def _absorb_blocks(blocks, n_blocks, B: int, min_blocks: int = 0,
                   state: Lanes = None) -> Lanes:
    """Masked sponge over pre-built rate blocks [max_blocks, 17, 2, B].

    ``min_blocks``: statically-known lower bound on every lane's block count
    (e.g. floor(min_payload_len / RATE) from a preimage spec's minimum
    length).  The first ``min_blocks`` blocks absorb WITHOUT the per-lane
    liveness merge (50 selects per block) — for near-uniform ragged payloads
    that is ~95% of the blocks.

    ``state``: optional lane-tuple to CONTINUE absorbing into (segmented
    absorb); defaults to the zero state.
    """
    if state is None:
        zero = jnp.zeros((B,), _U32)
        state = tuple((zero, zero) for _ in range(25))
    mb = blocks.shape[0]
    min_blocks = max(0, min(min_blocks, mb))

    def absorb_one(state, block):
        absorbed = tuple(
            (
                (state[l][0] ^ block[l, 0], state[l][1] ^ block[l, 1])
                if l < RATE_LANES
                else state[l]
            )
            for l in range(25)
        )
        return keccak_f_lanes(absorbed)

    if min_blocks > 0:
        def step_live(state, block):
            return absorb_one(state, block), None

        state, _ = jax.lax.scan(step_live, state, blocks[:min_blocks])
        if min_blocks == mb:
            return state

    def step(carry, block):
        state, j = carry
        nxt = absorb_one(state, block)
        live = j < n_blocks  # [B]
        merged = tuple(
            (jnp.where(live, nxt[l][0], state[l][0]), jnp.where(live, nxt[l][1], state[l][1]))
            for l in range(25)
        )
        return (merged, j + 1), None

    (state, _), _ = jax.lax.scan(
        step, (state, jnp.int32(min_blocks)), blocks[min_blocks:]
    )
    return state


def shake256_absorb(buf, lens):
    """Absorb ragged payloads; returns the post-absorb states uint32[25, 2, B]."""
    return _from_lanes(shake256_absorb_lanes(buf, lens))


def _payload_words_to_blocks(words, lens, pad_head: int = 0x1F,
                             assume_clean: bool = False):
    """Packed-word payloads -> masked+padded rate blocks, zero repacking.

    words: uint32[max_blocks*RATE_WORDS, B] little-endian packed payload
    (ops/ragged_words layout — byte j at bits 8*(j%4) of word j//4), scratch
    bytes beyond ``lens`` may be nonzero; lens: int[B] in BYTES.
    ``pad_head`` is the multi-rate domain byte: 0x1F for SHAKE, 0x06 for SHA3.
    ``assume_clean``: the caller guarantees bytes at or beyond ``lens`` are
    already ZERO (the WChunk normal-form invariant of ops/ragged_words), so
    the tail mask pass over the whole buffer is skipped.
    Returns ([max_blocks, RATE_LANES, 2, B] uint32 blocks, int32[B] counts).
    """
    total_w, B = words.shape
    if total_w % RATE_WORDS:
        raise ValueError(
            f"payload word count {total_w} must be a multiple of {RATE_WORDS}"
        )
    max_blocks = total_w // RATE_WORDS
    lens = lens.astype(jnp.int32)
    wi = jax.lax.broadcasted_iota(jnp.int32, (total_w, B), 0)
    if assume_clean:
        data = words
    else:
        keep = jnp.clip(lens[None, :] - 4 * wi, 0, 4)
        mask = jnp.where(
            keep >= 4,
            np.uint32(0xFFFFFFFF),
            (np.uint32(1) << (np.uint32(8) * keep.astype(_U32))) - np.uint32(1),
        )
        data = words & mask
    # multi-rate padding: the domain byte at byte ``lens``, 0x80 at the last
    # block byte (they OR together when they coincide)
    n_blocks = lens // RATE + 1
    head_val = np.uint32(pad_head) << (np.uint32(8) * (lens & 3).astype(_U32))[None, :]
    data = data | jnp.where(wi == (lens >> 2)[None, :], head_val, np.uint32(0))
    last_word = n_blocks * RATE_WORDS - 1  # 0x80 is always byte 3 of that word
    data = data | jnp.where(
        wi == last_word[None, :], np.uint32(0x80000000), np.uint32(0)
    )
    return data.reshape(max_blocks, RATE_LANES, 2, B), n_blocks


def shake256_absorb_words(words, lens, min_len: int = 0,
                          assume_clean: bool = False) -> Lanes:
    """Absorb packed-word payloads (uint32[max_blocks*34, B], lens in bytes);
    returns post-absorb lane-tuple states.  Bit-exact twin of the byte-buffer
    absorbs for the same logical payload.

    ``min_len``: static lower bound on every lane's byte length — enables the
    unmasked fast path for the first floor(min_len/RATE) blocks.
    ``assume_clean``: caller guarantees zeroed scratch beyond ``lens`` (the
    assembler invariant), skipping the whole-buffer tail mask.
    """
    blocks, n_blocks = _payload_words_to_blocks(
        jnp.asarray(words, _U32), jnp.asarray(lens), assume_clean=assume_clean
    )
    return _absorb_blocks(blocks, n_blocks, words.shape[-1], min_blocks=min_len // RATE)


def shake256_absorb_segments_words(segments, pad_head: int = 0x1F) -> Lanes:
    """Absorb the per-lane CONCATENATION of ragged packed-word segments
    without ever materializing it.

    ``segments``: sequence of ``(words uint32[Wk, B], lens int[B], min_len,
    max_len)`` in the ops/ragged_words normal form (bytes at or beyond
    ``lens`` are ZERO).  Bit-exact twin of ``shake256_absorb_words`` applied
    to the folded concatenation.

    Why this beats assembling first: a segment's placement inside the
    stream only matters MODULO the 136-byte rate.  Each segment is shifted
    right by the carried fill (< 136 bytes — a 4-pass barrel over the
    segment width, vs the ~7-pass full-slack barrel of a merge fold), OR'd
    into the carried partial rate block, and its completed blocks absorbed
    with a per-lane live count; the leftover partial block becomes the new
    carry.  The final multi-rate padding (domain byte at the stream length,
    0x80 at the block end) is applied to the last carry.

    Reference behavior reproduced: the ``str()`` concatenations feeding
    SHAKE256 at /root/reference/fusion/fusion.py:417 and :586-589.
    """
    from . import ragged_words as rw

    B = segments[0][0].shape[-1]
    state: Lanes = None
    carry = None  # first segment: stream starts block-aligned, no shift
    fill = jnp.zeros((B,), jnp.int32)
    for words, lens, mn, mx in segments:
        words = jnp.asarray(words, _U32)
        lens = jnp.asarray(lens).astype(jnp.int32)
        nb_max = (RATE - 1 + mx) // RATE  # most blocks this segment can close
        W2 = RATE_WORDS * (nb_max + 1)
        Wk = words.shape[0]
        pb = jnp.pad(words, ((0, W2 - Wk), (0, 0))) if W2 > Wk else words[:W2]
        if carry is not None:
            pb = rw.shift_right_w_dyn(pb, fill, RATE - 1)
            pb = pb | jnp.pad(carry, ((0, W2 - RATE_WORDS), (0, 0)))
        newlen = fill + lens
        nfull = newlen // RATE
        if nb_max > 0:
            blocks = pb[: RATE_WORDS * nb_max].reshape(nb_max, RATE_LANES, 2, B)
            # nfull = (fill + len)//RATE >= mn//RATE holds for EVERY segment
            state = _absorb_blocks(blocks, nfull, B, min_blocks=mn // RATE,
                                   state=state)
            sel = jnp.broadcast_to(
                jnp.minimum(nfull, nb_max)[None, :], (RATE_WORDS, B)
            ).astype(jnp.int32)
            cands = [
                jax.lax.slice_in_dim(pb, k * RATE_WORDS, (k + 1) * RATE_WORDS,
                                     axis=0)
                for k in range(nb_max + 1)
            ]
            carry = jax.lax.select_n(sel, *cands)
        else:
            carry = pb[:RATE_WORDS]
        fill = newlen - nfull * RATE
    wi = jax.lax.broadcasted_iota(jnp.int32, (RATE_WORDS, B), 0)
    head = jnp.where(
        wi == (fill >> 2)[None, :],
        np.uint32(pad_head) << (np.uint32(8) * (fill & 3).astype(_U32))[None, :],
        np.uint32(0),
    )
    blk = carry | head
    blk = blk.at[RATE_WORDS - 1].set(blk[RATE_WORDS - 1] | np.uint32(0x80000000))
    return _absorb_blocks(
        blk.reshape(1, RATE_LANES, 2, B), jnp.full((B,), 1, jnp.int32), B,
        min_blocks=1, state=state,
    )


def sha3_256_words(words, lens):
    """Batched SHA3-256 over packed-word payloads -> digest uint32[8, B]
    (little-endian packed digest bytes, ops/ragged_words layout).

    Same sponge as SHAKE with domain byte 0x06 (FIPS 202); the 32-byte digest
    is the first 8 rate words post-absorb — no squeeze permutation needed.
    Bit-exact twin of ``hashlib.sha3_256(payload).digest()`` per lane.
    """
    blocks, n_blocks = _payload_words_to_blocks(
        jnp.asarray(words, _U32), jnp.asarray(lens), pad_head=0x06
    )
    state = _absorb_blocks(blocks, n_blocks, words.shape[-1])
    return jnp.stack([state[l][h] for l in range(4) for h in range(2)])


def shake256_squeeze_words(state: Lanes, n_words: int):
    """Squeeze ``4*n_words`` bytes as packed words uint32[n_words, B]
    (little-endian — ops/ragged_words layout), with no byte unpacking."""
    n_blocks = -(-n_words // RATE_WORDS)

    def step(st, _):
        rate = jnp.stack(
            [jnp.stack(st[l]) for l in range(RATE_LANES)]
        )  # [17, 2, B]
        return keccak_f_lanes(st), rate

    _, outs = jax.lax.scan(step, state, None, length=n_blocks)  # [nb, 17, 2, B]
    B = outs.shape[-1]
    return outs.reshape(n_blocks * RATE_WORDS, B)[:n_words]


def shake256_squeeze_lanes(state: Lanes, n_out: int):
    """Squeeze ``n_out`` bytes from each sponge in lane-tuple form ->
    uint8[B, n_out]."""
    n_blocks = -(-n_out // RATE)

    def step(st, _):
        rate = jnp.stack(
            [jnp.stack(st[l]) for l in range(RATE_LANES)]
        )  # [17, 2, B]
        return keccak_f_lanes(st), rate

    _, outs = jax.lax.scan(step, state, None, length=n_blocks)  # [nb, 17, 2, B]
    w = jnp.transpose(outs, (3, 0, 1, 2))  # [B, nb, 17, 2]
    by = jnp.stack(
        [
            (w & np.uint32(0xFF)).astype(jnp.uint8),
            ((w >> np.uint32(8)) & np.uint32(0xFF)).astype(jnp.uint8),
            ((w >> np.uint32(16)) & np.uint32(0xFF)).astype(jnp.uint8),
            ((w >> np.uint32(24)) & np.uint32(0xFF)).astype(jnp.uint8),
        ],
        axis=-1,
    )  # [B, nb, 17, 2, 4]
    B = by.shape[0]
    return by.reshape(B, n_blocks * RATE)[:, :n_out]


def shake256_squeeze_lanes_lm(state: Lanes, n_out: int):
    """Lane-major squeeze: ``n_out`` bytes per sponge as uint8[n_out, B]
    (batch minor, no transpose)."""
    n_blocks = -(-n_out // RATE)

    def step(st, _):
        rate = jnp.stack(
            [jnp.stack(st[l]) for l in range(RATE_LANES)]
        )  # [17, 2, B]
        return keccak_f_lanes(st), rate

    _, outs = jax.lax.scan(step, state, None, length=n_blocks)  # [nb, 17, 2, B]
    by = jnp.stack(
        [
            (outs & np.uint32(0xFF)).astype(jnp.uint8),
            ((outs >> np.uint32(8)) & np.uint32(0xFF)).astype(jnp.uint8),
            ((outs >> np.uint32(16)) & np.uint32(0xFF)).astype(jnp.uint8),
            ((outs >> np.uint32(24)) & np.uint32(0xFF)).astype(jnp.uint8),
        ],
        axis=3,
    )  # [nb, 17, 2, 4, B]
    B = by.shape[-1]
    return by.reshape(n_blocks * RATE, B)[:n_out]


@partial(jax.jit, static_argnums=(1,))
def shake256_squeeze(state, n_out: int):
    """Squeeze ``n_out`` bytes from each sponge.  state: uint32[25, 2, B] ->
    uint8[B, n_out]."""
    return shake256_squeeze_lanes(_to_lanes(state), n_out)


@partial(jax.jit, static_argnums=(2,))
def shake256_batch(buf, lens, n_out: int):
    """Batched SHAKE256: ragged payloads -> uint8[B, n_out] XOF streams.
    Bit-exact twin of ``hashlib.shake_256(payload).digest(n_out)`` per lane."""
    return shake256_squeeze_lanes(shake256_absorb_lanes(buf, lens), n_out)


def pad_payloads(payloads) -> tuple:
    """Host helper: list of bytes -> (uint8[B, max_blocks*RATE], int32[B])."""
    lens = np.array([len(p) for p in payloads], dtype=np.int32)
    max_blocks = int(max(lens, default=0)) // RATE + 1
    buf = np.zeros((len(payloads), max_blocks * RATE), dtype=np.uint8)
    for i, p in enumerate(payloads):
        buf[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
    return buf, lens
