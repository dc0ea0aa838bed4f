"""Fused SHAKE256 sponge for NVIDIA GPUs: Pallas through Triton.

The XLA lane sponge (ops/keccak.py) runs every rate block as one step of a
``lax.scan``: on a GPU each step is at least one kernel launch plus the
loop's trip, and each launch covers only the chunk's lanes.  Here the whole
sponge of a lane — absorb every rate block, pad, squeeze every output block —
is one loop inside one kernel:

* one program owns ``block_lanes`` sponges; its 50 ``uint32`` state words
  stay in registers for the whole sponge;
* a loop over rate blocks reads one 34-word block per step straight from
  device memory (a 42 KB aggregation preimage per lane is never staged), runs
  only as many steps as the block's longest payload, and keeps each lane's
  state once that lane's own payload is absorbed;
* the multi-rate padding (domain byte at the payload length, 0x80 at the last
  rate byte) and the mask of scratch bytes beyond the length are applied as
  the words are read, so the payload is read once and the XOF written once.

The round is ``keccak._keccak_round`` — the same code the XLA sponge traces.
The 24 rounds run as a loop of ``24 / unroll`` steps whose round constants
are read from a 64-word table input.  Triton's compile time grows with the
unrolled code: at
production widths a two-copy, 4-round body took 86 s to compile on an H100
(700 W) and a fully unrolled one had not compiled after 20 minutes; this
single-round loop (absorb and squeeze share it) compiles in 11-12 s.

Layouts match ``keccak.shake256_absorb_words`` / ``shake256_squeeze_words``:
payload uint32[max_blocks*34, B] little-endian packed words, lengths in bytes
int32[B], XOF uint32[n_words, B].
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .keccak import _RC, RATE, RATE_LANES, RATE_WORDS, _keccak_round

_U32 = jnp.uint32

# 32 lanes = one warp per program: 8192 aggregation sponges make 256 programs,
# about two per SM of a 132-SM card (other block sizes: not measured yet)
BLOCK_LANES = 32


# round constants as a kernel input: lo halves at [0, 24), hi at [32, 56)
_RC_TABLE = np.zeros(64, np.uint32)
_RC_TABLE[:24], _RC_TABLE[32:56] = _RC[:, 0], _RC[:, 1]


def _permute(lanes, unroll: int, rc_ref):
    def body(i, ls):
        for k in range(unroll):
            r = i * unroll + k
            ls = _keccak_round(ls, None, None, None, rc=(rc_ref[r], rc_ref[32 + r]))
        return ls

    return jax.lax.fori_loop(0, 24 // unroll, body, lanes)


def _kernel(rc_ref, words_ref, lens_ref, out_ref, *, out_blocks: int, unroll: int,
            block_lanes: int):
    lens = lens_ref[...]
    n_blocks = lens // RATE + 1  # pad10*1 appends at least one byte
    head_word = lens >> 2
    head_val = np.uint32(0x1F) << (np.uint32(8) * (lens & 3).astype(_U32))
    tail_word = n_blocks * RATE_WORDS - 1  # 0x80 is byte 3 of that word

    nb_max = jnp.max(n_blocks)

    def emit(k, lanes):
        for l in range(RATE_LANES):
            out_ref[k * RATE_WORDS + 2 * l, :] = lanes[l][0]
            out_ref[k * RATE_WORDS + 2 * l + 1, :] = lanes[l][1]

    def step(t, lanes):
        """Steps t < nb_max absorb rate block t (each lane only while t is
        below its own block count); step nb_max + k emits output block k
        and permutes for the next.  One permutation in the kernel's code."""
        absorbing = t < nb_max

        @pl.when(jnp.logical_not(absorbing))
        def _():
            emit(t - nb_max, lanes)

        base = jnp.minimum(t, nb_max - 1) * RATE_WORDS
        blk = []
        for w in range(RATE_WORDS):
            wi = base + w
            x = words_ref[wi, :]
            keep = jnp.clip(lens - 4 * wi, 0, 4).astype(_U32)
            x = x & jnp.where(
                keep >= 4,
                np.uint32(0xFFFFFFFF),
                (np.uint32(1) << (np.uint32(8) * keep)) - np.uint32(1),
            )
            x = x | jnp.where(wi == head_word, head_val, np.uint32(0))
            x = x | jnp.where(wi == tail_word, np.uint32(0x80000000), np.uint32(0))
            blk.append(jnp.where(absorbing, x, np.uint32(0)))
        nxt = _permute(
            tuple(
                (lanes[l][0] ^ blk[2 * l], lanes[l][1] ^ blk[2 * l + 1])
                if l < RATE_LANES else lanes[l]
                for l in range(25)
            ),
            unroll, rc_ref,
        )
        live = (t < n_blocks) | jnp.logical_not(absorbing)
        return tuple(
            (jnp.where(live, nxt[l][0], lanes[l][0]),
             jnp.where(live, nxt[l][1], lanes[l][1]))
            for l in range(25)
        )

    zero = jnp.zeros((block_lanes,), _U32)
    lanes = tuple((zero, zero) for _ in range(25))
    lanes = jax.lax.fori_loop(0, nb_max + out_blocks - 1, step, lanes)
    emit(out_blocks - 1, lanes)


@lru_cache(maxsize=64)
def _build(rows: int, lanes: int, out_blocks: int, unroll: int,
           block_lanes: int, interpret: bool):
    from functools import partial

    return jax.jit(pl.pallas_call(
        partial(_kernel, out_blocks=out_blocks, unroll=unroll,
                block_lanes=block_lanes),
        out_shape=jax.ShapeDtypeStruct((out_blocks * RATE_WORDS, lanes), _U32),
        grid=(lanes // block_lanes,),
        in_specs=[
            pl.BlockSpec((64,), lambda i: (0,)),
            pl.BlockSpec((rows, block_lanes), lambda i: (0, i)),
            pl.BlockSpec((block_lanes,), lambda i: (i,)),
        ],
        out_specs=pl.BlockSpec((out_blocks * RATE_WORDS, block_lanes),
                               lambda i: (0, i)),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=max(1, block_lanes // 32), num_stages=1
        ),
        interpret=interpret,
        name="shake256_sponge",
    ))


def shake256_words_triton(words, lens, n_words: int, *, unroll: int = 1,
                          block_lanes: int = BLOCK_LANES,
                          interpret: bool = False):
    """SHAKE256 over packed-word payloads in one kernel:
    uint32[max_blocks*34, B] (lens int[B] in bytes; bytes beyond ``lens`` are
    ignored) -> XOF uint32[n_words, B].  Bit-exact twin of
    ``shake256_squeeze_words(shake256_absorb_words(words, lens), n_words)``.

    Any B: the lane axis is padded to a multiple of ``block_lanes`` with
    empty payloads, whose output is dropped.  Every length must leave room
    for the padding: ``lens < 4 * max_blocks * 34``.  ``unroll`` (rounds
    per loop step, divides 24) and ``block_lanes`` (lanes per program, a
    power of two) are tuning parameters.
    """
    if 24 % unroll:
        raise ValueError(f"unroll must divide 24, got {unroll}")
    if block_lanes & (block_lanes - 1):
        raise ValueError(f"block_lanes must be a power of two, got {block_lanes}")
    words = jnp.asarray(words, _U32)
    rows, B = words.shape
    if rows % RATE_WORDS:
        raise ValueError(f"payload word count {rows} must be a multiple of {RATE_WORDS}")
    Bp = -(-B // block_lanes) * block_lanes
    lens = jnp.asarray(lens).astype(jnp.int32)
    if Bp != B:
        words = jnp.pad(words, ((0, 0), (0, Bp - B)))
        lens = jnp.pad(lens, (0, Bp - B))
    out_blocks = -(-n_words // RATE_WORDS)
    fn = _build(rows, Bp, out_blocks, unroll, block_lanes, interpret)
    return fn(jnp.asarray(_RC_TABLE), words, lens)[:n_words, :B]
