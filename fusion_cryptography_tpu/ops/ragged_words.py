"""Word-carrier ragged byte assembly: uint32-packed strings, 4 bytes per lane.

The byte-carrier assembly (ops/ragged.py) moves uint8[W, B] buffers through
O(log) barrel-shift passes, one element per byte.  This module carries the
same ragged strings as *little-endian packed words* uint32[ceil(W/4), B],
4 bytes per element:

* byte j of the string is bits ``8*(j%4) .. 8*(j%4)+7`` of word ``j//4`` —
  exactly the SHAKE/Keccak lane packing, so assembled preimages feed
  ops/keccak.py's sponge with ZERO repacking (the byte path spends ~10 ops/B
  masking + widening bytes into words before every absorb);
* barrel shifts decompose into a word-level barrel (log2(max_s/4) passes over
  W/4 lanes) plus ONE dynamic sub-word pass — ~4x fewer elementwise ops
  than the byte-level barrel;
* merges place the right chunk with a *static* sub-word rotation (compile-time
  lead%4) and OR, preserving the byte-path algebra (content left-aligned,
  zero scratch).

Bit-exactness vs the byte path is asserted in tests/test_ragged_words.py.
Shapes follow the lane-major convention (batch minor): buf uint32[..., Ww, B],
length int32[..., B] counted in BYTES.

Reference behavior reproduced: the hashed ``str()`` preimages of
/root/reference/fusion/fusion.py:417 and :586-589 (decimal renders
interleaved with template text) and the ``str(int)`` prehash rendering of
fusion.py:405-409 (:func:`render_bigint_dec_w`).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

_I32 = jnp.int32
_U32 = jnp.uint32

DEC_W = 11  # '-' + 10 digits covers |v| < 2**31 (ops/ragged.py contract)
DEC_WW = 3  # ceil(12 / 4) words per decimal field


def words_for(nbytes: int) -> int:
    """Words needed to carry ``nbytes`` bytes."""
    return -(-nbytes // 4)


@dataclass
class WChunk:
    """A batch of ragged byte strings in packed-word normal form.

    buf:     uint32[(K,) Ww, B] — content left-aligned from byte 0, packed
             little-endian (byte j at bits 8*(j%4) of word j//4); bytes at or
             beyond ``length`` are ZERO.
    length:  int32[(K,) B] — live BYTES
    max_len: static upper bound on ``length`` (<= 4*Ww)
    min_len: static lower bound on ``length``
    """

    buf: jnp.ndarray
    length: jnp.ndarray
    max_len: int
    min_len: int


def pack_bytes_to_words(buf, nw: int = None):
    """uint8[..., W, B] -> uint32[..., ceil(W/4), B] little-endian packed.

    Used only at word-path boundaries (host-uploaded byte fields); the hot
    path never materializes byte arrays.
    """
    W, B = buf.shape[-2], buf.shape[-1]
    if nw is None:
        nw = words_for(W)
    pad = nw * 4 - W
    if pad:
        spec = [(0, 0)] * buf.ndim
        spec[-2] = (0, pad)
        buf = jnp.pad(buf, spec)
    w = buf.reshape(*buf.shape[:-2], nw, 4, B).astype(_U32)
    return (
        w[..., 0, :]
        | (w[..., 1, :] << np.uint32(8))
        | (w[..., 2, :] << np.uint32(16))
        | (w[..., 3, :] << np.uint32(24))
    )


def unpack_words_to_bytes(words, nbytes: int = None):
    """uint32[..., Ww, B] -> uint8[..., nbytes, B] (testing / decode boundary)."""
    Ww, B = words.shape[-2], words.shape[-1]
    if nbytes is None:
        nbytes = 4 * Ww
    by = jnp.stack(
        [
            (words & np.uint32(0xFF)).astype(jnp.uint8),
            ((words >> np.uint32(8)) & np.uint32(0xFF)).astype(jnp.uint8),
            ((words >> np.uint32(16)) & np.uint32(0xFF)).astype(jnp.uint8),
            ((words >> np.uint32(24)) & np.uint32(0xFF)).astype(jnp.uint8),
        ],
        axis=-2,
    )  # [..., Ww, 4, B]
    return by.reshape(*words.shape[:-2], 4 * Ww, B)[..., :nbytes, :]


def pack_const_words(data: bytes) -> np.ndarray:
    """Static bytes -> uint32[ceil(len/4)] little-endian packed (host-side)."""
    b = np.frombuffer(data, dtype=np.uint8)
    pad = (-len(b)) % 4
    if pad:
        b = np.concatenate([b, np.zeros(pad, np.uint8)])
    return b.view("<u4")


def mask_tail_w(buf, length):
    """Zero all bytes at or beyond ``length``.  buf uint32[..., Ww, B];
    length int32[..., B] broadcastable against buf's batch axes."""
    Ww = buf.shape[-2]
    wi = jax.lax.broadcasted_iota(_I32, buf.shape, buf.ndim - 2)
    keep = jnp.clip(length[..., None, :] - 4 * wi, 0, 4)  # bytes kept per word
    # (1 << 8*keep) - 1 with keep==4 -> all ones (avoid the 1<<32 overflow)
    mask = jnp.where(
        keep >= 4,
        np.uint32(0xFFFFFFFF),
        (np.uint32(1) << (np.uint32(8) * keep.astype(_U32))) - np.uint32(1),
    )
    return buf & mask


def shift_right_w_static(buf, r: int):
    """Shift strings RIGHT by the static byte count r in [0, 4): byte j of the
    output is byte j-r of the input (little-endian: multiply by 256^r with
    word carry).  Output has the same word width (callers pre-pad)."""
    if r == 0:
        return buf
    sh = np.uint32(8 * r)
    csh = np.uint32(32 - 8 * r)
    lo = buf << sh
    spec = [(0, 0)] * buf.ndim
    spec[-2] = (1, 0)
    carry = jnp.pad(buf[..., :-1, :], spec) >> csh
    return lo | carry


def shift_left_w(buf, s, max_s: int):
    """Shift strings LEFT by per-lane dynamic byte counts ``s`` (zero fill).

    buf: uint32[..., Ww, B]; s: int32[..., B], 0 <= s <= max_s (static).
    One dynamic sub-word pass (s % 4) + a word-level barrel over s // 4.
    """
    if max_s <= 0:
        return buf
    s = s.astype(_I32)
    # sub-word pass: shift left by r = s % 4 bytes
    r = (s & 3).astype(_U32)[..., None, :]  # [..., 1, B]
    sa = np.uint32(8) * r
    spec = [(0, 0)] * buf.ndim
    spec[-2] = (0, 1)
    nxt = jnp.pad(buf[..., 1:, :], spec)
    hi = jnp.where(sa > 0, nxt << (np.uint32(32) - sa), np.uint32(0))
    buf = jnp.where(sa > 0, (buf >> sa) | hi, buf)
    # word-level barrel over wq = s // 4, radix 4.  Every pass pre-pads the
    # buffer ONCE and takes its shifted operands as SLICES of that one array:
    # XLA fuses slice operands into the select but materializes pad-created
    # operands, so each pass reads one array instead of several.
    # FUSION_RADIX2_BARREL=1 falls back to a radix-2 where-chain (debug knob,
    # same slice trick).
    import os

    wq = s >> 2
    max_wq = max_s >> 2
    Ww = buf.shape[-2]

    def ext_pad(b, n):
        spec = [(0, 0)] * b.ndim
        spec[-2] = (0, n)
        return jnp.pad(b, spec)

    def sl(b, k):
        return jax.lax.slice_in_dim(b, k, k + Ww, axis=b.ndim - 2)

    if os.environ.get("FUSION_RADIX2_BARREL"):
        bit = 1
        while bit <= max_wq:
            ext = ext_pad(buf, bit)
            take = ((wq & bit) != 0)[..., None, :]
            buf = jnp.where(take, sl(ext, bit), buf)
            bit <<= 1
        return buf

    step = 1
    while step <= max_wq:
        hi = min(3, max_wq // step)
        ext = ext_pad(buf, hi * step)
        sel = jnp.minimum((wq // step) & 3, hi)[..., None, :]
        sel = jnp.broadcast_to(sel, buf.shape)
        buf = jax.lax.select_n(sel, *[sl(ext, k * step) for k in range(hi + 1)])
        step <<= 2
    return buf


def shift_right_w_dyn(buf, r, max_r: int):
    """Shift strings RIGHT by per-lane dynamic byte counts ``r`` (zero fill):
    byte j of the output is byte j - r of the input.  Mirror of
    :func:`shift_left_w` (sub-word pass + radix-4 word barrel with slice
    operands of one pre-padded buffer)."""
    if max_r <= 0:
        return buf
    r = r.astype(_I32)
    rs = (r & 3).astype(_U32)[..., None, :]
    sa = np.uint32(8) * rs
    spec = [(0, 0)] * buf.ndim
    spec[-2] = (1, 0)
    prv = jnp.pad(buf[..., :-1, :], spec)
    lo = jnp.where(sa > 0, prv >> (np.uint32(32) - sa), np.uint32(0))
    buf = jnp.where(sa > 0, (buf << sa) | lo, buf)
    wq = r >> 2
    max_wq = max_r >> 2
    Ww = buf.shape[-2]

    def ext_pad(bb, n):
        sp = [(0, 0)] * bb.ndim
        sp[-2] = (n, 0)
        return jnp.pad(bb, sp)

    def sl(bb, k):
        lo_i = bb.shape[-2] - Ww - k
        return jax.lax.slice_in_dim(bb, lo_i, lo_i + Ww, axis=bb.ndim - 2)

    step = 1
    while step <= max_wq:
        hi = min(3, max_wq // step)
        ext = ext_pad(buf, hi * step)
        sel = jnp.minimum((wq // step) & 3, hi)[..., None, :]
        sel = jnp.broadcast_to(sel, buf.shape)
        buf = jax.lax.select_n(sel, *[sl(ext, k * step) for k in range(hi + 1)])
        step <<= 2
    return buf


# A merge's barrel runs log4 passes over the whole placement window; when the
# right chunk is much SMALLER than the left chunk's slack (e.g. the ~80-byte
# prehash placed after a ~6.6 KB vk body with ~4.5 KB of slack), placing it
# block-aligned is far cheaper: one narrow dynamic sub-block shift of the
# small content plus a single masked-select scatter pass over the window.
_SCATTER_MIN_SLACK_RATIO = 8


def _merge_w_scatter(a: WChunk, b: WChunk, Ww: int) -> WChunk:
    """Placement half of :func:`merge_w` for small-b merges: returns the
    merged chunk with b's bytes starting at byte ``a.length`` — bit-identical
    to the barrel path (tests/test_ragged_words.py)."""
    pa = a.buf
    if pa.shape[-2] < Ww:
        spec = [(0, 0)] * pa.ndim
        spec[-2] = (0, Ww - pa.shape[-2])
        pa = jnp.pad(pa, spec)
    else:
        pa = pa[..., :Ww, :]
    b_w = words_for(b.max_len)
    # sub-block stage: C words per block; shift b right by t % 4C bytes
    C = 8
    while C < b_w:
        C *= 2
    Pw = b_w + C
    pb = b.buf[..., :b_w, :]
    spec = [(0, 0)] * pb.ndim
    spec[-2] = (0, Pw - pb.shape[-2])
    pb = jnp.pad(pb, spec)
    t = a.length  # byte offset of b's start, in [a.min_len, a.max_len]
    t_sub = t % np.int32(4 * C)
    placed = shift_right_w_dyn(pb, t_sub, 4 * C - 1)  # [.., Pw, B]
    t_blk = (t // np.int32(4 * C)).astype(_I32)[..., None, :]
    k_min = a.min_len // (4 * C)
    k_max = a.max_len // (4 * C)
    nblk = -(-Ww // C)
    zeros_blk = jnp.zeros(placed.shape[:-2] + (C,) + placed.shape[-1:], _U32)
    blocks = []
    for p in range(nblk):
        acc = None
        for k in range(max(k_min, p - (Pw - 1) // C), min(k_max, p) + 1):
            off = (p - k) * C
            seg = placed[..., off : off + C, :]
            if seg.shape[-2] < C:
                sp = [(0, 0)] * seg.ndim
                sp[-2] = (0, C - seg.shape[-2])
                seg = jnp.pad(seg, sp)
            term = jnp.where(t_blk == k, seg, np.uint32(0))
            acc = term if acc is None else acc | term
        blocks.append(zeros_blk if acc is None else acc)
    scat = jnp.concatenate(blocks, axis=-2)[..., :Ww, :]
    return WChunk(
        buf=pa | scat,
        length=a.length + b.length,
        max_len=a.max_len + b.max_len,
        min_len=a.min_len + b.min_len,
    )


def merge_w(a: WChunk, b: WChunk) -> WChunk:
    """Concatenate two word-chunk batches: result[i] = a[i] ++ b[i].

    NARROW barrel: ``b``'s final byte position is ``a.length`` which lies in
    ``[a.min_len, a.max_len]``, so the dynamic shift only ever moves content
    within a window of ``slack + b.max_len`` bytes starting at byte
    ``a.min_len``.  b is therefore rotated/placed inside that narrow window
    (byte q0 = a.min_len%4 + slack, whose sub-word phase equals a.max_len's),
    barrel-shifted there, and only then statically padded out to the full
    output width — the barrel never touches the ``a.min_len // 4`` guaranteed
    words, which for const-heavy chunks is most of the buffer.
    """
    W = a.max_len + b.max_len
    Ww = words_for(W)
    slack = a.max_len - a.min_len
    if (slack >= _SCATTER_MIN_SLACK_RATIO * (b.max_len + 4)
            and a.buf.ndim == b.buf.ndim):
        return _merge_w_scatter(a, b, Ww)
    # a: already at byte 0; pad to Ww words
    pa = a.buf
    if pa.shape[-2] < Ww:
        spec = [(0, 0)] * pa.ndim
        spec[-2] = (0, Ww - pa.shape[-2])
        pa = jnp.pad(pa, spec)
    else:
        pa = pa[..., :Ww, :]
    # b inside the narrow window: rotate to q0's sub-word phase, place at
    # word q0//4 of an (Ww - base_w)-word buffer
    base_w = a.min_len // 4
    nw = Ww - base_w
    q0 = (a.min_len % 4) + slack
    lr = q0 % 4  # == a.max_len % 4
    pb = b.buf
    need = words_for(b.max_len + lr)
    if pb.shape[-2] < need:
        spec = [(0, 0)] * pb.ndim
        spec[-2] = (0, need - pb.shape[-2])
        pb = jnp.pad(pb, spec)
    pb = shift_right_w_static(pb, lr)
    spec = [(0, 0)] * pb.ndim
    spec[-2] = (q0 // 4, max(0, nw - q0 // 4 - pb.shape[-2]))
    pb = jnp.pad(pb, spec)[..., :nw, :]
    pb = shift_left_w(pb, a.max_len - a.length, slack)
    if base_w:
        spec = [(0, 0)] * pb.ndim
        spec[-2] = (base_w, 0)
        pb = jnp.pad(pb, spec)
    return WChunk(
        buf=pa | pb,
        length=a.length + b.length,
        max_len=W,
        min_len=a.min_len + b.min_len,
    )


def merge_cells_w(cells: WChunk) -> WChunk:
    """Reduce a uniform [K, Ww, B] cell batch to one [Ww*, B] chunk by
    pairwise merging along the leading K axis (log2 K vectorized levels);
    odd tails fold in at the end in reverse order (concat order preserved)."""
    tails = []
    cur = cells
    while cur.buf.shape[0] > 1:
        K = cur.buf.shape[0]
        half = K // 2
        if K % 2:
            tails.append(WChunk(cur.buf[K - 1], cur.length[K - 1], cur.max_len, cur.min_len))
        pb = cur.buf[: 2 * half].reshape(half, 2, *cur.buf.shape[1:])
        plen = cur.length[: 2 * half].reshape(half, 2, *cur.length.shape[1:])
        even = WChunk(pb[:, 0], plen[:, 0], cur.max_len, cur.min_len)
        odd = WChunk(pb[:, 1], plen[:, 1], cur.max_len, cur.min_len)
        cur = merge_w(even, odd)
    out = WChunk(cur.buf[0], cur.length[0], cur.max_len, cur.min_len)
    for t in reversed(tails):
        out = merge_w(out, t)
    return out


def fold_chunks_w(nodes) -> WChunk:
    """Merge a heterogeneous chunk list into one (log depth, order preserved)."""
    nodes = list(nodes)
    if not nodes:
        raise ValueError("fold_chunks_w needs at least one chunk")
    while len(nodes) > 1:
        nxt = []
        for i in range(0, len(nodes) - 1, 2):
            nxt.append(merge_w(nodes[i], nodes[i + 1]))
        if len(nodes) % 2:
            nxt.append(nodes[-1])
        nodes = nxt
    return nodes[0]


PREHASH_DIGITS = 78  # str(int.from_bytes(sha3_256 digest, 'little')) <= 78 digits


def render_bigint_dec_w(digest_words) -> WChunk:
    """256-bit little-endian integers -> left-aligned decimal strings.

    digest_words: uint32[8, B] (little-endian limbs — exactly
    keccak.sha3_256_words output).  Returns a WChunk of ``str(int)`` bytes
    (max 78 digits; no sign), the device twin of the host prehash digit
    rendering (scheme/device_pipeline.prehash_digits).

    Digits come from 78 repeated divmod-by-10 passes over the limbs, each
    pass in u32-safe 16-bit halves (r*2^16 + half < 2^20).
    """
    B = digest_words.shape[-1]

    def divmod10(limbs):
        """One divmod-by-10 sweep over [8, B] little-endian u32 limbs ->
        (quotient limbs, remainder digit [B])."""
        r = jnp.zeros((B,), _U32)
        nxt = []
        for k in range(7, -1, -1):
            w = limbs[k]
            hi = w >> np.uint32(16)
            lo = w & np.uint32(0xFFFF)
            r1 = (r << np.uint32(16)) | hi
            qhi = r1 // np.uint32(10)
            r2 = ((r1 - qhi * np.uint32(10)) << np.uint32(16)) | lo
            qlo = r2 // np.uint32(10)
            r = r2 - qlo * np.uint32(10)
            nxt.append((qhi << np.uint32(16)) | qlo)
        return jnp.stack(nxt[::-1]), r

    # a scan keeps the program one sweep long: the 5k-op unrolled chain
    # makes XLA's compile take minutes (CPU and GPU alike)
    def step(limbs, _):
        limbs, r = divmod10(limbs)
        return limbs, r + np.uint32(ord("0"))

    _, digs = jax.lax.scan(step, digest_words, None, length=PREHASH_DIGITS)
    planes = [digs[t] for t in range(PREHASH_DIGITS)]
    # field: 80 bytes (20 words), right-aligned: byte 79-t is digit t (LSB t)
    # bytes 0..1 are scratch zeros
    byte_planes = [jnp.zeros((B,), _U32), jnp.zeros((B,), _U32)] + planes[::-1]
    field = jnp.stack(
        [
            byte_planes[4 * w]
            | (byte_planes[4 * w + 1] << np.uint32(8))
            | (byte_planes[4 * w + 2] << np.uint32(16))
            | (byte_planes[4 * w + 3] << np.uint32(24))
            for w in range(20)
        ]
    )  # [20, B]
    # length = index of the most significant nonzero digit + 1 (min 1: "0")
    t_idx = jnp.arange(PREHASH_DIGITS, dtype=_I32)[:, None]  # LSB-first index
    nz = jnp.stack([p != np.uint32(ord("0")) for p in planes])  # [78, B]
    length = jnp.maximum(jnp.max(jnp.where(nz, t_idx + 1, 0), axis=0), 1)
    field = shift_left_w(field, np.int32(80) - length, 79)
    field = mask_tail_w(field, length)
    return WChunk(buf=field, length=length, max_len=PREHASH_DIGITS, min_len=1)


def render_decimal_cells_w(values, sep: bytes) -> WChunk:
    """int32[K, B] -> left-aligned ``sep ++ str(v)`` cells as a word chunk.

    Exactly the byte path's cell content (ops/ragged.render_decimal_lm +
    device_serial._number_cells_lm): sign + up to 10 digits, preceded by the
    static separator, packed into words with zero scratch.
    """
    v = jnp.asarray(values, _I32)
    neg = v < 0
    a = jnp.where(neg, -v, v).astype(_U32)
    # digit planes, most-significant first: b[1..10] of the 11-byte field
    digs = []
    cur = a
    for _ in range(DEC_W - 1):
        nxt = cur // np.uint32(10)
        digs.append((cur - nxt * np.uint32(10) + np.uint32(ord("0"))))
        cur = nxt
    digs = digs[::-1]  # [K, B] u32 each, values 0x30..0x39
    nd = jnp.ones(a.shape, _I32)
    for k in range(1, DEC_W - 1):
        nd = nd + (a >= np.uint32(10**k)).astype(_I32)
    length = nd + neg.astype(_I32)
    start = np.int32(DEC_W) - length  # position of '-' / first digit in field
    # pack the 12-byte field [scratch | d0..d9 | pad] into 3 words
    planes = [jnp.zeros_like(a)] + digs + [jnp.zeros_like(a)]
    field = jnp.stack(
        [
            planes[4 * w]
            | (planes[4 * w + 1] << np.uint32(8))
            | (planes[4 * w + 2] << np.uint32(16))
            | (planes[4 * w + 3] << np.uint32(24))
            for w in range(DEC_WW)
        ],
        axis=-2,
    )  # [K, 3, B] u32
    # drop the sign into byte ``start`` (replace, not OR: leading zeros are 0x30)
    s_w = (start >> 2)[..., None, :]  # [K, 1, B]
    s_r = (np.uint32(8) * (start & 3).astype(_U32))[..., None, :]
    wi = jax.lax.broadcasted_iota(_I32, field.shape, field.ndim - 2)
    hit = neg[..., None, :] & (wi == s_w)
    sign_val = np.uint32(ord("-")) << s_r
    byte_mask = ~(np.uint32(0xFF) << s_r)
    field = jnp.where(hit, (field & byte_mask) | sign_val, field)
    # left-align (shift out the leading scratch) and zero the tail
    field = shift_left_w(field, start, DEC_W - 1)
    field = mask_tail_w(field, length)
    # prepend the separator: static content, static length -> static placement
    s = len(sep)
    if s == 0:
        return WChunk(buf=field, length=length, max_len=DEC_W, min_len=1)
    K, B = v.shape
    Wc = s + DEC_W
    Ww = words_for(Wc)
    pf = field
    need = words_for(DEC_W + s)
    if pf.shape[-2] < need:
        pf = jnp.pad(pf, ((0, 0), (0, need - pf.shape[-2]), (0, 0)))
    pf = shift_right_w_static(pf, s % 4)
    pf = jnp.pad(pf, ((0, 0), (s // 4, max(0, Ww - s // 4 - pf.shape[-2])), (0, 0)))[
        :, :Ww, :
    ]
    sep_w = pack_const_words(sep + b"\x00" * ((-len(sep)) % 4))
    sep_col = jnp.asarray(sep_w, dtype=_U32)[None, :, None]
    sep_full = jnp.zeros((1, Ww, 1), _U32).at[:, : len(sep_w), :].set(sep_col)
    return WChunk(
        buf=pf | jnp.broadcast_to(sep_full, pf.shape),
        length=length + np.int32(s),
        max_len=Wc,
        min_len=s + 1,
    )
