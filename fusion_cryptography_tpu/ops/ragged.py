"""Device ragged byte assembly: decimal rendering + variable-length concat.

The reference hashes Python ``str()`` reprs of its object graphs (SURVEY.md
§2.14): preimages are long ASCII strings interleaving fixed boilerplate with
variable-width decimal integers.  To keep the whole hash pipeline on-device,
these preimages are assembled as tensors:

* :func:`render_decimal` turns int32 values into right-aligned 11-byte decimal
  fields (sign + up to 10 digits — any centered representative mod a 31-bit
  prime fits) plus (start, length) pairs describing the occupied suffix;
* :func:`ragged_concat` concatenates per-row segment lists — each segment a
  (source offset, length) view into a per-row byte pool — into one contiguous
  byte buffer per row via cumsum + searchsorted + a single gather;
* :class:`Chunk` + :func:`merge` / :func:`merge_cells` implement ragged concat
  by *recursive doubling with barrel shifts* instead of gathers.

The gather formulation of ``ragged_concat`` is kept for small shapes and as a
reference oracle; the Chunk algorithm never gathers:
content is carried *left-aligned with zeroed scratch*, and concatenating two
chunks places the right chunk at the left chunk's static maximum width and
barrel-shifts it left by the (dynamic) slack ``max_len - len`` — a sequence of
``ceil(log2(slack_range))`` masked static shifts, all elementwise ops.
Leaves with a shared shape (the "sep + decimal number" cells that dominate the
Fusion preimages) are merged as a single [B, K, W] tensor, halving K per level,
so the whole assembly is O(total_bytes * log) elementwise work.

Everything is static-shape, branch-free, and feeds ops/keccak.py's masked
absorb.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_I32 = jnp.int32
_U32 = jnp.uint32

DEC_W = 11  # '-' + 10 digits covers |v| < 2**31


def render_decimal(values):
    """int32[..., K] -> (field uint8[..., K, DEC_W], start int32[..., K],
    length int32[..., K]).

    ``field[..., start:start+length]`` are exactly the bytes of ``str(v)``
    (right-aligned; bytes before ``start`` are scratch).
    """
    v = jnp.asarray(values, _I32)
    neg = v < 0
    a = jnp.where(neg, -v, v).astype(_U32)  # |int32 min| never occurs (|v| <= q//2)
    # divmod chain builds digits right-to-left at static positions
    digs = []
    cur = a
    for _ in range(DEC_W - 1):
        nxt = cur // np.uint32(10)
        digs.append((cur - nxt * np.uint32(10)).astype(jnp.uint8) + np.uint8(ord("0")))
        cur = nxt
    field = jnp.stack(digs[::-1], axis=-1)  # [..., 10], most-significant first
    nd = jnp.ones(a.shape, _I32)
    for k in range(1, DEC_W - 1):
        nd = nd + (a >= np.uint32(10**k)).astype(_I32)
    length = nd + neg.astype(_I32)
    start = np.int32(DEC_W) - length
    # prepend one scratch byte column, then drop the sign into place
    field = jnp.concatenate(
        [jnp.zeros(field.shape[:-1] + (1,), jnp.uint8), field], axis=-1
    )  # [..., 11]
    pos = jax.lax.broadcasted_iota(_I32, field.shape, field.ndim - 1)
    sign_here = neg[..., None] & (pos == start[..., None])
    return jnp.where(sign_here, np.uint8(ord("-")), field), start, length


def ragged_concat(pool, seg_off, seg_len, out_max: int):
    """Concatenate per-row ragged segments into contiguous byte rows.

    pool:    uint8[B, M]   per-row byte pool (templates + rendered numbers)
    seg_off: int32[B, S]   start of each segment inside ``pool``'s row
    seg_len: int32[B, S]   live bytes of each segment
    out_max: static upper bound on the concatenated length

    Returns (buf uint8[B, out_max], total int32[B]).  Bytes at or beyond
    ``total`` in ``buf`` are unspecified scratch (keccak absorb masks them).
    """
    B, S = seg_off.shape
    starts = jnp.cumsum(seg_len, axis=1) - seg_len  # exclusive cumsum [B, S]
    total = starts[:, -1] + seg_len[:, -1]
    pos = jnp.arange(out_max, dtype=_I32)
    # segment owning each output byte: last s with starts[s] <= p
    s_idx = jax.vmap(lambda st: jnp.searchsorted(st, pos, side="right"))(starts) - 1
    s_idx = jnp.clip(s_idx, 0, S - 1)
    r = pos[None, :] - jnp.take_along_axis(starts, s_idx, axis=1)
    src = jnp.take_along_axis(seg_off, s_idx, axis=1) + r
    src = jnp.clip(src, 0, pool.shape[1] - 1)  # tail positions read scratch
    return jnp.take_along_axis(pool, src, axis=1), total


# ---------------------------------------------------------------------------
# Gather-free ragged concat: recursive doubling with barrel shifts
# ---------------------------------------------------------------------------


from dataclasses import dataclass  # noqa: E402  (kept local to the section)


@dataclass
class Chunk:
    """A batch of ragged byte strings in normal form.

    buf:     uint8[B, (K,) W] — content left-aligned, bytes at or beyond
             ``length`` are ZERO (the merge algebra relies on it: placing a
             chunk onto another is a plain OR)
    length:  int32[B(, K)]
    max_len: static upper bound on ``length`` (<= W)
    min_len: static lower bound on ``length``
    """

    buf: jnp.ndarray
    length: jnp.ndarray
    max_len: int
    min_len: int


def shift_left_bytes(buf, s, max_s: int):
    """Shift rows of ``buf`` left by the per-row byte counts ``s`` (zero fill).

    buf: uint8[..., W]; s: int32[...] with 0 <= s <= max_s (static).
    A barrel shifter: one masked static shift per bit of ``max_s``.
    """
    if max_s <= 0:
        return buf
    W = buf.shape[-1]
    s = s.astype(_I32)
    bit = 1
    while bit <= max_s:
        if bit < W:
            shifted = jnp.pad(buf[..., bit:], [(0, 0)] * (buf.ndim - 1) + [(0, bit)])
        else:
            shifted = jnp.zeros_like(buf)
        take = ((s & bit) != 0)[..., None]
        buf = jnp.where(take, shifted, buf)
        bit <<= 1
    return buf


def merge(a: Chunk, b: Chunk) -> Chunk:
    """Concatenate two chunk batches: result[i] = a[i] ++ b[i].

    Places ``b`` at ``a``'s static max width, then barrel-shifts it left by
    the dynamic slack ``a.max_len - a.length``.
    """
    W = a.max_len + b.max_len
    lead = a.max_len
    pa = a.buf[..., :lead] if a.buf.shape[-1] >= lead else a.buf
    pa = jnp.pad(pa, [(0, 0)] * (pa.ndim - 1) + [(0, W - pa.shape[-1])])
    pb = b.buf[..., : b.max_len]
    pb = jnp.pad(pb, [(0, 0)] * (pb.ndim - 1) + [(lead, W - lead - pb.shape[-1])])
    pb = shift_left_bytes(pb, a.max_len - a.length, a.max_len - a.min_len)
    return Chunk(
        buf=pa | pb,
        length=a.length + b.length,
        max_len=a.max_len + b.max_len,
        min_len=a.min_len + b.min_len,
    )


def _split_pairs(c: Chunk):
    """[B, K, W] chunk -> (pairs even/odd as two [B, K//2, W] chunks, odd tail)."""
    K = c.buf.shape[1]
    half = K // 2
    even = Chunk(c.buf[:, 0 : 2 * half : 2], c.length[:, 0 : 2 * half : 2], c.max_len, c.min_len)
    odd = Chunk(c.buf[:, 1 : 2 * half : 2], c.length[:, 1 : 2 * half : 2], c.max_len, c.min_len)
    tail = None
    if K % 2:
        tail = Chunk(c.buf[:, K - 1], c.length[:, K - 1], c.max_len, c.min_len)
    return even, odd, tail


def merge_cells(cells: Chunk) -> Chunk:
    """Reduce a uniform [B, K, W] cell batch to one [B, K*max_len] chunk by
    pairwise merging (log2 K vectorized levels).  Odd tails at each level are
    folded in at the end in reverse order (so concat order is preserved)."""
    tails = []
    cur = cells
    while cur.buf.shape[1] > 1:
        even, odd, tail = _split_pairs(cur)
        if tail is not None:
            tails.append(tail)
        cur = merge(even, odd)
    out = Chunk(cur.buf[:, 0], cur.length[:, 0], cur.max_len, cur.min_len)
    for t in reversed(tails):
        out = merge(out, t)
    return out


def fold_chunks(nodes) -> Chunk:
    """Merge a heterogeneous chunk list into one, pairing adjacent nodes so the
    barrel widths stay balanced (log depth)."""
    nodes = list(nodes)
    if not nodes:
        raise ValueError("fold_chunks needs at least one chunk")
    while len(nodes) > 1:
        nxt = []
        for i in range(0, len(nodes) - 1, 2):
            nxt.append(merge(nodes[i], nodes[i + 1]))
        if len(nodes) % 2:
            nxt.append(nodes[-1])
        nodes = nxt
    return nodes[0]


# ---------------------------------------------------------------------------
# Lane-major ("..., B"-trailing) variants — the production layout.
#
# Byte strings are at most a few KB wide but batches are tens of thousands
# of rows, so carrying buffers as uint8[W, B] (batch minor) keeps every
# elementwise op contiguous along the batch,
# while the batch-major [B, W] forms above waste (128 - W%128)/128 of each
# register on narrow cell widths.  ops/keccak.py already works lane-major
# (uint32[..., B] lane tuples); these variants let the whole preimage pipeline
# stay in that layout with zero transposes.
# ---------------------------------------------------------------------------


def render_decimal_lm(values, byte_dtype=jnp.uint8):
    """int32[..., B] -> (field byte_dtype[..., DEC_W, B], start, length int32[..., B]).

    Lane-major twin of :func:`render_decimal`: the decimal axis is inserted
    *before* the trailing batch axis.  ``byte_dtype`` selects the byte
    carrier: uint8 for the XLA path, int16 inside Pallas kernels (Mosaic has
    no i8 vector arithmetic and no i16 comparisons — every comparison here is
    on int32/uint32 operands, only the selects run in ``byte_dtype``).
    """
    bd = jnp.dtype(byte_dtype)
    v = jnp.asarray(values, _I32)
    neg = v < 0
    a = jnp.where(neg, -v, v).astype(_U32)
    digs = []
    cur = a
    for _ in range(DEC_W - 1):
        nxt = cur // np.uint32(10)
        digs.append((cur - nxt * np.uint32(10) + np.uint32(ord("0"))).astype(bd))
        cur = nxt
    field = jnp.stack(digs[::-1], axis=-2)  # [..., 10, B]
    nd = jnp.ones(a.shape, _I32)
    for k in range(1, DEC_W - 1):
        nd = nd + (a >= np.uint32(10**k)).astype(_I32)
    length = nd + neg.astype(_I32)
    start = np.int32(DEC_W) - length
    field = jnp.concatenate(
        [jnp.zeros(field.shape[:-2] + (1,) + field.shape[-1:], bd), field],
        axis=-2,
    )  # [..., 11, B]
    pos = jax.lax.broadcasted_iota(_I32, field.shape, field.ndim - 2)
    sign_here = neg[..., None, :] & (pos == start[..., None, :])
    return jnp.where(sign_here, jnp.asarray(ord("-"), bd), field), start, length


def shift_left_lm(buf, s, max_s: int):
    """Barrel-shift along axis -2 (the byte axis) by per-lane counts ``s``.

    buf: uint8[..., W, B]; s: int32[..., B], 0 <= s <= max_s.
    """
    if max_s <= 0:
        return buf
    W = buf.shape[-2]
    s = s.astype(_I32)
    pad_spec = [(0, 0)] * buf.ndim
    bit = 1
    while bit <= max_s:
        if bit < W:
            p = list(pad_spec)
            p[-2] = (0, bit)
            shifted = jnp.pad(buf[..., bit:, :], p)
        else:
            shifted = jnp.zeros_like(buf)
        take = ((s & bit) != 0)[..., None, :]
        buf = jnp.where(take, shifted, buf)
        bit <<= 1
    return buf


def merge_lm(a: Chunk, b: Chunk) -> Chunk:
    """Lane-major concat: buffers are uint8[..., W, B], lengths int32[..., B]."""
    W = a.max_len + b.max_len
    lead = a.max_len
    pa = a.buf[..., :lead, :]
    pad_a = [(0, 0)] * pa.ndim
    pad_a[-2] = (0, W - pa.shape[-2])
    pa = jnp.pad(pa, pad_a)
    pb = b.buf[..., : b.max_len, :]
    pad_b = [(0, 0)] * pb.ndim
    pad_b[-2] = (lead, W - lead - pb.shape[-2])
    pb = jnp.pad(pb, pad_b)
    pb = shift_left_lm(pb, a.max_len - a.length, a.max_len - a.min_len)
    return Chunk(
        buf=pa | pb,
        length=a.length + b.length,
        max_len=a.max_len + b.max_len,
        min_len=a.min_len + b.min_len,
    )


def merge_cells_lm(cells: Chunk) -> Chunk:
    """Reduce a uniform [K, W, B] cell batch to one [K*max_len, B] chunk by
    pairwise merging along the leading K axis.

    Pairs split via a [K/2, 2, W, B] reshape + unit slices (contiguous) —
    strided slicing like ``buf[0::2]`` lowers to a >2D gather, which Mosaic
    rejects when this runs inside a Pallas kernel.
    """
    tails = []
    cur = cells
    while cur.buf.shape[0] > 1:
        K = cur.buf.shape[0]
        half = K // 2
        if K % 2:
            tails.append(Chunk(cur.buf[K - 1], cur.length[K - 1], cur.max_len, cur.min_len))
        pb = cur.buf[: 2 * half].reshape(half, 2, *cur.buf.shape[1:])
        plen = cur.length[: 2 * half].reshape(half, 2, *cur.length.shape[1:])
        even = Chunk(pb[:, 0], plen[:, 0], cur.max_len, cur.min_len)
        odd = Chunk(pb[:, 1], plen[:, 1], cur.max_len, cur.min_len)
        cur = merge_lm(even, odd)
    out = Chunk(cur.buf[0], cur.length[0], cur.max_len, cur.min_len)
    for t in reversed(tails):
        out = merge_lm(out, t)
    return out


def fold_chunks_lm(nodes) -> Chunk:
    """Lane-major :func:`fold_chunks`."""
    nodes = list(nodes)
    if not nodes:
        raise ValueError("fold_chunks_lm needs at least one chunk")
    while len(nodes) > 1:
        nxt = []
        for i in range(0, len(nodes) - 1, 2):
            nxt.append(merge_lm(nodes[i], nodes[i + 1]))
        if len(nodes) % 2:
            nxt.append(nodes[-1])
        nodes = nxt
    return nodes[0]
