"""Device-side construction of the reference's hashed ``str()`` preimages.

The reference's SHAKE preimages are ASCII reprs of object graphs
(fusion/fusion.py:417, :586-589; formats pinned in interop/serial.py).  Each
preimage is a fixed *template* of boilerplate text interleaved with decimal
renderings of tensor values, so it can be assembled entirely on-device:

  template bytes (static per parameter set)
+ ops.ragged.render_decimal of the int32 value tensors
+ ops.ragged.ragged_concat over a static slot table

A :class:`PreimageSpec` is the compiled slot table: for every slot, whether it
reads template text, a rendered number, or a per-row "extra" byte field
(host-rendered prehash integers, or nested buffers like the aggregation XOF's
triple strings).  ``assemble`` evaluates a spec for a batch in O(1) gathers.

Byte-exactness against interop/serial.py (and therefore against the reference
``str()``s and the KAT corpus) is asserted in tests/test_device_serial.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..ops.ragged import DEC_W, ragged_concat, render_decimal
from .serial import NTT_CLASS

_KIND_CONST, _KIND_NUMBER, _KIND_EXTRA = 0, 1, 2


@dataclass(frozen=True)
class PreimageSpec:
    """Compiled slot table for one preimage layout."""

    template: np.ndarray  # uint8[T] — all constant bytes, concatenated
    kind: np.ndarray  # int32[S]
    arg: np.ndarray  # int32[S]: template offset / number index / extra index
    const_len: np.ndarray  # int32[S] (0 for non-const slots)
    num_numbers: int
    num_extras: int
    extra_widths: Tuple[int, ...]  # static per-extra field width in the pool
    out_max: int  # static bound on assembled length

    def pool_width(self) -> int:
        return len(self.template) + self.num_numbers * DEC_W + sum(self.extra_widths)


class TemplateBuilder:
    """Accumulates const/number/extra slots into a :class:`PreimageSpec`."""

    def __init__(self):
        self._template = bytearray()
        self._slots: List[Tuple[int, int, int]] = []  # (kind, arg, const_len)
        self._extra_widths: List[int] = []
        self._num_numbers = 0

    def const(self, b: bytes) -> "TemplateBuilder":
        if b:
            # merge adjacent const slots
            if self._slots and self._slots[-1][0] == _KIND_CONST:
                k, off, ln = self._slots[-1]
                if off + ln == len(self._template):
                    self._template.extend(b)
                    self._slots[-1] = (k, off, ln + len(b))
                    return self
            self._slots.append((_KIND_CONST, len(self._template), len(b)))
            self._template.extend(b)
        return self

    def number(self) -> "TemplateBuilder":
        self._slots.append((_KIND_NUMBER, self._num_numbers, 0))
        self._num_numbers += 1
        return self

    def numbers(self, n: int, sep: bytes = b", ") -> "TemplateBuilder":
        for k in range(n):
            if k:
                self.const(sep)
            self.number()
        return self

    def extra(self, width: int) -> "TemplateBuilder":
        self._slots.append((_KIND_EXTRA, len(self._extra_widths), 0))
        self._extra_widths.append(width)
        return self

    def build(self) -> PreimageSpec:
        kind = np.array([s[0] for s in self._slots], dtype=np.int32)
        arg = np.array([s[1] for s in self._slots], dtype=np.int32)
        clen = np.array([s[2] for s in self._slots], dtype=np.int32)
        out_max = int(clen.sum()) + self._num_numbers * DEC_W + sum(self._extra_widths)
        return PreimageSpec(
            template=np.frombuffer(bytes(self._template), dtype=np.uint8),
            kind=kind,
            arg=arg,
            const_len=clen,
            num_numbers=self._num_numbers,
            num_extras=len(self._extra_widths),
            extra_widths=tuple(self._extra_widths),
            out_max=out_max,
        )


def assemble(
    spec: PreimageSpec,
    values: Optional[jnp.ndarray] = None,
    extras: Sequence[Tuple[jnp.ndarray, jnp.ndarray]] = (),
):
    """Evaluate ``spec`` for a batch.

    values: int32[B, spec.num_numbers] — the numbers, in slot order;
    extras:  per extra slot a (bytes uint8[B, width], length int32[B]) pair
             whose live content is left-aligned.
    Returns (buf uint8[B, out_max], total int32[B]).
    """
    if len(extras) != spec.num_extras:
        raise ValueError(f"spec needs {spec.num_extras} extras, got {len(extras)}")
    if spec.num_numbers:
        if values is None or values.shape[-1] != spec.num_numbers:
            raise ValueError(f"spec needs int32[B, {spec.num_numbers}] values")
        B = values.shape[0]
        field, n_start, n_len = render_decimal(values)  # [B, K, 11]
        digit_pool = field.reshape(B, spec.num_numbers * DEC_W)
    else:
        B = extras[0][0].shape[0]
        digit_pool = jnp.zeros((B, 0), jnp.uint8)
        n_start = jnp.zeros((B, 0), jnp.int32)
        n_len = jnp.zeros((B, 0), jnp.int32)

    T = len(spec.template)
    pool_parts = [jnp.broadcast_to(jnp.asarray(spec.template), (B, T)), digit_pool]
    ex_base: List[int] = []
    base = T + spec.num_numbers * DEC_W
    for (eb, _), w in zip(extras, spec.extra_widths):
        if eb.shape[1] != w:
            raise ValueError(f"extra width {eb.shape[1]} != spec width {w}")
        ex_base.append(base)
        pool_parts.append(eb)
        base += w
    pool = jnp.concatenate(pool_parts, axis=1)

    kind = spec.kind
    arg = spec.arg
    # number slots: offset = T + k*DEC_W + start[b, k]; length from render
    num_idx = np.where(kind == _KIND_NUMBER, arg, 0)
    ex_idx = np.where(kind == _KIND_EXTRA, arg, 0)
    ex_off = np.array([ex_base[i] if ex_base else 0 for i in ex_idx], dtype=np.int32)
    off_num = np.int32(T) + num_idx.astype(np.int32) * DEC_W
    if spec.num_numbers:
        num_start_by_slot = n_start[:, num_idx]
        num_len_by_slot = n_len[:, num_idx]
    else:
        num_start_by_slot = jnp.zeros((B, len(kind)), jnp.int32)
        num_len_by_slot = jnp.zeros((B, len(kind)), jnp.int32)
    seg_off = jnp.where(
        kind == _KIND_CONST,
        arg[None, :],
        jnp.where(
            kind == _KIND_NUMBER,
            off_num[None, :] + num_start_by_slot,
            ex_off[None, :],
        ),
    ).astype(jnp.int32)
    if extras:
        ex_lens = jnp.stack([e[1] for e in extras], axis=1)  # [B, E]
        ex_len_by_slot = ex_lens[:, ex_idx]
    else:
        ex_len_by_slot = jnp.zeros((B, len(kind)), jnp.int32)
    seg_len = jnp.where(
        kind == _KIND_CONST,
        spec.const_len[None, :],
        jnp.where(kind == _KIND_NUMBER, num_len_by_slot, ex_len_by_slot),
    ).astype(jnp.int32)
    return ragged_concat(pool, seg_off, seg_len, spec.out_max)


# ---------------------------------------------------------------------------
# Fusion preimage layouts (formats pinned by interop/serial.py and the KATs)
# ---------------------------------------------------------------------------


def _poly_ntt_body(b: TemplateBuilder, params, degree: int) -> None:
    b.const(
        (
            f"PolynomialNTTRepresentation(modulus={params.modulus}, "
            f"degree={params.degree}, root={params.root}, "
            f"inv_root={params.inv_root}, root_order={params.root_order}, values=["
        ).encode()
    )
    b.numbers(degree)
    b.const(b"])")


def _vk_body(b: TemplateBuilder, params) -> None:
    """OneTimeVerificationKey repr: numbers are vk[0] ++ vk[1] (2*degree)."""
    b.const(b"OneTimeVerificationKey(left_vk_hat=")
    b.const(f"GeneralMatrix(elem_class={NTT_CLASS}, matrix=[[".encode())
    _poly_ntt_body(b, params, params.degree)
    b.const(b"]]), right_vk_hat=")
    b.const(f"GeneralMatrix(elem_class={NTT_CLASS}, matrix=[[".encode())
    _poly_ntt_body(b, params, params.degree)
    b.const(b"]]))")


def _challenge_body(b: TemplateBuilder, params) -> None:
    b.const(b"SignatureChallenge(c_hat=")
    _poly_ntt_body(b, params, params.degree)
    b.const(b")")


# width of str(prehashed message int): SHA3-256 digest as an integer, <= 78
# decimal digits (fusion.py:405-409)
PREHASH_W = 78


def challenge_preimage_spec(params) -> PreimageSpec:
    """dst + "," + str(vk) + "," + str(i) (fusion.py:412-419).

    values: vk[0] ++ vk[1] centered (2*degree); extra 0: prehash digits.
    """
    b = TemplateBuilder()
    b.const(bytes(params.sign_hash_dst) + b",")
    _vk_body(b, params)
    b.const(b",")
    b.extra(PREHASH_W)
    return b.build()


def triple_spec(params) -> PreimageSpec:
    """str((vk, i, challenge)) — one signer's entry in the aggregation XOF
    preimage (fusion.py:586-589).

    values: vk[0] ++ vk[1] ++ c_hat centered (3*degree); extra 0: prehash digits.
    """
    b = TemplateBuilder()
    b.const(b"(")
    _vk_body(b, params)
    b.const(b", ")
    b.extra(PREHASH_W)
    b.const(b", ")
    _challenge_body(b, params)
    b.const(b")")
    return b.build()


def agg_preimage_spec(params, n_signers: int, triple_width: int) -> PreimageSpec:
    """dst + "," + str(list(zip(...))) around N pre-assembled triple buffers
    (fusion.py:573-591)."""
    b = TemplateBuilder()
    b.const(bytes(params.agg_xof_dst) + b",[")
    for k in range(n_signers):
        if k:
            b.const(b", ")
        b.extra(triple_width)
    b.const(b"]")
    return b.build()


# ---------------------------------------------------------------------------
# Gather-free assembly (ops/ragged.Chunk recursive doubling)
# ---------------------------------------------------------------------------

from functools import lru_cache as _lru_cache

from ..ops.ragged import Chunk, fold_chunks, merge_cells, shift_left_bytes


_COMPILED: dict = {}


def _compile_spec(spec: PreimageSpec):
    """Memoized via id() (specs contain numpy arrays, so they are unhashable;
    the cache entry keeps the spec alive so the id stays valid)."""
    hit = _COMPILED.get(id(spec))
    if hit is not None and hit[0] is spec:
        return hit[1]
    nodes = _compile_spec_uncached(spec)
    _COMPILED[id(spec)] = (spec, nodes)
    return nodes


def _compile_spec_uncached(spec: PreimageSpec):
    """Group a spec's slots into fold nodes: const runs, uniform
    (sep + number) cell runs, and extra fields.

    Returns a tuple of node descriptors:
      ("const", bytes)
      ("cells", sep_bytes, first_number_index, count)
      ("extra", extra_index)
    Numbers inside one "cells" node are consecutive in the values tensor.
    """
    nodes = []
    pending = b""
    runs = []  # open cell run: [sep, i0, count]

    def flush_pending():
        nonlocal pending
        if pending:
            nodes.append(("const", pending))
            pending = b""

    def flush_run():
        if runs:
            nodes.append(("cells", runs[0], runs[1], runs[2]))
            runs.clear()

    # Runs only absorb short separators (the ", " between numbers): a long
    # const (poly-body headers, ~250 B) becomes its own node so the uniform
    # cell width stays tight and Pallas can emit it with scalar fills.
    MAX_SEP = 8

    for k in range(len(spec.kind)):
        kind, arg = int(spec.kind[k]), int(spec.arg[k])
        if kind == _KIND_CONST:
            cl = int(spec.const_len[k])
            pending += bytes(spec.template[arg : arg + cl].tobytes())
        elif kind == _KIND_NUMBER:
            if runs and runs[0] == pending and runs[1] + runs[2] == arg:
                runs[2] += 1
                pending = b""
            else:
                flush_run()
                if len(pending) > MAX_SEP:
                    flush_pending()
                sep, pending = pending, b""
                runs.extend([sep, arg, 1])
        else:  # extra
            flush_run()
            flush_pending()
            nodes.append(("extra", arg))
    flush_run()
    flush_pending()
    return tuple(nodes)


def _number_cells(sep: bytes, field, start, length, count: int) -> Chunk:
    """Left-aligned (sep ++ decimal) cells from render_decimal output slices.

    field uint8[B, count, DEC_W], start/length int32[B, count].
    """
    B = field.shape[0]
    aligned = shift_left_bytes(field, start, DEC_W - 1)
    pos = jnp.arange(DEC_W, dtype=jnp.int32)
    aligned = jnp.where(pos[None, None, :] < length[..., None], aligned, np.uint8(0))
    s = len(sep)
    if s:
        sep_b = jnp.broadcast_to(
            jnp.asarray(np.frombuffer(sep, dtype=np.uint8)), (B, count, s)
        )
        buf = jnp.concatenate([sep_b, aligned], axis=-1)
    else:
        buf = aligned
    return Chunk(buf=buf, length=length + np.int32(s), max_len=s + DEC_W, min_len=s + 1)


def assemble_chunks(
    spec: PreimageSpec,
    values=None,
    extras: Sequence[Tuple[jnp.ndarray, jnp.ndarray]] = (),
    extra_bounds: Optional[Sequence[Tuple[int, int]]] = None,
):
    """Gather-free twin of :func:`assemble` (same contract, same outputs)
    except that bytes at or beyond ``total`` are ZERO rather than scratch.

    extra_bounds: optional per-extra (min_len, max_len) static hints — tighter
    bounds shrink the barrel-shift depth of every merge to the right of the
    extra.  extras' buffers MUST be zero beyond their live length.
    """
    if len(extras) != spec.num_extras:
        raise ValueError(f"spec needs {spec.num_extras} extras, got {len(extras)}")
    nodes = _compile_spec(spec)
    if values is not None:
        B = values.shape[0]
        field, n_start, n_len = render_decimal(values)  # [B, K, DEC_W]
    else:
        B = extras[0][0].shape[0]
    out = []
    for node in nodes:
        if node[0] == "const":
            cb = np.frombuffer(node[1], dtype=np.uint8)
            out.append(
                Chunk(
                    buf=jnp.broadcast_to(jnp.asarray(cb), (B, len(cb))),
                    length=jnp.full((B,), len(cb), jnp.int32),
                    max_len=len(cb),
                    min_len=len(cb),
                )
            )
        elif node[0] == "cells":
            _, sep, i0, count = node
            cells = _number_cells(
                sep, field[:, i0 : i0 + count], n_start[:, i0 : i0 + count],
                n_len[:, i0 : i0 + count], count,
            )
            out.append(merge_cells(cells) if count > 1 else
                       Chunk(cells.buf[:, 0], cells.length[:, 0], cells.max_len, cells.min_len))
        else:
            e = node[1]
            eb, el = extras[e]
            w = spec.extra_widths[e]
            if eb.shape[1] != w:
                raise ValueError(f"extra width {eb.shape[1]} != spec width {w}")
            lo, hi = (0, w) if extra_bounds is None else extra_bounds[e]
            out.append(Chunk(buf=eb, length=el.astype(jnp.int32), max_len=hi, min_len=lo))
    final = fold_chunks(out)
    pad = spec.out_max - final.buf.shape[-1]
    buf = jnp.pad(final.buf, ((0, 0), (0, pad))) if pad > 0 else final.buf[:, : spec.out_max]
    return buf, final.length


# ---------------------------------------------------------------------------
# Word-carrier assembly (production path): uint32-packed strings, batch minor
# ---------------------------------------------------------------------------

from ..ops import ragged_words as rw  # noqa: E402


def assemble_chunks_words(
    spec: PreimageSpec,
    values=None,
    extras: Sequence[Tuple[jnp.ndarray, jnp.ndarray]] = (),
    extra_bounds: Optional[Sequence[Tuple[int, int]]] = None,
    pad_words: Optional[int] = None,
):
    """Packed-word twin of :func:`assemble_chunks_lm` (4 bytes per element).

    values int32[num_numbers, B]; extras (uint32[ceil(width/4), B], int32[B])
    pairs in ops/ragged_words layout with zeroed scratch.  Returns
    (buf uint32[ceil(out_max/4), B], total int32[B]) — ``buf`` feeds
    ops/keccak.shake256_absorb_words directly (same packing).
    """
    if len(extras) != spec.num_extras:
        raise ValueError(f"spec needs {spec.num_extras} extras, got {len(extras)}")
    if values is not None:
        if values.shape[0] != spec.num_numbers:
            raise ValueError(f"spec needs int32[{spec.num_numbers}, B] values")
        B = values.shape[-1]
    else:
        B = extras[0][0].shape[-1]
    final = rw.fold_chunks_w(_spec_word_nodes(spec, values, extras, extra_bounds, B))
    return _finish_chunk_w(final, spec.out_max, pad_words)


def _spec_word_nodes(spec: PreimageSpec, values, extras, extra_bounds, B: int):
    """Evaluate a spec's slot nodes to a list of WChunks (no final fold)."""
    nodes = _compile_spec(spec)
    out = []
    for node in nodes:
        if node[0] == "const":
            cb = rw.pack_const_words(node[1])
            out.append(
                rw.WChunk(
                    buf=jnp.broadcast_to(jnp.asarray(cb)[:, None], (len(cb), B)),
                    length=jnp.full((B,), len(node[1]), jnp.int32),
                    max_len=len(node[1]),
                    min_len=len(node[1]),
                )
            )
        elif node[0] == "cells":
            _, sep, i0, count = node
            cells = rw.render_decimal_cells_w(values[i0 : i0 + count], sep)
            out.append(
                rw.merge_cells_w(cells)
                if count > 1
                else rw.WChunk(cells.buf[0], cells.length[0], cells.max_len, cells.min_len)
            )
        else:
            e = node[1]
            eb, el = extras[e]
            w = spec.extra_widths[e]
            if eb.shape[0] != rw.words_for(w):
                raise ValueError(
                    f"extra word width {eb.shape[0]} != ceil(spec width {w} / 4)"
                )
            lo, hi = (0, w) if extra_bounds is None else extra_bounds[e]
            out.append(rw.WChunk(buf=eb, length=el.astype(jnp.int32), max_len=hi, min_len=lo))
    return out


def vk_body_spec(params) -> PreimageSpec:
    """str(vk) alone (fusion.py:328-329) — the shared subtree of the challenge
    preimage and the triple."""
    b = TemplateBuilder()
    _vk_body(b, params)
    return b.build()


def challenge_body_spec(params) -> PreimageSpec:
    """str(challenge) alone (fusion.py:382-383) — the triple's third field."""
    b = TemplateBuilder()
    _challenge_body(b, params)
    return b.build()


def _const_chunk_w(data: bytes, B: int) -> rw.WChunk:
    cb = rw.pack_const_words(data)
    return rw.WChunk(
        buf=jnp.broadcast_to(jnp.asarray(cb)[:, None], (len(cb), B)),
        length=jnp.full((B,), len(data), jnp.int32),
        max_len=len(data),
        min_len=len(data),
    )


def _finish_chunk_w(chunk: rw.WChunk, out_max: int, pad_words: Optional[int] = None):
    """Pad/trim a folded chunk to ``words_for(out_max)`` words — or directly
    to ``pad_words`` (e.g. the SHAKE rate multiple) to avoid a second
    whole-buffer pad copy in the consumer."""
    Ww = rw.words_for(out_max) if pad_words is None else pad_words
    pad = Ww - chunk.buf.shape[0]
    buf = jnp.pad(chunk.buf, ((0, pad), (0, 0))) if pad > 0 else chunk.buf[:Ww]
    return buf, chunk.length


def vk_chunk_w(params, vk2d_t) -> rw.WChunk:
    """The ``str(vk)`` body as one word chunk — the multi-KB subtree SHARED by
    the challenge preimage (fusion.py:412-419) and the triple (fusion.py:586-589).
    Assembling it once per signer (instead of once per consuming spec) removes
    the dominant duplicate cell-merge cost of the signer stage; WChunk merging
    is associative, so the downstream folds are byte-identical to the
    flat-spec evaluation (tests/test_ragged_words.py)."""
    B = vk2d_t.shape[-1]
    return rw.fold_chunks_w(
        _spec_word_nodes(vk_body_spec(params), vk2d_t, (), None, B)
    )


def fold_challenge_preimage_w(params, vk_chunk: rw.WChunk, pre_chunk: rw.WChunk,
                              pad_words: Optional[int] = None):
    """dst + "," + str(vk) + "," + str(i) from pre-built chunks -> (buf, total)."""
    B = vk_chunk.buf.shape[-1]
    ch_pre = rw.fold_chunks_w(
        [_const_chunk_w(bytes(params.sign_hash_dst) + b",", B), vk_chunk,
         _const_chunk_w(b",", B), pre_chunk]
    )
    return _finish_chunk_w(ch_pre, challenge_preimage_spec(params).out_max, pad_words)


def fold_triple_w(params, vk_chunk: rw.WChunk, pre_chunk: rw.WChunk, c_hat_t):
    """str((vk, i, challenge)) from the shared vk chunk -> (buf, total)."""
    B = vk_chunk.buf.shape[-1]
    ch_chunk = rw.fold_chunks_w(
        _spec_word_nodes(challenge_body_spec(params), c_hat_t, (), None, B)
    )
    tri = rw.fold_chunks_w(
        [_const_chunk_w(b"(", B), vk_chunk, _const_chunk_w(b", ", B), pre_chunk,
         _const_chunk_w(b", ", B), ch_chunk, _const_chunk_w(b")", B)]
    )
    return _finish_chunk_w(tri, triple_spec(params).out_max)


def number_terminators(spec: PreimageSpec) -> np.ndarray:
    """uint8[num_numbers]: the template byte that FOLLOWS each rendered
    number (',' between values, ']' after the last value of a poly body...).

    Used by the on-device repr sort (scheme/device_setup.vk_sort_ranks): two
    reprs of the same template compare lexicographically at the first
    differing rendered number, and when one rendering is a proper prefix of
    the other the following template byte decides — so the comparison key for
    a number is ``render(v) ++ terminator`` (templates contain no digits or
    '-' after a number slot, and renders contain no template bytes).
    """
    terms = np.zeros(spec.num_numbers, np.uint8)
    slots = list(zip(spec.kind, spec.arg, spec.const_len))
    for s, (k, a, _cl) in enumerate(slots):
        if k == _KIND_NUMBER:
            if s + 1 >= len(slots) or slots[s + 1][0] != _KIND_CONST:
                raise ValueError(
                    "number slot must be followed by template text for "
                    "terminator derivation"
                )
            terms[a] = spec.template[slots[s + 1][1]]
    return terms


def spec_min_total(spec: PreimageSpec, extra_min_lens: Sequence[int]) -> int:
    """Static lower bound on a spec's assembled length: every const byte, at
    least one digit per number, plus the given per-extra minimums."""
    return int(spec.const_len.sum()) + spec.num_numbers + sum(extra_min_lens)


# ---------------------------------------------------------------------------
# Lane-major assembly (production path): buffers uint8[W, B], batch minor
# ---------------------------------------------------------------------------

from ..ops.ragged import (  # noqa: E402
    fold_chunks_lm,
    merge_cells_lm,
    render_decimal_lm,
    shift_left_lm,
)


def _number_cells_lm(sep: bytes, field, start, length, count: int,
                     byte_dtype=jnp.uint8) -> Chunk:
    """Left-aligned (sep ++ decimal) cells, lane-major.

    field uint8[K, DEC_W, B], start/length int32[K, B] -> Chunk[K, s+DEC_W, B].
    Separator bytes enter as scalar fills (one [K, 1, B] splat per byte) so
    the same code traces inside Pallas kernels, where captured array constants
    and sublane+lane broadcasts are unsupported.
    """
    bd = jnp.dtype(byte_dtype)
    B = field.shape[-1]
    aligned = shift_left_lm(field, start, DEC_W - 1)
    pos = jnp.arange(DEC_W, dtype=jnp.int32)
    aligned = jnp.where(pos[None, :, None] < length[:, None, :], aligned, jnp.asarray(0, bd))
    s = len(sep)
    if s:
        sep_cols = [jnp.full((count, 1, B), c, dtype=bd) for c in sep]
        buf = jnp.concatenate(sep_cols + [aligned], axis=1)
    else:
        buf = aligned
    return Chunk(buf=buf, length=length + np.int32(s), max_len=s + DEC_W, min_len=s + 1)


def assemble_chunks_lm(
    spec: PreimageSpec,
    values=None,
    extras: Sequence[Tuple[jnp.ndarray, jnp.ndarray]] = (),
    extra_bounds: Optional[Sequence[Tuple[int, int]]] = None,
):
    """Lane-major :func:`assemble_chunks`.

    values int32[num_numbers, B]; extras (uint8[width, B], int32[B]) pairs with
    zeroed scratch.  Returns (buf uint8[out_max, B], total int32[B]).
    """
    if len(extras) != spec.num_extras:
        raise ValueError(f"spec needs {spec.num_extras} extras, got {len(extras)}")
    nodes = _compile_spec(spec)
    if values is not None:
        if values.shape[0] != spec.num_numbers:
            raise ValueError(f"spec needs int32[{spec.num_numbers}, B] values")
        B = values.shape[-1]
        field, n_start, n_len = render_decimal_lm(values)  # [K, DEC_W, B]
    else:
        B = extras[0][0].shape[-1]
    out = []
    for node in nodes:
        if node[0] == "const":
            cb = np.frombuffer(node[1], dtype=np.uint8)
            out.append(
                Chunk(
                    buf=jnp.broadcast_to(jnp.asarray(cb)[:, None], (len(cb), B)),
                    length=jnp.full((B,), len(cb), jnp.int32),
                    max_len=len(cb),
                    min_len=len(cb),
                )
            )
        elif node[0] == "cells":
            _, sep, i0, count = node
            cells = _number_cells_lm(
                sep, field[i0 : i0 + count], n_start[i0 : i0 + count],
                n_len[i0 : i0 + count], count,
            )
            out.append(merge_cells_lm(cells) if count > 1 else
                       Chunk(cells.buf[0], cells.length[0], cells.max_len, cells.min_len))
        else:
            e = node[1]
            eb, el = extras[e]
            w = spec.extra_widths[e]
            if eb.shape[0] != w:
                raise ValueError(f"extra width {eb.shape[0]} != spec width {w}")
            lo, hi = (0, w) if extra_bounds is None else extra_bounds[e]
            out.append(Chunk(buf=eb, length=el.astype(jnp.int32), max_len=hi, min_len=lo))
    final = fold_chunks_lm(out)
    pad = spec.out_max - final.buf.shape[0]
    buf = jnp.pad(final.buf, ((0, pad), (0, 0))) if pad > 0 else final.buf[: spec.out_max]
    return buf, final.length
