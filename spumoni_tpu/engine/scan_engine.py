"""Batched lockstep MS/PML query kernels (jax.lax.scan).

This is the device re-design of the reference hot loops
(its src/compute_ms_pml.cpp:237-286 PML, :570-623 MS pointers,
:802-810 MS extension): instead of one sequential pointer-chasing loop per
read on a wavelet tree, thousands of reads advance in lockstep, one
backward-step per scan iteration, with rank/select realized as a branchless
binary search over per-character run tables (gathers into dense device
arrays).

Reads are reversed and left-aligned into a [B, L] u8 matrix; step i processes
pattern[m-1-i] for every lane. Lanes whose read is shorter than L process
padding (char 0, which no index contains) — their tail outputs are sliced off
on the host.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from .arrays import IndexArrays, IndexMeta
from ..utils import encode_rows, present_chars

_IDENT_AMAP = np.arange(256, dtype=np.uint8)  # raw-byte staging (no host)
_AMAP2_ACGT = np.full(256, 255, dtype=np.uint8)  # 2-bit codes; 255 = exc
for _i, _b in enumerate(b"ACGT"):
    _AMAP2_ACGT[_b] = _i


def _bsearch_le(c_start, lo0, hi0, pos, iters, r):
    """Last index k in [lo0, hi0) with c_start[k] <= pos, else lo0-1.

    Branchless fixed-trip binary search, vectorized over the batch.
    """
    lo, hi = lo0, hi0
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = c_start[jnp.clip(mid, 0, r - 1)]
        le = v <= pos
        lo = jnp.where(active & le, mid + 1, lo)
        hi = jnp.where(active & ~le, mid, hi)
    return lo - 1


def make_step_fn(meta: IndexMeta, mode: str, use_doc: bool, r: int):
    """One backward step of the recurrence for a [B] batch.

    carry = (pos, length, sample, doc); emits per-lane (length | sample[, doc]).
    """
    ms = mode == "ms"

    def step(ix: IndexArrays, carry, chars):
        pos, length, sample, doc = carry
        c = chars.astype(pos.dtype)
        lo0 = ix.char_off[c]
        hi0 = ix.char_off[c + 1]
        k = _bsearch_le(ix.c_start, lo0, hi0, pos, meta.bsearch_iters, r)
        kc = jnp.clip(k, 0, r - 1)
        k1c = jnp.clip(k + 1, 0, r - 1)

        start_k = ix.c_start[kc]
        len_k = ix.c_len[kc]
        valid_k = k >= lo0
        is_match = valid_k & (pos < start_k + len_k)
        rnk = jnp.where(valid_k,
                        ix.c_cum[kc] + jnp.minimum(pos - start_k, len_k),
                        0)
        has_next = (k + 1) < hi0
        thr = ix.c_thr[k1c]
        jump_down = (~is_match) & has_next & (pos >= thr)
        empty = ix.cnt[c] == 0

        new_length = jnp.where(is_match, length + 1, 0)
        Fc = ix.F[c]
        new_pos = jnp.where(empty, Fc,
                  jnp.where(is_match | jump_down, Fc + rnk, Fc + rnk - 1))

        if ms:
            new_sample = jnp.where(empty, 0,
                         jnp.where(is_match, sample - 1,
                         jnp.where(jump_down, ix.c_ssamp[k1c], ix.c_esamp[kc])))
        else:
            new_sample = sample
        if use_doc:
            jumped = jnp.where(jump_down, ix.c_sdoc[k1c], ix.c_edoc[kc])
            if ms:
                # compute_ms_pml.cpp:639-643: empty char resets to run 0's doc
                new_doc = jnp.where(empty, ix.first_run_sdoc,
                          jnp.where(is_match, doc, jumped))
            else:
                # compute_ms_pml.cpp:288-340: empty char keeps the current doc
                new_doc = jnp.where(empty | is_match, doc, jumped)
        else:
            new_doc = doc

        emit = (new_sample if ms else new_length, new_doc)
        return (new_pos, new_length, new_sample, new_doc), emit

    return step


def initial_state(ix, B: int):
    """Recurrence seed: empty pattern at the last BWT row
    (compute_ms_pml.cpp:243-244,574-575)."""
    dt = (ix.fields if hasattr(ix, "fields")
          else ix.n if hasattr(ix, "bblocks")   # wide v4: int64 pos, i32 rows
          else ix.c_start).dtype
    return (jnp.full((B,), ix.n - 1, dtype=dt),
            jnp.zeros((B,), dtype=dt),
            jnp.full((B,), ix.last_run_sample, dtype=dt),
            jnp.full((B,), ix.last_run_edoc, dtype=dt))


@functools.partial(jax.jit, static_argnames=("meta", "mode", "use_doc"))
def query_batch_kernel_v2(ix, reads_rev: jnp.ndarray, meta, mode: str,
                          use_doc: bool, ctab=None, state=None):
    """Layered-search variant (engine v2, see layered.py).

    With `ctab` (a reduced-alphabet per-char table), reads_rev must be
    rank-mapped on the host; otherwise it holds raw bytes.

    `state` carries the (pos, length, sample, doc) recurrence state across
    chunk boundaries for long reads (SURVEY.md §5 long-context: the per-step
    state is O(1) words per lane, so a read of any length is processed as
    sequential chunked kernel invocations). Returns (vals, docs, state)."""
    from .layered import make_layered_step_fn

    B = reads_rev.shape[0]
    step = make_layered_step_fn(meta, mode, use_doc)
    if state is None:
        state = initial_state(ix, B)

    xs = reads_rev.T
    state, (vals, docs) = jax.lax.scan(
        lambda carry, ch: step(ix, carry, ch, ctab), state, xs)
    return vals.T, (docs.T if use_doc else None), state


@functools.partial(jax.jit, static_argnames=("meta",))
def query_batch_kernel_v4(ix, reads_rev: jnp.ndarray, meta, ctab,
                          state=None):
    """Block-bits variant (engine v4, see blockbits.py): PML only, one slim
    row gather per step, no emit lag. reads_rev must be QUERY-rank mapped
    (OccHost.rank_map). Returns (vals, state)."""
    from .blockbits import make_blockbits_step_fn

    B = reads_rev.shape[0]
    step = make_blockbits_step_fn(meta, "pml", False)
    if state is None:
        state = initial_state(ix, B)
    state, (vals, _) = jax.lax.scan(
        lambda carry, ch: step(ix, carry, ch, ctab), state, reads_rev.T)
    return vals.T, state


def _take_flat_rows(table, idx2d, sub=None):
    """values = table[idx2d] (- sub), with the 1-D table viewed as
    [m, 128] rows: a scan over the read axis gathers one [B, 128] row per
    step and one-hot-selects the element, which beat the plain 1-D element
    gather on the earlier target (scripts/exp_gather_grid_r5.py measures
    the gather costs). Requires len(table) % 128 == 0 (the assembler pads
    the jump tables)."""
    t2 = table.reshape(-1, 128)
    lane = jnp.arange(128, dtype=jnp.int32)[None, :]

    def body(c, xs):
        j, s = xs
        row = t2[j >> 7]
        v = jnp.sum(jnp.where(lane == (j & 127)[:, None], row, 0),
                    axis=1, dtype=table.dtype)
        return c, v - s.astype(table.dtype)

    sub_t = (jnp.zeros_like(idx2d) if sub is None else sub).T
    _, out = jax.lax.scan(body, 0, (idx2d.T, sub_t))
    return out.T


@functools.partial(jax.jit, static_argnames=("meta", "mode", "use_doc"))
def query_batch_kernel_v4ms(ix, reads_rev: jnp.ndarray, meta, mode: str,
                            use_doc: bool, ctab, state=None):
    """Block-bits MS / doc variant (engine v4-MS, blockbits.py): the scan
    carries (jump id, decrements) instead of SA-sample VALUES, so each step
    still costs one dependent row gather (+ one independent msrow gather
    that pipelines with it); the [B, L] sample/doc matrices are then
    reconstructed from the flat jump tables with independent gathers.
    reads_rev must be QUERY-rank mapped. Returns (vals, docs, state)."""
    from .blockbits import make_blockbits_ms_step_fn, ms_initial_state

    B = reads_rev.shape[0]
    step = make_blockbits_ms_step_fn(meta, mode, use_doc)
    if state is None:
        state = ms_initial_state(ix, meta, B, mode)
    state, (a_mat, b_mat) = jax.lax.scan(
        lambda carry, ch: step(ix, carry, ch, ctab), state, reads_rev.T)
    if mode == "ms":
        jidx, d = a_mat.T, b_mat.T
        if ix.jump_t.shape[0] % 128 == 0:
            vals = _take_flat_rows(ix.jump_t, jidx, d)
        else:  # unpadded table (older assembly): 1-D element gather
            vals = ix.jump_t[jidx] - d.astype(ix.jump_t.dtype)
    else:
        vals, jidx = a_mat.T, b_mat.T
    if use_doc:
        if ix.jump_d.shape[0] % 128 == 0:
            docs = _take_flat_rows(ix.jump_d, jidx).astype(vals.dtype)
        else:
            docs = ix.jump_d[jidx].astype(vals.dtype)
    else:
        docs = None
    return vals, docs, state


@functools.partial(
    jax.jit, static_argnames=("meta", "mode", "use_doc", "finalize"))
def query_batch_kernel_v3(ix, reads_rev: jnp.ndarray, meta, mode: str,
                          use_doc: bool, ctab, state=None,
                          finalize: bool = True):
    """Occ-block variant (engine v3, see occblock.py). reads_rev must be
    QUERY-rank mapped (OccHost.rank_map).

    MS samples and doc ids resolve one iteration LATE (the jump decision is
    deferred into the next step's single gather). With finalize=True the
    kernel appends one sentinel iteration and realigns internally; with
    finalize=False it returns RAW emits (iteration i carries step i-1's
    sample/doc) plus the carry state — the chunked long-read path stitches
    and realigns on the host. Returns (vals, docs, state)."""
    from .occblock import make_occ_step_fn, occ_initial_state

    B, L = reads_rev.shape
    step = make_occ_step_fn(meta, mode, use_doc)
    if state is None:
        state = occ_initial_state(ix, B)
    xs = reads_rev.T
    lag = (mode == "ms") or use_doc
    if finalize and lag:
        xs = jnp.concatenate([xs, jnp.zeros((1, B), xs.dtype)])
    state, (vals, docs) = jax.lax.scan(
        lambda carry, ch: step(ix, carry, ch, ctab), state, xs)
    if finalize and lag:
        vals = vals[1:] if mode == "ms" else vals[:L]
        docs = docs[1:] if use_doc else docs
    return vals.T, (docs.T if use_doc else None), state


@functools.partial(jax.jit, static_argnames=("meta", "mode", "use_doc", "r"))
def query_batch_kernel(ix: IndexArrays, reads_rev: jnp.ndarray,
                       meta: IndexMeta, mode: str, use_doc: bool, r: int):
    """reads_rev: [B, L] u8, reversed reads, left-aligned, zero-padded.

    Returns (values [B, L], docs [B, L] | None) where values are PML lengths
    (mode='pml') or MS pointers (mode='ms'), still in reversed order.
    """
    B = reads_rev.shape[0]
    dt = ix.c_start.dtype
    step = make_step_fn(meta, mode, use_doc, r)

    pos0 = jnp.full((B,), ix.n - 1, dtype=dt)
    len0 = jnp.zeros((B,), dtype=dt)
    samp0 = jnp.full((B,), ix.last_run_sample, dtype=dt)
    doc0 = jnp.full((B,), ix.last_run_edoc, dtype=dt)

    xs = reads_rev.T  # [L, B]
    (_, _, _, _), (vals, docs) = jax.lax.scan(
        lambda carry, ch: step(ix, carry, ch), (pos0, len0, samp0, doc0), xs)
    vals = vals.T  # [B, L]
    docs = docs.T if use_doc else None
    return vals, docs


def build_text_words(text: jnp.ndarray, nt: int) -> jnp.ndarray:
    """[ceil(nt/64), 17] uint64 rows: row g holds text words 8g..8g+16, so
    ANY 64-byte window starting at byte t lives in row t>>6 at word offsets
    ((t>>3)&7) .. ((t>>3)&7)+8 — ONE row gather yields a full 64-byte
    aligned comparison window."""
    rows = -(-int(nt) // 64)
    pad = rows * 64 + 136 - int(text.shape[0])
    t = jnp.concatenate([text, jnp.zeros((pad,), jnp.uint8)])
    words = jax.lax.bitcast_convert_type(t.reshape(-1, 8), jnp.uint64)
    return _rows17(words, rows)


def _rows17(words: jnp.ndarray, rows: int) -> jnp.ndarray:
    """[rows, 17] overlapping-word rows from a flat u64 word vector
    (len >= rows*8 + 17): row g = words[8g .. 8g+16]."""
    main = words[:rows * 8].reshape(rows, 8)
    second = words[8:rows * 8 + 8].reshape(rows, 8)
    last = words[16::8][:rows]
    return jnp.concatenate([main, second, last[:, None]], axis=1)


def _rows_overlap(words: jnp.ndarray, rows: int, stride_w: int,
                  width_w: int) -> jnp.ndarray:
    """[rows, width_w] overlapping u64 rows at stride_w words: row g =
    words[stride_w*g .. stride_w*g + width_w - 1]. Caller pads `words` to
    >= stride_w*(rows-1) + width_w entries."""
    parts = []
    o = 0
    while o + stride_w <= width_w:
        parts.append(words[o:o + rows * stride_w].reshape(rows, stride_w))
        o += stride_w
    for j in range(width_w - o):
        parts.append(words[o + j::stride_w][:rows, None])
    return jnp.concatenate(parts, axis=1)


def build_text_wide(text: jnp.ndarray, nt: int, W: int = 256) -> jnp.ndarray:
    """[ceil(nt/W), W/4+1] u64 rows at W-byte stride: row g holds bytes
    Wg .. Wg+2W+7, so any W-byte window starting in block g is one row
    gather + butterfly away. Used for the wide phase of the MS extension
    (long post-jump tails on repetitive references)."""
    rows = -(-int(nt) // W)
    stride_w, width_w = W // 8, W // 4 + 1
    pad = (stride_w * (rows - 1) + width_w) * 8 - int(text.shape[0])
    t = jnp.concatenate([text, jnp.zeros((max(pad, 0),), jnp.uint8)])
    words = jax.lax.bitcast_convert_type(
        t[:(t.shape[0] // 8) * 8].reshape(-1, 8), jnp.uint64)
    return _rows_overlap(words, rows, stride_w, width_w)


def _window_bytes(rowtab, bytepos, W, dt):
    """[B, W/8] u64 = W little-endian bytes starting at `bytepos`, from a
    build_text_wide-style table: one row gather + a log2(W)-step byte
    butterfly."""
    shift = W.bit_length() - 1
    row = rowtab[jnp.clip(bytepos >> shift, 0, rowtab.shape[0] - 1)]
    b = jax.lax.bitcast_convert_type(row, jnp.uint8)
    b = b.reshape(b.shape[0], (W // 4 + 1) * 8)
    off = bytepos & (W - 1)
    s = W // 2
    while s:
        take = ((off & s) != 0)[:, None]
        b = jnp.where(take, b[:, s:], b[:, :b.shape[1] - s])
        s //= 2
    return jax.lax.bitcast_convert_type(
        b[:, :W].reshape(b.shape[0], W // 8, 8), jnp.uint64)


def _aligned_u64x8(rowtab, bytepos, dt):
    """[B, 8] aligned u64 words = 64 little-endian bytes starting at
    `bytepos`, via one row gather into a [rows, 17] table + a BYTE-LEVEL
    BUTTERFLY shifter: 6 predicated two-way selects on a u8 view replace
    the 17x9 one-hot word select + per-lane variable u64 shifts (u64
    shifts by a per-lane amount are costly where the vector unit is
    32-bit)."""
    row = rowtab[jnp.clip(bytepos >> 6, 0, rowtab.shape[0] - 1)]  # [B, 17]
    b = jax.lax.bitcast_convert_type(row, jnp.uint8)
    b = b.reshape(b.shape[0], 136)
    off = bytepos & 63
    for s in (32, 16, 8, 4, 2, 1):
        take = ((off & s) != 0)[:, None]
        b = jnp.where(take, b[:, s:], b[:, :b.shape[1] - s])
    return jax.lax.bitcast_convert_type(
        b[:, :64].reshape(b.shape[0], 8, 8), jnp.uint64)          # [B, 8]


def _match_bytes(t64, r64, dt):
    """Leading equal LE bytes of two u64 windows (8 when identical)."""
    x = t64 ^ r64
    tz = jax.lax.population_count((x & (jnp.uint64(0) - x)) - jnp.uint64(1))
    return (tz.astype(dt) >> 3)


def _match64(ta, ra, dt):
    """Leading equal bytes of two [B, 8]-word (64-byte) windows."""
    mb = _match_bytes(ta, ra, dt)                                 # [B, 8]
    k = mb[:, 7]
    for j in range(6, -1, -1):
        k = mb[:, j] + jnp.where(mb[:, j] == 8, k, 0)
    return k                                                      # 0..64


def _matchW(ta, ra, dt):
    """Leading equal bytes of two [B, K]-u64-word windows (K*8 when
    identical): k = sum_j mb_j * prod_{i<j}[word i fully equal], with the
    prefix product in log2(K) doubling steps."""
    mb = _match_bytes(ta, ra, dt)                                 # [B, K]
    K = mb.shape[1]
    pf = (mb == 8).astype(dt)
    sh = 1
    while sh < K:
        pf = pf * jnp.pad(pf, ((0, 0), (sh, 0)), constant_values=1)[:, :-sh]
        sh *= 2
    pe = jnp.pad(pf, ((0, 0), (1, 0)), constant_values=1)[:, :-1]
    return (mb * pe).sum(axis=1, dtype=dt)


@functools.partial(jax.jit, static_argnames=("nt", "chunk_lanes"))
def extend_pointers_diag(text_words: jnp.ndarray, reads: jnp.ndarray,
                         read_lens: jnp.ndarray, ptrs: jnp.ndarray, nt: int,
                         chunk_lanes: int = 16384, text_wide=None):
    """MS extension v2: pointers -> lengths via DIAGONAL-RUN structure.

    Consecutive MS pointers (ptr[i+1] == ptr[i] + 1, ptr[i] >= 1) imply
    l_i = 1 + l_{i+1} exactly: the jump/extension that produced ptr[i]
    lands ON an occurrence of read[i] (text[ptr_i] == read[i]), and the
    remaining comparison windows coincide. So only the END of each maximal
    pointer-diagonal needs a brute LCP(text[ptr_e:], read[e:]) — and every
    interior position fills as (e - i) + l_e. This removes the
    per-character while_loop of the old kernel (2L iterations x 4 per-lane
    gathers each) in favor of

      1. one flat brute pass over all positions (only diagonal ends
         active), comparing 64 BYTES per step via aligned u64 windows from
         [rows, 17]-word tables — one text row gather + one row gather
         into a PER-CHUNK read-word table (dynamic-sliced, so it stays
         far below the gather row-count cliff); a chunk exits as soon
         as its ends resolve — then
      2. a vectorized reverse-cummin fill.

    64-byte steps matter on repetitive references: a jump can land on
    another strain's copy, so post-jump LCPs reach hundreds of bases. Each
    iteration is latency-bound rather than lane-bound, so with `text_wide`
    (build_text_wide) the loop ESCALATES: after two 64-byte steps the
    surviving long tails switch to 256-byte compare windows, cutting the
    sequential iteration count on strain-jump tails ~4x.

    Replaces the reference's SLP extension loop (compute_ms_pml.cpp:802-810)
    semantics exactly for reads whose pointers are all >= 1; reads with
    reset/underflow pointers take ScanEngine's sequential-carry fallback.
    """
    B, L = reads.shape
    dt = ptrs.dtype
    iota = jnp.arange(L, dtype=dt)[None, :]

    # diagonal ends: last in-read position, broken adjacency, or a pointer
    # <= 0 (reset artifacts carry no first-char guarantee — brute them)
    nxt = jnp.concatenate([ptrs[:, 1:], jnp.full((B, 1), -(1 << 30), dt)],
                          axis=1)
    in_read = iota < read_lens[:, None]
    ends = ((iota >= read_lens[:, None] - 1) | (nxt != ptrs + 1)
            | (ptrs <= 0)) & in_read

    BL = B * L
    CH = chunk_lanes
    while BL % CH:
        CH //= 2
    nch = BL // CH
    # flat read bytes as u64 words, padded so every chunk's local window
    # table (chunk bytes + max extension + row overlap) is in range
    ROWS = (CH + L) // 64 + 3
    ROWS_W = (CH + L) // 256 + 2
    WS_WORDS = max(ROWS * 8 + 17, (ROWS_W - 1) * 32 + 65)
    gpad = WS_WORDS * 8
    rflat = jnp.concatenate(
        [reads.reshape(-1), jnp.zeros((gpad,), jnp.uint8)])
    gwords = jax.lax.bitcast_convert_type(
        rflat[:(rflat.shape[0] // 8) * 8].reshape(-1, 8), jnp.uint64)

    flat_ptr = ptrs.reshape(-1)
    flat_act = (ends & (ptrs >= 0)).reshape(-1)

    def chunk_body(carry, xs):
        fp, fa, base = xs
        rpos0 = base * CH + jnp.arange(CH, dtype=dt)
        # read-end byte limit for each lane's read
        rrow = rpos0 // L
        limit = rrow * L + read_lens[jnp.clip(rrow, 0, B - 1)]
        # per-chunk read-word table: ~ (CH+L)/64 rows, far under the cliff
        ws = jax.lax.dynamic_slice(
            gwords, ((base * CH // 8).astype(jnp.int32),), (WS_WORDS,))
        rtab = _rows17(ws, ROWS)

        def body64(st):
            l, act = st
            tpos = fp + l
            rpos = rpos0 + l
            kmax = jnp.minimum(jnp.minimum(limit - rpos, nt - tpos),
                               64).astype(dt)
            ta = _aligned_u64x8(text_words, tpos, dt)
            ra = _aligned_u64x8(rtab, rpos - base * CH, dt)
            mb = _match64(ta, ra, dt)
            k = jnp.clip(jnp.minimum(mb, kmax), 0, 64)
            l = l + jnp.where(act, k, 0)
            act = act & (k == 64)
            return l, act

        l0 = jnp.zeros((CH,), dt)
        if text_wide is None:
            l, _ = jax.lax.while_loop(lambda st: jnp.any(st[1]), body64,
                                      (l0, fa))
            return carry, l

        # phase 1: at most two 64 B steps (resolves the short-LCP bulk)
        def cond1(st):
            l, act, t = st
            return jnp.any(act) & (t < 2)

        l, act, _ = jax.lax.while_loop(
            cond1, lambda st: (*body64(st[:2]), st[2] + 1),
            (l0, fa, jnp.int32(0)))

        # phase 2: survivors are long tails — 256 B compare windows
        rtab_w = _rows_overlap(ws, ROWS_W, 32, 65)

        def body256(st):
            l, act = st
            tpos = fp + l
            rpos = rpos0 + l
            kmax = jnp.minimum(jnp.minimum(limit - rpos, nt - tpos),
                               256).astype(dt)
            ta = _window_bytes(text_wide, tpos, 256, dt)
            ra = _window_bytes(rtab_w, rpos - base * CH, 256, dt)
            mb = _matchW(ta, ra, dt)
            k = jnp.clip(jnp.minimum(mb, kmax), 0, 256)
            l = l + jnp.where(act, k, 0)
            act = act & (k == 256)
            return l, act

        l, _ = jax.lax.while_loop(lambda st: jnp.any(st[1]), body256,
                                  (l, act))
        return carry, l

    _, l_flat = jax.lax.scan(
        chunk_body, 0,
        (flat_ptr.reshape(nch, CH), flat_act.reshape(nch, CH),
         jnp.arange(nch, dtype=dt)))
    l_brute = l_flat.reshape(B, L)

    # fill: l_i = (e(i) - i) + l_e for the nearest end e(i) >= i
    e_idx = jax.lax.cummin(jnp.where(ends, iota, L + L), axis=1,
                           reverse=True)
    e_c = jnp.clip(e_idx, 0, L - 1).astype(jnp.int32)
    l_e = jnp.take_along_axis(l_brute, e_c, axis=1)
    out = (e_idx - iota).astype(dt) + l_e
    out = jnp.where((ptrs >= 0) & in_read & (e_idx < L + L), out, 0)
    return out


def build_text_rows512(text: jnp.ndarray, nt: int) -> jnp.ndarray:
    """[ceil(nt/512)+1, 128] u32 NON-overlapping rows — the text itself,
    with a 128-word minor dimension (a device that tiles arrays in
    (8, 128) blocks would pad a narrow [*, 8]-u64 layout 16x). Any 64-byte
    window spans at most rows g and g+1, so a window costs TWO independent
    row gathers + a word-level butterfly, vs build_text_words' one gather
    into an overlapped 17-word table that holds 2.125x the text bytes. The
    memory-exact choice for genome-scale MS."""
    rows = -(-int(nt) // 512) + 1
    pad = rows * 512 - int(text.shape[0])
    t = jnp.concatenate([text, jnp.zeros((pad,), jnp.uint8)])
    return jax.lax.bitcast_convert_type(t.reshape(rows, 128, 4), jnp.uint32)


def _window_rows512(text512, bytepos, W: int, tp_axis=None):
    """[B, W] u8 window (W <= 512) starting at `bytepos` from a
    build_text_rows512 table: two independent row gathers, a WORD-level
    butterfly (7 predicated selects on [B, 256] u32 — 4x less traffic than
    byte-level), then a 2-step byte butterfly for the residual offset.
    One tile-exact table serves BOTH the 64 B bulk pass and the 256 B
    long-tail windows (a W<=512 window spans at most rows g, g+1).

    tp_axis: text512 is ROW-SHARDED over that mesh axis (the sharded-index
    MS path, parallel/tp.py): the owner shard gathers each row
    locally, the rest contribute zeros, and ONE [B, 256] psum per window
    reassembles both rows on every shard."""
    if tp_axis is not None:
        rl = text512.shape[0]                           # local shard rows
        S = jax.lax.psum(1, tp_axis)
        tpi = jax.lax.axis_index(tp_axis).astype(jnp.int32)
        rows = rl * S
        g = jnp.clip((bytepos >> 9).astype(jnp.int32), 0, rows - 1)

        def _local(gg):
            loc = gg - tpi * rl
            mine = (loc >= 0) & (loc < rl)
            return jnp.where(mine[:, None],
                             text512[jnp.clip(loc, 0, rl - 1)], 0)

        w = jax.lax.psum(jnp.concatenate(
            [_local(g), _local(jnp.clip(g + 1, 0, rows - 1))], axis=1),
            tp_axis)                                    # [B, 256] u32
    else:
        rows = text512.shape[0]
        g = jnp.clip((bytepos >> 9).astype(jnp.int32), 0, rows - 1)
        r0 = text512[g]
        r1 = text512[jnp.clip(g + 1, 0, rows - 1)]
        w = jnp.concatenate([r0, r1], axis=1)           # [B, 256] u32
    off = (bytepos & 511).astype(jnp.int32)
    woff = off >> 2
    for s in (64, 32, 16, 8, 4, 2, 1):
        take = ((woff & s) != 0)[:, None]
        w = jnp.where(take, w[:, s:], w[:, :w.shape[1] - s])
    nw = W // 4 + 1
    b = jax.lax.bitcast_convert_type(w[:, :nw], jnp.uint8)
    b = b.reshape(b.shape[0], 4 * nw)
    rem = off & 3
    for s in (2, 1):
        take = ((rem & s) != 0)[:, None]
        b = jnp.where(take, b[:, s:], b[:, :b.shape[1] - s])
    return b[:, :W]


def _aligned_bytes64(rowtab, bytepos):
    """[B, 64] u8 window starting at `bytepos` from a [rows, 17]-u64 table:
    one row gather + the byte-level butterfly (as _aligned_u64x8, but stays
    in bytes — the consumer compares bytes directly)."""
    row = rowtab[jnp.clip(bytepos >> 6, 0, rowtab.shape[0] - 1)]  # [B, 17]
    b = jax.lax.bitcast_convert_type(row, jnp.uint8)
    b = b.reshape(b.shape[0], 136)
    off = (bytepos & 63).astype(jnp.int32)
    for s in (32, 16, 8, 4, 2, 1):
        take = ((off & s) != 0)[:, None]
        b = jnp.where(take, b[:, s:], b[:, :b.shape[1] - s])
    return b[:, :64]


def _window_bytes_u8(rowtab, bytepos, W):
    """[B, W] u8 window starting at `bytepos` from a build_text_wide-style
    table (byte-level variant of _window_bytes)."""
    shift = W.bit_length() - 1
    row = rowtab[jnp.clip(bytepos >> shift, 0, rowtab.shape[0] - 1)]
    b = jax.lax.bitcast_convert_type(row, jnp.uint8)
    b = b.reshape(b.shape[0], (W // 4 + 1) * 8)
    off = (bytepos & (W - 1)).astype(jnp.int32)
    s = W // 2
    while s:
        take = ((off & s) != 0)[:, None]
        b = jnp.where(take, b[:, s:], b[:, :b.shape[1] - s])
        s //= 2
    return b[:, :W]


def _lcp_bytes(tb, rb):
    """Leading equal bytes of two [B, W] u8 windows (W when identical):
    one compare + one masked-iota min — no u64 xor/popcount/fold."""
    W = tb.shape[1]
    iw = jnp.arange(W, dtype=jnp.int32)[None, :]
    return jnp.min(jnp.where(tb != rb, iw, W), axis=1)


@functools.partial(
    jax.jit, static_argnames=("nt", "chunk_positions", "K", "tail_chunk",
                              "text_two_gather", "tp_axis",
                              "bulk_one_gather"))
def extend_pointers_sweep(text_words: jnp.ndarray, reads: jnp.ndarray,
                          read_lens: jnp.ndarray, ptrs: jnp.ndarray, nt: int,
                          text_wide, chunk_positions: int = 131072,
                          K: int = 4, tail_chunk: int = 16384,
                          text_two_gather: bool = False, tp_axis=None,
                          bulk_one_gather: bool = True):
    """MS extension v4: BULK SINGLE PASS + compacted long tails.

    The chunked-while kernels (extend_pointers_diag/diag2) pay one
    latency-bound compare iteration per (chunk, step) even though
    only ~8-50% of flat positions are diagonal ends and ~95% of those ends
    resolve within the FIRST 64-byte window (LCP < 64 — at sequencing error
    rates the post-jump match is short). This kernel restructures around
    that distribution:

      A. one sweep over all B*L flat positions in large chunks (no while):
         a single 64-byte byte-compare per diagonal end — resolves the
         short-LCP bulk at full lane occupancy, 2 row gathers + a byte
         butterfly + a masked-iota min per position;
      B. the few survivors (LCP >= 64: strain-jump tails, ~O(1) per
         positive read) are extracted per read (top-K first-column passes,
         repeated under a while_loop until none remain) into dense [B, K]
         lanes and extended with 256-byte windows against GLOBAL
         overlapped text/read tables — over the gather row-count cliff,
         but at tail lane counts that costs microseconds;
      C. the arithmetic diagonal fill (reverse cummin), as in v2.

    Exactness matches extend_pointers_diag (same precondition: pointers
    >= 1; reset/underflow reads take the sequential-carry fallback), which
    itself matches the reference's SLP extension loop semantics
    (compute_ms_pml.cpp:802-810) with the HBM text replacing the SLP.
    """
    assert tp_axis is None or text_two_gather, \
        "TP extension shards the rows512 table (text_two_gather required)"
    B, L = reads.shape
    dt = ptrs.dtype
    i32 = jnp.int32
    iota = jnp.arange(L, dtype=dt)[None, :]

    nxt = jnp.concatenate([ptrs[:, 1:], jnp.full((B, 1), -(1 << 30), dt)],
                          axis=1)
    in_read = iota < read_lens[:, None]
    ends = ((iota >= read_lens[:, None] - 1) | (nxt != ptrs + 1)
            | (ptrs <= 0)) & in_read

    BL = B * L
    CH = chunk_positions
    while BL % CH:
        CH //= 2
    nch = BL // CH
    # phase-B window bytes: 256 with a wide text table OR the rows512
    # two-gather table (which serves any W <= 512 at zero extra HBM)
    WIN = 256 if (text_wide is not None or text_two_gather) else 64
    ROWS_G = BL // WIN + 2
    stride_g = WIN // 8
    gpad = (ROWS_G + 2) * stride_g * 8 - BL      # covers the global rows
    rflat = jnp.concatenate(
        [reads.reshape(-1), jnp.zeros((max(gpad, 64), ), jnp.uint8)])
    gwords = jax.lax.bitcast_convert_type(
        rflat[:(rflat.shape[0] // 8) * 8].reshape(-1, 8), jnp.uint64)

    flat_ptr = ptrs.reshape(-1)
    flat_act = (ends & (ptrs >= 0)).reshape(-1)
    lens_i = read_lens.astype(dt)

    # ---- phase A: one 64-byte compare per flat position ----
    def chunk_body(carry, xs):
        fp, fa, base = xs
        rpos0 = base * CH + jnp.arange(CH, dtype=dt)
        rrow = rpos0 // L
        limit = rrow * L + lens_i[jnp.clip(rrow, 0, B - 1)]
        phys = jnp.minimum(limit - rpos0, nt - fp)     # hard extension cap
        if text_two_gather and bulk_one_gather:
            # ONE row gather per position (vs _window_rows512's two): the
            # window is capped at the 512 B row boundary, and the ~12% of
            # positions whose LCP hits that cap simply become phase-B
            # survivors (phase B re-fetches 256 B windows at any offset) —
            # exactness is unchanged, phase-A gather traffic halves
            off = (fp & 511).astype(i32)
            rowcap = 512 - off
            kmax = jnp.minimum(phys, jnp.minimum(rowcap, 64)).astype(i32)
            if tp_axis is not None:
                rl = text_words.shape[0]
                S_ = jax.lax.psum(1, tp_axis)
                tpi = jax.lax.axis_index(tp_axis).astype(i32)
                g = jnp.clip((fp >> 9).astype(i32), 0, rl * S_ - 1)
                loc = g - tpi * rl
                mine = (loc >= 0) & (loc < rl)
                row = jax.lax.psum(
                    jnp.where(mine[:, None],
                              text_words[jnp.clip(loc, 0, rl - 1)], 0),
                    tp_axis)
            else:
                g = jnp.clip((fp >> 9).astype(i32), 0,
                             text_words.shape[0] - 1)
                row = text_words[g]                    # [CH, 128] u32
            w = jnp.concatenate(
                [row, jnp.zeros((row.shape[0], 16), row.dtype)], axis=1)
            woff = off >> 2
            for s in (64, 32, 16, 8, 4, 2, 1):
                take = ((woff & s) != 0)[:, None]
                w = jnp.where(take, w[:, s:], w[:, :w.shape[1] - s])
            tbb = jax.lax.bitcast_convert_type(w[:, :17], jnp.uint8)
            tbb = tbb.reshape(tbb.shape[0], 68)
            rem = off & 3
            for s in (2, 1):
                take = ((rem & s) != 0)[:, None]
                tbb = jnp.where(take, tbb[:, s:], tbb[:, :tbb.shape[1] - s])
            tb = tbb[:, :64]
        else:
            kmax = jnp.minimum(phys, 64).astype(i32)
            tb = (_window_rows512(text_words, fp, 64, tp_axis)
                  if text_two_gather else _aligned_bytes64(text_words, fp))
        # the read-side window of flat position base*CH+i is CONTIGUOUS
        # (starts at that byte): 64 shifted slices of the chunk's bytes
        # replace the gather+butterfly
        cb = jax.lax.dynamic_slice(
            rflat, ((base * CH).astype(jnp.int32),), (CH + 64,))
        rb = jnp.stack([cb[j:j + CH] for j in range(64)], axis=1)
        k = jnp.clip(jnp.minimum(_lcp_bytes(tb, rb), kmax), 0, 64)
        l = jnp.where(fa, k, 0).astype(dt)
        if text_two_gather and bulk_one_gather:
            # k == kmax with the physical cap binding is NOT extendable,
            # but phase B's own kmax resolves that lane to a no-op — only
            # correctness matters here, the lane count barely moves
            surv = fa & (k == kmax) & (kmax > 0)
        else:
            surv = fa & (k == 64)
        return carry, (l, surv)

    _, (l_c, surv_c) = jax.lax.scan(
        chunk_body, 0,
        (flat_ptr.reshape(nch, CH), flat_act.reshape(nch, CH),
         jnp.arange(nch, dtype=dt)))
    l_flat = l_c.reshape(B, L)
    surv = surv_c.reshape(B, L)

    # ---- phase B: survivors in dense [B, K] rounds ----
    # global read-window rows, CONTIGUOUS construction (row g = shifted row
    # views + one column — _rows_overlap's strided column slices cost ~1 s
    # at this scale). Built lazily inside round_body: the while_loop body
    # only executes when survivors exist. With text_wide the windows are
    # 256 B (stride 32 words, width 65); without (memory-tight genome-scale
    # MS, where the 256 B text table would not fit HBM) they are 64 B rows
    # shaped like build_text_words' [*, 17] tables.
    def _rtab_g():
        wpad = gwords[:(ROWS_G + 2) * stride_g]
        wpad = jnp.concatenate(
            [wpad, jnp.zeros(((ROWS_G + 2) * stride_g - wpad.shape[0],),
                             gwords.dtype)]).reshape(ROWS_G + 2, stride_g)
        return jnp.concatenate(
            [wpad[:ROWS_G], wpad[1:ROWS_G + 1], wpad[2:ROWS_G + 2, :1]],
            axis=1)

    BK = B * K
    TCH = min(tail_chunk, BK)
    while BK % TCH:
        TCH //= 2
    ntc = BK // TCH

    def tail_chunkbody(rtab_g, carry, xs):
        fidx, valid = xs                       # [TCH] flat pos, active mask
        fidc = jnp.clip(fidx, 0, BL - 1)
        p = flat_ptr[fidc]
        l0 = l_flat.reshape(-1)[fidc]
        rrow = fidc // L
        limit = rrow * L + lens_i[rrow]

        def cond(s):
            return jnp.any(s[1])

        def body(s):
            l, act = s
            tpos = p + l
            rpos = fidc.astype(dt) + l
            kmax = jnp.minimum(jnp.minimum(limit - rpos, nt - tpos),
                               WIN).astype(i32)
            if WIN == 256:
                tb = (_window_rows512(text_words, tpos, 256, tp_axis)
                      if text_two_gather
                      else _window_bytes_u8(text_wide, tpos, 256))
                rb = _window_bytes_u8(rtab_g, rpos, 256)
            else:
                tb = _aligned_bytes64(text_words, tpos)
                rb = _aligned_bytes64(rtab_g, rpos)
            k = jnp.clip(jnp.minimum(_lcp_bytes(tb, rb), kmax), 0, WIN)
            l = l + jnp.where(act, k, 0).astype(dt)
            act = act & (k == WIN)
            return l, act

        l, _ = jax.lax.while_loop(cond, body, (l0, valid))
        return carry, l

    def round_body(state):
        l_flat, m = state
        rtab_g = _rtab_g()
        sels = []
        for _ in range(K):                     # first K surviving columns
            s = jnp.min(jnp.where(m, iota, L), axis=1)       # [B]
            sels.append(s)
            m = m & (iota != s[:, None])
        sel = jnp.stack(sels, axis=1)                        # [B, K]
        valid = sel < L
        fidx = (jnp.arange(B, dtype=dt)[:, None] * L
                + jnp.clip(sel, 0, L - 1))                   # [B, K]
        _, l_res = jax.lax.scan(
            functools.partial(tail_chunkbody, rtab_g), 0,
            (fidx.reshape(ntc, TCH), valid.reshape(ntc, TCH)))
        l_res = l_res.reshape(B, K)
        for k_ in range(K):                    # merge back (no scatter)
            l_flat = jnp.where(
                valid[:, k_:k_ + 1] & (iota == sel[:, k_:k_ + 1]),
                l_res[:, k_:k_ + 1], l_flat)
        return l_flat, m

    l_flat, _ = jax.lax.while_loop(
        lambda st: jnp.any(st[1]), round_body, (l_flat, surv))

    # ---- phase C: arithmetic diagonal fill ----
    # out[i] = l_e + (e - i) for the NEAREST end e >= i, as ONE reverse
    # cummin of g[e] = l_e + e (ends only; +inf elsewhere) minus i. The
    # values at ends are true matching statistics (LCP at a valid MS
    # pointer is the maximal match), so MS[i] <= MS[i+1] + 1 holds and
    # g is non-decreasing across ends — the minimum over e >= i IS the
    # nearest end. This replaces v2's two-step fill (end-index cummin +
    # take_along_axis gather) with a single scan op.
    BIG = jnp.asarray(1 << 30, dt)
    g = jnp.where(ends, l_flat + iota, BIG)
    gmin = jax.lax.cummin(g, axis=1, reverse=True)
    out = (gmin - iota).astype(dt)
    out = jnp.where((ptrs >= 0) & in_read & (gmin < BIG), out, 0)
    return out


def _cumsum_doubling(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive prefix sum along the last axis via log-step doubling
    (shifted adds only). jnp.cumsum lowers to a reduce-window whose scratch
    grew with the axis length on the earlier target (a compile-time OOM
    past ~2^14); this stays at O(1) scratch per step."""
    n = int(x.shape[-1])
    pad = [(0, 0)] * (x.ndim - 1)
    sh = 1
    while sh < n:
        x = x + jnp.pad(x, pad + [(sh, 0)])[..., :-sh]
        sh *= 2
    return x


def _compact_indices(rem: jnp.ndarray, CH: int):
    """Manual nonzero(size=CH, fill=SEG): ascending indices of the first
    <=CH set bits of `rem` [SEG], plus `rem` with those bits cleared.
    Blocked [SEG/128, 128] + doubling prefix sums keep the lowering free of
    large reduce-windows (see _cumsum_doubling)."""
    SEG = int(rem.shape[0])
    m = rem.reshape(-1, 128).astype(jnp.int32)
    inc = _cumsum_doubling(m)                          # [S1, 128] inclusive
    rowsum = inc[:, -1]
    rows = _cumsum_doubling(rowsum) - rowsum           # exclusive row offset
    pos = (rows[:, None] + inc - m).reshape(-1)        # rank of each set bit
    take = rem & (pos < CH)
    src = jnp.arange(SEG, dtype=jnp.int32)
    idx = jnp.full((CH,), SEG, jnp.int32)
    idx = idx.at[jnp.where(take, pos, CH)].set(src)    # index CH is dropped
    return idx, rem & ~take


@functools.partial(jax.jit,
                   static_argnames=("nt", "seg_positions", "chunk_lanes"))
def extend_pointers_diag2(text_words: jnp.ndarray, reads: jnp.ndarray,
                          read_lens: jnp.ndarray, ptrs: jnp.ndarray, nt: int,
                          seg_positions: int = 131072,
                          chunk_lanes: int = 16384):
    """MS extension v3: diagonal-run brute pass with END COMPACTION.

    Same diagonal-run decomposition as extend_pointers_diag (only pointer-
    diagonal ENDS need a brute LCP; interiors fill arithmetically), but the
    brute pass no longer burns a gather slot on the ~90% of flat positions
    that are NOT ends: each segment of `seg_positions` flat read positions
    compacts its active ends into dense `chunk_lanes`-lane groups with
    jnp.nonzero(size=...) inside a while_loop (repeats only if a segment has
    more than chunk_lanes ends — exactness does not depend on the end
    density). Both the text-window and the per-segment read-window tables
    stay under the gather row-count cliff, so each 64-byte compare costs
    two row gathers on ACTIVE lanes only.

    Matches the reference's SLP extension loop (compute_ms_pml.cpp:802-810)
    under the same precondition as v2: all pointers >= 1 (reads with
    reset/underflow pointers take ScanEngine's sequential-carry fallback).
    """
    B, L = reads.shape
    dt = ptrs.dtype
    iota = jnp.arange(L, dtype=dt)[None, :]

    nxt = jnp.concatenate([ptrs[:, 1:], jnp.full((B, 1), -(1 << 30), dt)],
                          axis=1)
    in_read = iota < read_lens[:, None]
    ends = ((iota >= read_lens[:, None] - 1) | (nxt != ptrs + 1)
            | (ptrs <= 0)) & in_read

    BL = B * L
    SEG = min(seg_positions, BL)
    while BL % SEG:
        SEG //= 2
    if SEG % 128:
        # _compact_indices reshapes to [SEG/128, 128]; buckets whose B*L
        # has a 2-adic factor below 128 (e.g. odd B at L=64) can't be
        # segmented — degrade to the v2 kernel instead of failing at trace
        return extend_pointers_diag(text_words, reads, read_lens, ptrs, nt,
                                    chunk_lanes=chunk_lanes)
    CH = min(chunk_lanes, SEG)
    nseg = BL // SEG
    ROWS = (SEG + L) // 64 + 3
    gpad = (ROWS * 64 + 136) * nseg - BL
    gpad = max(gpad, ROWS * 64 + 136 - SEG)
    rflat = jnp.concatenate(
        [reads.reshape(-1), jnp.zeros((gpad,), jnp.uint8)])
    gwords = jax.lax.bitcast_convert_type(
        rflat[:(rflat.shape[0] // 8) * 8].reshape(-1, 8), jnp.uint64)

    flat_ptr = ptrs.reshape(-1)
    flat_act = (ends & (ptrs >= 0)).reshape(-1)

    def seg_body(carry, xs):
        fp, fa, base = xs                       # [SEG], [SEG] bool, scalar
        seg0 = (base * SEG).astype(dt)
        ws = jax.lax.dynamic_slice(
            gwords, ((base * SEG // 8).astype(jnp.int32),), (ROWS * 8 + 17,))
        rtab = _rows17(ws, ROWS)
        # 64 B-ALIGNED read rows: after the peeled first step every
        # surviving lane's rpos is a multiple of 64, so later iterations
        # read the read-side window with ONE plain row gather (no per-lane
        # shift/select machinery, which dominates the unaligned path)
        rtab8 = ws[:ROWS * 8].reshape(ROWS, 8)

        def outer_cond(st):
            return jnp.any(st[1])

        def outer_body(st):
            l_seg, rem = st
            idx, rem = _compact_indices(rem, CH)
            valid = idx < SEG                   # fill slots stay inactive
            idc = jnp.clip(idx, 0, SEG - 1)
            p = fp[idc]
            rpos0 = seg0 + idx.astype(dt)
            rrow = rpos0 // L
            limit = rrow * L + read_lens[jnp.clip(rrow, 0, B - 1)]

            # peeled first step: unaligned both sides, window w0 chosen so
            # survivors land on the read-side 64 B grid
            w0 = 64 - (rpos0 & 63)
            kmax0 = jnp.minimum(
                jnp.minimum(limit - rpos0, nt - p), w0).astype(dt)
            ta = _aligned_u64x8(text_words, p, dt)
            ra = _aligned_u64x8(rtab, rpos0 - seg0, dt)
            k0 = jnp.clip(jnp.minimum(_match64(ta, ra, dt), kmax0), 0, 64)
            l1 = jnp.where(valid, k0, 0)
            act1 = valid & (k0 == w0)

            def cond(s):
                return jnp.any(s[1])

            def body(s):
                l, act = s
                tpos = p + l
                rpos = rpos0 + l                # multiple of 64 while active
                kmax = jnp.minimum(jnp.minimum(limit - rpos, nt - tpos),
                                   64).astype(dt)
                ta = _aligned_u64x8(text_words, tpos, dt)
                ra = rtab8[jnp.clip((rpos - seg0) >> 6, 0, ROWS - 1)]
                mb = _match64(ta, ra, dt)
                k = jnp.clip(jnp.minimum(mb, kmax), 0, 64)
                l = l + jnp.where(act, k, 0)
                act = act & (k == 64)
                return l, act

            l, _ = jax.lax.while_loop(cond, body, (l1, act1))
            l_seg = l_seg.at[idx].set(l)        # OOB fills are dropped
            return l_seg, rem

        l_seg0 = jnp.zeros((SEG,), dt)
        l_seg, _ = jax.lax.while_loop(outer_cond, outer_body, (l_seg0, fa))
        return carry, l_seg

    _, l_flat = jax.lax.scan(
        seg_body, 0,
        (flat_ptr.reshape(nseg, SEG), flat_act.reshape(nseg, SEG),
         jnp.arange(nseg, dtype=dt)))
    l_brute = l_flat.reshape(B, L)

    e_idx = jax.lax.cummin(jnp.where(ends, iota, L + L), axis=1,
                           reverse=True)
    e_c = jnp.clip(e_idx, 0, L - 1).astype(jnp.int32)
    l_e = jnp.take_along_axis(l_brute, e_c, axis=1)
    out = (e_idx - iota).astype(dt) + l_e
    out = jnp.where((ptrs >= 0) & in_read & (e_idx < L + L), out, 0)
    return out


@functools.partial(jax.jit, static_argnames=("nt",))
def extend_pointers_kernel(text: jnp.ndarray, reads: jnp.ndarray,
                           read_lens: jnp.ndarray, ptrs: jnp.ndarray, nt: int):
    """MS extension: pointers -> lengths by direct text comparison.

    Replaces the reference's SLP charAt loop (compute_ms_pml.cpp:802-810) with
    a TWO-POINTER lockstep sweep: every while iteration either extends the
    current match length l by one character or emits position i's length and
    advances i. Matching statistics are 1-Lipschitz (l_i >= l_{i-1} - 1, and
    the emitted pointer maximizes the LCP, so the first max(l-1, 0)
    characters are already known to match at the next pointer) — hence the
    per-lane total is <= 3L iterations and each iteration is O(1) row-ops,
    instead of a data-dependent character loop of scalar gathers per scan
    step.

    reads/ptrs are in natural (unreversed) order, [B, L]; read_lens is [B].
    ptr < 0 encodes the reference's underflowed unsigned pointers
    (compute_ms_pml.cpp:582) — always out of bounds for extension.
    """
    B, L = reads.shape
    dt = ptrs.dtype
    lane = jnp.arange(B)
    # text grouped into <=2^17 rows (see layered.py GATHER_ROW_CLIFF): the
    # per-character text lookup becomes one row gather + an in-row select
    tg = 64
    while nt // tg > (1 << 17):
        tg *= 2
    text2d = text.reshape(nt // tg, tg)
    gsel = jnp.arange(tg, dtype=dt)[None, :]

    def body(state):
        i, l, out = state
        active = i < read_lens
        ri = jnp.clip(i + l, 0, L - 1)
        rch = jnp.take_along_axis(reads, ri[:, None].astype(jnp.int32),
                                  axis=1)[:, 0].astype(dt)
        ptr = jnp.take_along_axis(
            ptrs, jnp.clip(i, 0, L - 1)[:, None].astype(jnp.int32),
            axis=1)[:, 0]
        tpos = ptr + l
        trow = text2d[jnp.clip(tpos // tg, 0, nt // tg - 1)]
        tch = jnp.sum(jnp.where(gsel == (tpos % tg)[:, None], trow, 0),
                      axis=1).astype(dt)
        ok = (active & (i + l < read_lens) & (ptr >= 0)
              & (tpos < nt) & (tpos >= 0) & (rch == tch))
        emit = active & ~ok
        new_out = out.at[lane, jnp.clip(i, 0, L - 1)].set(
            jnp.where(emit, l, out[lane, jnp.clip(i, 0, L - 1)]))
        new_i = jnp.where(emit, i + 1, i)
        new_l = jnp.where(ok, l + 1, jnp.maximum(l - 1, 0))
        new_l = jnp.where(active, new_l, l)
        return new_i, new_l, new_out

    def cond(state):
        i, _, _ = state
        return jnp.any(i < read_lens)

    i0 = jnp.zeros((B,), dt)
    out0 = jnp.zeros((B, L), dt)
    _, _, out = jax.lax.while_loop(cond, body, (i0, i0, out0))
    return out  # [B, L]


_downcast_u16 = jax.jit(lambda x: x.astype(jnp.uint16))
_downcast_u8 = jax.jit(lambda x: x.astype(jnp.uint8))
_batch_max = jax.jit(jnp.max)


@functools.partial(jax.jit, static_argnames=("bin_width", "max_bins"))
def binmax_values_kernel(vals_fwd, lens, max_value_thr, bin_width: int,
                         max_bins: int):
    """On-device bin-max classification of a natural-order [B, L] value
    matrix (compute_ms_pml.cpp:975-995 with the short-tail merge rule):
    returns per-lane (found, above, below, sum_maxes) — O(B) leaves the
    device. `max_bins` must be >= ceil(L / bin_width)."""
    B, L = vals_fwd.shape
    dt = vals_fwd.dtype
    lens = lens.astype(dt)
    p = jnp.arange(L, dtype=dt)
    nbins = jnp.maximum(lens // bin_width, 1)
    # the final short remainder merges into the previous window (binmax.py)
    binid = jnp.minimum(p[None, :] // bin_width, nbins[:, None] - 1)
    valid = p[None, :] < lens[:, None]
    neg = jnp.full_like(vals_fwd, -1)
    above = jnp.zeros((B,), jnp.int32)
    summ = jnp.zeros((B,), dt)
    for j in range(max_bins):
        sel = jnp.where(valid & (binid == j), vals_fwd, neg)
        mx = jnp.max(sel, axis=1)
        has = mx >= 0
        above = above + ((mx >= max_value_thr) & has).astype(jnp.int32)
        summ = summ + jnp.where(has, mx, 0)
    below = nbins.astype(jnp.int32) - above
    found = (above > below) & (lens > 0)
    return found, above, below, summ


@jax.jit
def _flip_to_forward(vals_rev, lens):
    """Per-lane reversal of the first lens[i] columns (scan emits values in
    reversed read order)."""
    B, L = vals_rev.shape
    p = jnp.arange(L)
    idx = jnp.clip(lens[:, None] - 1 - p[None, :], 0, L - 1)
    return jnp.take_along_axis(vals_rev, idx.astype(jnp.int32), axis=1)


@jax.jit
def _flip_rows(x, lens):
    """Fast per-lane reversal of the first lens[i] columns: full column
    reverse + a log2(L)-step butterfly LEFT-shift by (L - lens) per lane.
    take_along_axis is a per-element gather; the butterfly is ~10
    predicated selects at memory bandwidth (whether it still wins on the
    GPU is ROADMAP design item 4). Columns past
    lens[i] come out ZERO (the pad shifts zeros in), matching encode_rows
    padding."""
    B, L = x.shape
    y = x[:, ::-1]
    sh = (L - lens).astype(jnp.int32)
    s = 1
    while s < L:
        take = ((sh & s) != 0)[:, None]
        y = jnp.where(take, jnp.pad(y, ((0, 0), (0, s)))[:, s:], y)
        s *= 2
    return y


@jax.jit
def _unpack4(xp):
    """[B, H] u8 of packed 4-bit codes -> [B, 2H] u8 (lo nibble first)."""
    lo = xp & jnp.uint8(15)
    hi = xp >> jnp.uint8(4)
    B, H = xp.shape
    return jnp.stack([lo, hi], axis=2).reshape(B, 2 * H)


@functools.partial(jax.jit, static_argnames=("alpha",))
def _decode_alpha(codes, alpha: tuple):
    """Alphabet-rank codes -> raw bytes via predicated selects (in place of
    a per-element 256-entry table gather)."""
    out = jnp.zeros(codes.shape, jnp.uint8)
    for i, byte in enumerate(alpha):
        if byte:
            out = jnp.where(codes == i, jnp.uint8(byte), out)
    return out


@functools.partial(jax.jit, static_argnames=("ranks",))
def _unpack2(xp, ranks: tuple, exc_rows, exc_cols, exc_vals):
    """[B, L/4] u8 of packed 2-bit ACGT codes -> [B, L] u8 values: codes
    decode through the 4-entry static `ranks` (predicated selects), then
    the sparse exception triples (non-ACGT bases; row index B = padding)
    scatter their true 8-bit values on top. Halves the dominant h2d
    transfer again vs 4-bit."""
    B, Q = xp.shape
    codes = jnp.stack([(xp >> jnp.uint8(2 * k)) & jnp.uint8(3)
                       for k in range(4)], axis=2).reshape(B, 4 * Q)
    out = jnp.zeros(codes.shape, jnp.uint8)
    for c, rk in enumerate(ranks):
        if rk:
            out = jnp.where(codes == c, jnp.uint8(rk), out)
    return out.at[exc_rows, exc_cols].set(exc_vals.astype(jnp.uint8),
                                          mode="drop")


@jax.jit
def _anomalous_mask(ptrs_fwd, lens):
    """Lanes with any in-read pointer <= 0 (reset / unsigned underflow):
    they take the sequential-carry extension fallback."""
    p = jnp.arange(ptrs_fwd.shape[1])
    in_read = p[None, :] < lens[:, None]
    return jnp.any(in_read & (ptrs_fwd <= 0), axis=1)


class ScanEngine:
    """Host-side wrapper: packs variable-length reads into padded batches,
    runs the lockstep kernels, unpacks per-read outputs.

    The counterpart of pml_t / ms_t (compute_ms_pml.cpp:694-838).
    """

    def __init__(self, arrays, meta, mode: str = "pml",
                 use_doc: bool = False, pad_to: int = 128, host=None,
                 chunk: int = 4096):
        assert mode in ("pml", "ms")
        self.chunk = chunk
        if mode == "ms" and not meta.has_samples:
            raise ValueError("MS mode requires an index built with SA samples")
        if use_doc and not meta.has_doc:
            raise ValueError("doc output requires an index with a document array")
        self.arrays = arrays
        self.meta = meta
        self.mode = mode
        self.use_doc = use_doc
        self.pad_to = pad_to
        self.layered = hasattr(arrays, "fields")
        self.occ = hasattr(arrays, "blocks")
        self.bits = hasattr(arrays, "bblocks")
        if self.bits and (mode != "pml" or use_doc) and not meta.has_ms:
            raise ValueError("block-bits MS/doc needs an index built with "
                             "want_ms/want_doc (or use engine=layered)")
        if self.bits and mode == "ms" and arrays.jump_t is None:
            raise ValueError("block-bits MS needs SA-sample jump tables "
                             "(build with want_ms=True)")
        if self.bits and use_doc and arrays.jump_d is None:
            raise ValueError("block-bits doc tracking needs doc jump tables "
                             "(build with want_doc=True)")
        if (self.occ or self.bits) and host is None:
            raise ValueError("occ/block-bits engines require their OccHost")
        self.host = host if (self.layered or self.occ or self.bits) else None
        self.r = int(arrays.fields.shape[0] if self.layered
                     else arrays.blocks.shape[0] if self.occ
                     else arrays.bblocks.shape[0] if self.bits
                     else arrays.c_start.shape[0])
        self.nt = int(arrays.text.shape[0]) if arrays.text is not None else 0
        self._text_words = None  # built lazily for the MS extension
        self._text_wide = None   # 256 B-window table (extension phase 2)
        self._text_two_gather = False  # set by _ensure_text_words (rows512)
        self._stage_alpha = None  # staged path: cached (growing) alphabet
        self._stage_amap = None   # 256-byte LUT for it (255 = uncovered)
        self.mesh = None          # data-parallel mesh (to_mesh)

    def to_mesh(self, mesh) -> "ScanEngine":
        """Makes this engine data-parallel over `mesh`'s 'data' axis: the
        index arrays are replicated across the devices and staged read
        batches are placed with a 'data'-sharded NamedSharding — the
        already-jitted kernels then run sharded via GSPMD propagation (the
        pattern certified by dryrun_multichip / ShardedPmlClassifier for
        every mode incl. MS + doc). The device analog of the reference's
        OpenMP threads over read batches (compute_ms_pml.cpp:894,1082)."""
        from ..parallel.mesh import replicate_index

        self.mesh = mesh
        self.arrays = replicate_index(self.arrays, mesh)
        return self

    def _bucket_L(self, m: int) -> int:
        L = self.pad_to
        while L < m and L < self.chunk:
            L *= 2
        if m > L:  # long reads: multiples of the chunk size (carried state)
            L = -(-m // self.chunk) * self.chunk
        return L

    def _fetch(self, v, L: int):
        """Device->host value fetch; PML lengths are downcast to uint16 ON
        DEVICE first (lengths < L <= 65535) — 4x less data through the
        host link, which production value-emitting runs are bound by."""
        if (self.mode == "pml" and L <= 0xFFFF
                and not isinstance(v, np.ndarray)):
            # adaptive width: the batch max (an O(1) transfer) picks u8
            # when every PML fits a byte — the common case, halving the
            # dominant d2h transfer
            if int(_batch_max(v)) < 256:
                v = _downcast_u8(v)
            else:
                v = _downcast_u16(v)
        return np.asarray(v)

    def _query_group(self, reads, L: int):
        """Runs one padded [B, L] kernel invocation (B = next power of two,
        capped by max_lanes chunks upstream)."""
        B = max(1, 1 << (len(reads) - 1).bit_length())
        fwd, rev, lens = encode_rows(reads, B, L)
        if self.bits:
            alphabet = tuple(sorted(
                {0} | set(int(x) for x in present_chars(rev))))
            ctab = self.host.table_for_alphabet(alphabet)
            revm = self.host.rank_map(alphabet)[rev]
            v4ms = self.mode == "ms" or self.use_doc
            if L > self.chunk and v4ms:
                # chunked long reads: (jidx, d) state carries across chunk
                # kernels exactly like (pos, sample) would
                from .blockbits import ms_initial_state
                state = ms_initial_state(self.arrays, self.meta,
                                         revm.shape[0], self.mode)
                v_parts, d_parts = [], []
                for c0 in range(0, L, self.chunk):
                    v, d, state = query_batch_kernel_v4ms(
                        self.arrays, jnp.asarray(revm[:, c0:c0 + self.chunk]),
                        self.meta, self.mode, self.use_doc, ctab, state)
                    v_parts.append(self._fetch(v, L))
                    if self.use_doc:
                        d_parts.append(np.asarray(d))
                vals = np.concatenate(v_parts, axis=1)
                docs = np.concatenate(d_parts, axis=1) if self.use_doc \
                    else None
            elif v4ms:
                vals, docs = query_batch_kernel_v4ms(
                    self.arrays, jnp.asarray(revm), self.meta, self.mode,
                    self.use_doc, ctab)[:2]
            elif L > self.chunk:
                state = initial_state(self.arrays, revm.shape[0])
                v_parts = []
                for c0 in range(0, L, self.chunk):
                    v, state = query_batch_kernel_v4(
                        self.arrays, jnp.asarray(revm[:, c0:c0 + self.chunk]),
                        self.meta, ctab, state)
                    v_parts.append(self._fetch(v, L))
                vals = np.concatenate(v_parts, axis=1)
                docs = None
            else:
                vals, _ = query_batch_kernel_v4(
                    self.arrays, jnp.asarray(revm), self.meta, ctab)
                docs = None
        elif self.occ:
            from .occblock import occ_initial_state
            alphabet = tuple(sorted(
                {0} | set(int(x) for x in present_chars(rev))))
            ctab = self.host.table_for_alphabet(alphabet)
            revm = self.host.rank_map(alphabet)[rev]
            lag = (self.mode == "ms") or self.use_doc
            if L > self.chunk:
                # chunked: RAW emits per chunk (+ one sentinel column when
                # lagged), realigned here — see query_batch_kernel_v3
                state = occ_initial_state(self.arrays, revm.shape[0])
                v_parts, d_parts = [], []
                cols = list(range(0, L, self.chunk))
                for c0 in cols:
                    v, d, state = query_batch_kernel_v3(
                        self.arrays, jnp.asarray(revm[:, c0:c0 + self.chunk]),
                        self.meta, self.mode, self.use_doc, ctab, state,
                        finalize=False)
                    v_parts.append(self._fetch(v, L))
                    if self.use_doc:
                        d_parts.append(np.asarray(d))
                if lag:
                    v, d, state = query_batch_kernel_v3(
                        self.arrays, jnp.zeros((revm.shape[0], 1), jnp.uint8),
                        self.meta, self.mode, self.use_doc, ctab, state,
                        finalize=False)
                    v_parts.append(self._fetch(v, L))
                    if self.use_doc:
                        d_parts.append(np.asarray(d))
                vals = np.concatenate(v_parts, axis=1)
                docs = np.concatenate(d_parts, axis=1) if self.use_doc else None
                if lag:
                    vals = vals[:, 1:] if self.mode == "ms" else vals[:, :L]
                    docs = docs[:, 1:] if self.use_doc else None
            else:
                vals, docs = query_batch_kernel_v3(
                    self.arrays, jnp.asarray(revm), self.meta, self.mode,
                    self.use_doc, ctab)[:2]
        elif self.layered:
            ctab = None
            if self.host is not None:
                # reduced-alphabet fused lookup: rank-map reads on the host
                alphabet = tuple(sorted(
                    set(self.host.index_chars)
                    | set(int(x) for x in present_chars(rev)) | {0}))
                rev = self.host.rank_map(alphabet)[rev]
                ctab = self.host.table_for_alphabet(alphabet)
            if L > self.chunk:
                # long reads: carry the O(1)-per-lane recurrence state across
                # fixed-size chunks so every chunk reuses one compiled kernel
                state = initial_state(self.arrays, rev.shape[0])
                v_parts, d_parts = [], []
                for c0 in range(0, L, self.chunk):
                    v, d, state = query_batch_kernel_v2(
                        self.arrays, jnp.asarray(rev[:, c0:c0 + self.chunk]),
                        self.meta, self.mode, self.use_doc, ctab, state)
                    v_parts.append(self._fetch(v, L))
                    if self.use_doc:
                        d_parts.append(np.asarray(d))
                vals = np.concatenate(v_parts, axis=1)
                docs = np.concatenate(d_parts, axis=1) if self.use_doc else None
            else:
                vals, docs = query_batch_kernel_v2(
                    self.arrays, jnp.asarray(rev), self.meta, self.mode,
                    self.use_doc, ctab)[:2]
        else:
            vals, docs = query_batch_kernel(
                self.arrays, jnp.asarray(rev), self.meta, self.mode,
                self.use_doc, self.r)
        vals = self._fetch(vals, L)
        nreads = len(reads)
        out = {}
        unrev = lambda mat: [mat[i, :lens[i]][::-1].copy()
                             for i in range(nreads)]
        if self.mode == "pml":
            out["lengths"] = unrev(vals)
        else:
            out["pointers"] = unrev(vals)
            if self.arrays.text is not None:
                ptrs_fwd = np.zeros((B, L), dtype=vals.dtype)
                for i in range(nreads):
                    ptrs_fwd[i, :lens[i]] = vals[i, :lens[i]][::-1]
                self._ensure_text_words()
                lens_mat = np.array(extend_pointers_sweep(
                    self._text_words, jnp.asarray(fwd),
                    jnp.asarray(lens.astype(vals.dtype)),
                    jnp.asarray(ptrs_fwd), self.nt, self._text_wide,
                    text_two_gather=self._text_two_gather))
                # Reads with any pointer <= 0 (reset artifacts / unsigned
                # underflow from index-absent chars) take the reference's
                # QUIRK path: the extension carry l = max(l-1, 0) applies
                # even through garbage pointers and extension restarts from
                # the carried (unverified) offset (compute_ms_pml.cpp:802-810)
                # — not a pure LCP. Route those rare reads through the exact
                # sequential-carry kernel.
                anom = [i for i in range(nreads)
                        if lens[i] and (ptrs_fwd[i, :lens[i]] <= 0).any()]
                if anom:
                    Ba = max(1, 1 << (len(anom) - 1).bit_length())
                    sf = np.zeros((Ba, L), np.uint8)
                    sp = np.zeros((Ba, L), ptrs_fwd.dtype)
                    sl = np.zeros((Ba,), np.int64)
                    for j, i in enumerate(anom):
                        sf[j], sp[j], sl[j] = fwd[i], ptrs_fwd[i], lens[i]
                    sub = np.asarray(extend_pointers_kernel(
                        self.arrays.text, jnp.asarray(sf),
                        jnp.asarray(sl.astype(vals.dtype)),
                        jnp.asarray(sp), self.nt))
                    for j, i in enumerate(anom):
                        lens_mat[i] = sub[j]
                out["lengths"] = [lens_mat[i, :lens[i]].copy()
                                  for i in range(nreads)]
        if self.use_doc:
            out["docs"] = unrev(np.asarray(docs))
        return out

    def _classify_group(self, reads, L: int, bin_width: int, thr: int):
        """Classify-only kernel invocation for one [B, L<=chunk] bucket:
        PML folds bin-max into the scan carry (fused_classify_kernel); MS
        scans pointers, extends, and bin-maxes the extended lengths — all on
        device. Only [B] summaries are transferred."""
        from ..parallel.mesh import fused_classify_kernel

        B = max(1, 1 << (len(reads) - 1).bit_length())
        fwd, rev, lens = encode_rows(reads, B, L)

        ctab = None
        if self.bits or self.occ:
            alphabet = tuple(sorted(
                {0} | set(int(x) for x in present_chars(rev))))
            ctab = self.host.table_for_alphabet(alphabet)
            rev = self.host.rank_map(alphabet)[rev]
        elif self.layered and self.host is not None:
            alphabet = tuple(sorted(
                set(self.host.index_chars)
                | set(int(x) for x in present_chars(rev)) | {0}))
            rev = self.host.rank_map(alphabet)[rev]
            ctab = self.host.table_for_alphabet(alphabet)
        lens_d = jnp.asarray(lens)

        if self.mode == "pml":
            found, above, below, summ = fused_classify_kernel(
                self.arrays, jnp.asarray(rev), lens_d, thr, self.meta,
                "pml", self.r, bin_width, ctab)
            return (np.asarray(found), np.asarray(above),
                    np.asarray(below), np.asarray(summ))

        # MS: pointer scan -> on-device extension -> on-device bin-max
        if self.arrays.text is None:
            raise ValueError("MS classification requires an index with text")
        if self.occ:
            ptrs_rev = query_batch_kernel_v3(
                self.arrays, jnp.asarray(rev), self.meta, "ms", False,
                ctab)[0]
        elif self.layered:
            ptrs_rev = query_batch_kernel_v2(
                self.arrays, jnp.asarray(rev), self.meta, "ms", False,
                ctab)[0]
        else:
            ptrs_rev = query_batch_kernel(
                self.arrays, jnp.asarray(rev), self.meta, "ms", False,
                self.r)[0]
        dt = ptrs_rev.dtype
        lens_dt = lens_d.astype(dt)
        ptrs_fwd_d = _flip_rows(ptrs_rev, lens_dt)
        self._ensure_text_words()
        lens_mat = extend_pointers_sweep(
            self._text_words, jnp.asarray(fwd), lens_dt, ptrs_fwd_d, self.nt,
            self._text_wide, text_two_gather=self._text_two_gather)
        max_bins = max(1, -(-L // bin_width))
        found, above, below, summ = binmax_values_kernel(
            lens_mat, lens_dt, thr, bin_width, max_bins)
        # np.array (copy): device-array views are read-only, and the
        # anomalous lanes below are overwritten in place
        found, above, below, summ = (np.array(found), np.array(above),
                                     np.array(below), np.array(summ))

        anom = np.nonzero(np.asarray(_anomalous_mask(ptrs_fwd_d, lens_dt))
                          [:len(reads)])[0]
        if len(anom):
            # reference quirk path (see _query_group): re-extend those lanes
            # with the exact sequential-carry kernel, re-classify on device
            sel = jnp.asarray(anom.astype(np.int32))
            sub_ptrs = jnp.take(ptrs_fwd_d, sel, axis=0)
            sub_fwd = jnp.asarray(fwd[anom])
            sub_lens = jnp.take(lens_dt, sel)
            sub_mat = extend_pointers_kernel(
                self.arrays.text, sub_fwd, sub_lens, sub_ptrs, self.nt)
            f2, a2, b2, s2 = binmax_values_kernel(
                sub_mat, sub_lens, thr, bin_width, max_bins)
            found[anom] = np.asarray(f2)
            above[anom] = np.asarray(a2)
            below[anom] = np.asarray(b2)
            summ[anom] = np.asarray(s2)
        return found, above, below, summ

    def classify(self, reads, bin_width: int, max_value_thr: int,
                 max_lanes: int = 65536):
        """Fused report-only classification (the -c path of
        compute_ms_pml.cpp:845-1034 without value-file output): bin-max
        verdicts are computed on device and only O(B) summaries cross the
        host link. Long-read buckets (L > chunk) fall back to the value
        path + host classification (bin windows span chunk boundaries).
        max_lanes is larger than query()'s: only O(B) summaries return, so
        bigger kernel calls amortize the per-step scan overhead with no
        d2h penalty."""
        from ..classify import binmax

        n = len(reads)
        out = {"found": np.zeros(n, dtype=bool),
               "above": np.zeros(n, dtype=np.int64),
               "below": np.zeros(n, dtype=np.int64),
               "sum_maxes": np.zeros(n, dtype=np.int64)}
        groups: dict[int, list[int]] = {}
        for i, rd in enumerate(reads):
            groups.setdefault(self._bucket_L(max(1, len(rd))), []).append(i)
        for L, idxs in sorted(groups.items()):
            for c0 in range(0, len(idxs), max_lanes):
                chunk = idxs[c0:c0 + max_lanes]
                sub = [reads[i] for i in chunk]
                if L > self.chunk:
                    res = self._query_group(sub, L)
                    for j, i in enumerate(chunk):
                        r_ = binmax.classify(res["lengths"][j], bin_width,
                                             max_value_thr)
                        out["found"][i] = r_.status == "FOUND"
                        out["above"][i] = r_.bins_above
                        out["below"][i] = r_.bins_below
                        out["sum_maxes"][i] = int(r_.bin_maxes.sum())
                    continue
                f, a, b, s = self._classify_group(sub, L, bin_width,
                                                  max_value_thr)
                for j, i in enumerate(chunk):
                    out["found"][i] = f[j]
                    out["above"][i] = a[j]
                    out["below"][i] = b[j]
                    out["sum_maxes"][i] = s[j]
        return out

    def query(self, reads, max_lanes: int = 8192):
        """Returns dict with per-read numpy arrays:
        pml: {'lengths': [...]}; ms: {'pointers': [...], 'lengths': [...]};
        plus 'docs' when use_doc.

        Reads are grouped into power-of-two length buckets (lockstep lanes in
        a bucket share the padded length) and each bucket is chunked to at
        most max_lanes lanes per kernel call.
        """
        groups: dict[int, list[int]] = {}
        for i, rd in enumerate(reads):
            groups.setdefault(self._bucket_L(max(1, len(rd))), []).append(i)
        fields = {"pml": ["lengths"], "ms": ["pointers", "lengths"]}[self.mode]
        if self.mode == "ms" and self.arrays.text is None:
            fields = ["pointers"]
        if self.use_doc:
            fields = fields + ["docs"]
        out = {f: [None] * len(reads) for f in fields}
        for L, idxs in sorted(groups.items()):
            for c0 in range(0, len(idxs), max_lanes):
                chunk = idxs[c0:c0 + max_lanes]
                res = self._query_group([reads[i] for i in chunk], L)
                for f in fields:
                    for j, i in enumerate(chunk):
                        out[f][i] = res[f][j]
        return out

    # ------------------------------------------------------------------
    # staged (array-native) path: host prep + h2d upload split from device
    # compute so a prefetch thread overlaps them (the per-read Python prep
    # is far slower than the kernels)
    # ------------------------------------------------------------------

    def _ensure_alpha(self):
        """Seeds the staged path's CACHED, monotonically growing alphabet.
        A SUPERSET alphabet is always correct (extra ranks carry their own
        cnt/F; absent chars simply never occur), so the alphabet only grows
        and kernel table shapes stay stable across batches — one LUT pass
        per batch instead of a full bincount (alphabet detection)."""
        if self._stage_alpha is None:
            seed = ({0} | set(b"ACGTN")
                    | set(int(c) for c in self.host.index_chars))
            self._stage_alpha = tuple(sorted(seed))
            self._stage_amap = self._build_amap255(self._stage_alpha)

    def _extend_alpha(self, present):
        alpha = tuple(sorted(set(self._stage_alpha)
                             | set(int(x) for x in present)))
        if len(alpha) >= 255:
            raise ValueError("alphabet too large for the staged path")
        self._stage_alpha = alpha
        self._stage_amap = self._build_amap255(alpha)

    def _rank_for_stage(self, mat: np.ndarray) -> np.ndarray:
        """Rank-maps a [B, L] byte matrix with the cached alphabet; bytes
        hitting sentinel 255 trigger an exact recompute + extension."""
        self._ensure_alpha()
        mapped = self._stage_amap[mat]
        if (mapped == 255).any():
            self._extend_alpha(present_chars(mat))
            mapped = self._stage_amap[mat]
        return mapped

    @staticmethod
    def _build_amap255(alphabet: tuple) -> np.ndarray:
        amap = np.full(256, 255, np.uint8)
        for i, c in enumerate(alphabet):
            amap[c] = i
        return amap

    def stage(self, packed, max_lanes: int = 65536):
        """Host-side prep + device upload for one PackedReads batch.

        Runs bucketing, matrix packing, rank mapping, and device_put —
        everything UP TO the kernel — so a prefetch thread can execute it
        while the device computes the previous batch (the staging half of
        the reference's BatchLoader + omp-critical loop,
        batch_loader.cpp:26-76). Returns a list of staged groups consumed
        by classify_staged / query_staged."""
        import jax

        lens_all = np.asarray(packed.lens)
        if (lens_all == 0).any():
            i = int(np.flatnonzero(lens_all == 0)[0])
            raise ValueError(
                f"{packed.ids[i]} was empty after digestion; remove the read "
                f"or run without minimizer digestion")
        m = np.maximum(lens_all, 1)
        # vectorized _bucket_L
        p2 = (2 ** np.ceil(np.log2(m))).astype(np.int64)
        Lb = np.where(m > self.chunk, -(-m // self.chunk) * self.chunk,
                      np.clip(p2, self.pad_to, self.chunk))
        offs = packed.offs
        buf = packed.buf
        want_fwd_raw = self.mode == "ms" and self.arrays.text is not None
        groups = []
        for L in np.unique(Lb):
            L = int(L)
            idxs = np.flatnonzero(Lb == L)
            if L > self.chunk:
                # long reads: rare — reconstruct bytes, old chunked path
                sub = [buf[offs[i]:offs[i + 1]].tobytes() for i in idxs]
                groups.append({"long": True, "L": L, "idxs": idxs,
                               "reads": sub})
                continue
            for c0 in range(0, len(idxs), max_lanes):
                sel = idxs[c0:c0 + max_lanes]
                B = max(1, 1 << (len(sel) - 1).bit_length())
                if self.mesh is not None:
                    nd = int(self.mesh.devices.size)
                    B = max(B, nd)
                    if B % nd:
                        B = (B // nd + 1) * nd
                lens = np.zeros((B,), np.int64)
                lens[:len(sel)] = lens_all[sel]
                if self.host is not None:
                    self._ensure_alpha()
                # 2-bit (ACGT + sparse exceptions) or 4-bit packing shrinks
                # the h2d bill 4x/2x (reads are the dominant transfer of a
                # report-only run)
                use_native = os.environ.get("SPN_PY_PACK") != "1"
                starts, ends_ = offs[sel], offs[sel + 1]
                exc = None
                if use_native:
                    from ..native import pack_rows_native
                    amap = (self._stage_amap if self.host is not None
                            else _IDENT_AMAP)
                    bits = 2 if self.host is not None else 8
                    for _attempt in range(3):
                        fall = (4 if self.host is not None
                                and len(self._stage_alpha) <= 16 else 8)
                        revm, miss, exc = pack_rows_native(
                            buf, starts, ends_, B, L, amap, True, bits,
                            _AMAP2_ACGT)
                        if miss and self.host is not None:
                            self._extend_alpha(present_chars(buf))
                            amap = self._stage_amap
                            continue
                        if bits == 2 and exc is None:  # exception overflow
                            bits = fall
                            continue
                        break
                else:
                    rev = _pack_rows(buf, offs, sel, B, L, reverse=True)
                    revm = (self._rank_for_stage(rev)
                            if self.host is not None else rev)
                    bits = (4 if self.host is not None
                            and len(self._stage_alpha) <= 16 else 8)
                    if bits == 4:
                        revm = _nibble_pack(revm)
                ctab = None
                ranks2 = None
                if self.host is not None:
                    ctab = self.host.table_for_alphabet(self._stage_alpha)
                    if self.mesh is not None:
                        from ..parallel.mesh import replicate_index
                        ctab = replicate_index(ctab, self.mesh)
                    am = self._stage_amap
                    ranks2 = tuple(int(am[c]) for c in b"ACGT")
                g = {"long": False, "L": L, "idxs": sel, "lens": lens,
                     "ctab": ctab, "bits": bits, "ranks2": ranks2,
                     "alpha": self._stage_alpha,
                     "revm_d": self._put2(revm),
                     "exc_d": self._stage_exc(exc, B) if bits == 2 else None,
                     "lens_d": self._put1(lens)}
                if want_fwd_raw:
                    if use_native:
                        fmat, _, fexc = pack_rows_native(
                            buf, starts, ends_, B, L,
                            amap if bits == 4 else _IDENT_AMAP, False, bits,
                            _AMAP2_ACGT)
                        if bits == 2:
                            g["fexc_d"] = self._stage_exc(fexc, B)
                    else:
                        fmat = _pack_rows(buf, offs, sel, B, L)
                        if bits == 4:
                            fmat = _nibble_pack(self._stage_amap[fmat])
                    g["fwdc_d" if bits == 4 else "fwd_d"] = self._put2(fmat)
                groups.append(g)
        return groups

    @staticmethod
    def _stage_exc(exc, B: int):
        """Device triple (rows, cols, vals) for the 2-bit exception list,
        padded to a power-of-two length with out-of-range rows (B) that the
        scatter drops — stable shapes keep the unpack kernel cached."""
        import jax

        k = 0 if exc is None else len(exc)
        cap = max(16, 1 << max(0, (k - 1)).bit_length())
        rows = np.full(cap, B, np.int32)
        cols = np.zeros(cap, np.int32)
        vals = np.zeros(cap, np.int32)
        if k:
            rows[:k] = exc[:, 0]
            cols[:k] = exc[:, 1]
            vals[:k] = exc[:, 2]
        return (jax.device_put(jnp.asarray(rows)),
                jax.device_put(jnp.asarray(cols)),
                jax.device_put(jnp.asarray(vals)))

    def _rev_d(self, g):
        """Device [B, L] rank-mapped reversed rows for a staged group."""
        if g["bits"] == 2:
            return _unpack2(g["revm_d"], g["ranks2"], *g["exc_d"])
        if g["bits"] == 4:
            return _unpack4(g["revm_d"])
        return g["revm_d"]

    def _fwd_d(self, g):
        """Device [B, L] RAW natural-order rows (MS extension input)."""
        if g["bits"] == 2:
            return _unpack2(g["fwd_d"], (65, 67, 71, 84), *g["fexc_d"])
        if g["bits"] == 4:
            return _decode_alpha(_unpack4(g["fwdc_d"]), g["alpha"])
        return g["fwd_d"]

    def _put2(self, a):
        """Batch [B, L] placement: 'data'-sharded rows under a mesh."""
        import jax

        if self.mesh is None:
            return jax.device_put(jnp.asarray(a))
        from jax.sharding import NamedSharding, PartitionSpec as P
        return jax.device_put(jnp.asarray(a),
                              NamedSharding(self.mesh, P("data", None)))

    def _put1(self, a):
        import jax

        if self.mesh is None:
            return jax.device_put(jnp.asarray(a))
        from jax.sharding import NamedSharding, PartitionSpec as P
        return jax.device_put(jnp.asarray(a),
                              NamedSharding(self.mesh, P("data")))

    def classify_staged(self, staged, bin_width: int, max_value_thr: int):
        """classify() over staged groups (device-resident inputs): per-read
        (found, above, below, sum_maxes) in the original batch order."""
        from ..classify import binmax
        from ..parallel.mesh import fused_classify_kernel

        assert not self.use_doc, "report-only classification is doc-free"
        n = sum(len(g["idxs"]) for g in staged)
        out = {"found": np.zeros(n, dtype=bool),
               "above": np.zeros(n, dtype=np.int64),
               "below": np.zeros(n, dtype=np.int64),
               "sum_maxes": np.zeros(n, dtype=np.int64)}
        for g in staged:
            if g["long"]:
                res = self._query_group(g["reads"], g["L"])
                for j, i in enumerate(g["idxs"]):
                    r_ = binmax.classify(res["lengths"][j], bin_width,
                                         max_value_thr)
                    out["found"][i] = r_.status == "FOUND"
                    out["above"][i] = r_.bins_above
                    out["below"][i] = r_.bins_below
                    out["sum_maxes"][i] = int(r_.bin_maxes.sum())
                continue
            nsel = len(g["idxs"])
            if self.mode == "pml":
                f, a, b, s = fused_classify_kernel(
                    self.arrays, self._rev_d(g), g["lens_d"], max_value_thr,
                    self.meta, "pml", self.r, bin_width, g["ctab"])
                f, a, b, s = (np.asarray(f), np.asarray(a), np.asarray(b),
                              np.asarray(s))
            else:
                f, a, b, s = self._classify_ms_dev(
                    g, g["L"], bin_width, max_value_thr)
            out["found"][g["idxs"]] = f[:nsel]
            out["above"][g["idxs"]] = a[:nsel]
            out["below"][g["idxs"]] = b[:nsel]
            out["sum_maxes"][g["idxs"]] = s[:nsel]
        return out

    def _scan_ptrs_dev(self, rev_d, ctab, use_doc=False):
        if self.bits:
            if self.mode == "ms" or use_doc:
                vals, docs = query_batch_kernel_v4ms(
                    self.arrays, rev_d, self.meta, self.mode, use_doc,
                    ctab)[:2]
                return vals, docs
            vals, _ = query_batch_kernel_v4(self.arrays, rev_d, self.meta,
                                            ctab)
            return vals, None
        if self.occ:
            return query_batch_kernel_v3(self.arrays, rev_d, self.meta,
                                         self.mode, use_doc, ctab)
        if self.layered:
            return query_batch_kernel_v2(self.arrays, rev_d, self.meta,
                                         self.mode, use_doc, ctab)
        return query_batch_kernel(self.arrays, rev_d, self.meta, self.mode,
                                  use_doc, self.r)

    def _ensure_text_words(self):
        """Lazily builds the MS-extension text table. Production uses the
        tile-exact rows512 layout (build_text_rows512 + text_two_gather):
        the overlapped build_text_words/_wide tables hold 2.125x the text
        bytes, rows512 exactly the text (see build_text_rows512)."""
        if self._text_words is None:
            self._text_words = build_text_rows512(self.arrays.text, self.nt)
            self._text_wide = None
            self._text_two_gather = True
            if self.mesh is not None:
                from ..parallel.mesh import replicate_index
                self._text_words = replicate_index(self._text_words,
                                                   self.mesh)

    def _classify_ms_dev(self, g, L, bin_width, thr):
        """MS classify for one staged group: scan -> on-device extension ->
        on-device bin-max (mirror of _classify_group's MS block with the
        fwd rows already device-resident)."""
        if self.arrays.text is None:
            raise ValueError("MS classification requires an index with text")
        rev_d = self._rev_d(g)
        fwd_d = self._fwd_d(g)
        ptrs_rev = self._scan_ptrs_dev(rev_d, g["ctab"])[0]
        dt = ptrs_rev.dtype
        lens_dt = g["lens_d"].astype(dt)
        ptrs_fwd_d = _flip_rows(ptrs_rev, lens_dt)
        self._ensure_text_words()
        lens_mat = extend_pointers_sweep(
            self._text_words, fwd_d, lens_dt, ptrs_fwd_d, self.nt,
            self._text_wide, text_two_gather=self._text_two_gather)
        max_bins = max(1, -(-L // bin_width))
        found, above, below, summ = binmax_values_kernel(
            lens_mat, lens_dt, thr, bin_width, max_bins)
        found, above, below, summ = (np.array(found), np.array(above),
                                     np.array(below), np.array(summ))
        anom = np.nonzero(np.asarray(
            _anomalous_mask(ptrs_fwd_d, lens_dt))[:len(g["idxs"])])[0]
        if len(anom):
            sel = jnp.asarray(anom.astype(np.int32))
            sub_mat = extend_pointers_kernel(
                self.arrays.text, jnp.take(fwd_d, sel, axis=0),
                jnp.take(lens_dt, sel), jnp.take(ptrs_fwd_d, sel, axis=0),
                self.nt)
            f2, a2, b2, s2 = binmax_values_kernel(
                sub_mat, jnp.take(lens_dt, sel), thr, bin_width, max_bins)
            found[anom] = np.asarray(f2)
            above[anom] = np.asarray(a2)
            below[anom] = np.asarray(b2)
            summ[anom] = np.asarray(s2)
        return found, above, below, summ

    def query_staged(self, staged):
        """query() over staged groups: per-read value arrays in the original
        batch order."""
        n = sum(len(g["idxs"]) for g in staged)
        fields = {"pml": ["lengths"], "ms": ["pointers", "lengths"]}[self.mode]
        if self.mode == "ms" and self.arrays.text is None:
            fields = ["pointers"]
        if self.use_doc:
            fields = fields + ["docs"]
        out = {f: [None] * n for f in fields}
        for g in staged:
            if g["long"]:
                res = self._query_group(g["reads"], g["L"])
                for f in fields:
                    for j, i in enumerate(g["idxs"]):
                        out[f][i] = res[f][j]
                continue
            res = self._query_group_dev(g)
            for f in fields:
                for j, i in enumerate(g["idxs"]):
                    out[f][i] = res[f][j]
        return out

    def _query_group_dev(self, g):
        """Value-mode kernels for one staged (device-resident) group."""
        L = g["L"]
        lens = g["lens"]
        nsel = len(g["idxs"])
        rev_d = self._rev_d(g)
        vals, docs = self._scan_ptrs_dev(rev_d, g["ctab"],
                                         self.use_doc)[:2]
        vals_np = self._fetch(vals, L)
        out = {}
        unrev = lambda mat: [mat[i, :lens[i]][::-1].copy()
                             for i in range(nsel)]
        if self.mode == "pml":
            out["lengths"] = unrev(vals_np)
        else:
            out["pointers"] = unrev(vals_np)
            if self.arrays.text is not None:
                dt = vals.dtype
                lens_dt = g["lens_d"].astype(dt)
                fwd_d = self._fwd_d(g)
                ptrs_fwd_d = _flip_rows(vals, lens_dt)
                self._ensure_text_words()
                lens_mat = np.array(extend_pointers_sweep(
                    self._text_words, fwd_d, lens_dt, ptrs_fwd_d,
                    self.nt, self._text_wide,
                    text_two_gather=self._text_two_gather))
                anom = np.nonzero(np.asarray(
                    _anomalous_mask(ptrs_fwd_d, lens_dt))[:nsel])[0]
                if len(anom):
                    sel = jnp.asarray(anom.astype(np.int32))
                    sub = np.asarray(extend_pointers_kernel(
                        self.arrays.text, jnp.take(fwd_d, sel, axis=0),
                        jnp.take(lens_dt, sel),
                        jnp.take(ptrs_fwd_d, sel, axis=0), self.nt))
                    for j, i in enumerate(anom):
                        lens_mat[i] = sub[j]
                out["lengths"] = [lens_mat[i, :lens[i]].copy()
                                  for i in range(nsel)]
        if self.use_doc:
            out["docs"] = unrev(np.asarray(docs))
        return out


def _nibble_pack(m: np.ndarray) -> np.ndarray:
    """[B, L] u8 codes < 16 -> [B, L/2] packed nibbles (lo nibble first)."""
    return (m[:, 0::2] | (m[:, 1::2] << 4)).astype(np.uint8)


def _seg_expand(vals: np.ndarray, lens: np.ndarray,
                total: int) -> np.ndarray:
    """np.repeat(vals, lens) for large outputs, as a difference scatter +
    cumsum: this numpy's np.repeat runs ~50x slower than memory bandwidth
    past ~1e7 elements (6.5 s for a 67M-element repeat). Zero-length
    segments collide on the same scatter position; add.at accumulates
    their deltas so the cumsum skips them correctly."""
    out = np.zeros(total, np.int64)
    if len(vals) == 0 or total == 0:
        return out
    v = vals.astype(np.int64)
    dv = np.empty(len(v), np.int64)
    dv[0] = v[0]
    dv[1:] = v[1:] - v[:-1]
    seg = np.cumsum(lens) - lens
    np.add.at(out, seg[seg < total], dv[seg < total])
    return np.cumsum(out)


def _pack_rows(buf: np.ndarray, offs: np.ndarray, sel: np.ndarray,
               B: int, L: int, reverse: bool = False) -> np.ndarray:
    """[B, L] left-aligned padded rows for the selected reads of a CSR
    batch — whole-array gathers, no per-read Python. With reverse=True the
    rows come out REVERSED (the scan kernels' input order) at the same
    cost: the reversal folds into the gather index arithmetic, so no
    device-side flip (a per-element gather) and no
    second host pass is ever needed. Uniform-length selections (the common
    bucketed case) take one 2-D fancy gather; mixed lengths use a CSR
    scatter."""
    mat = np.zeros((B, L), np.uint8)
    if len(sel) == 0:
        return mat
    starts = offs[sel]
    lens = offs[sel + 1] - starts
    l0 = int(lens[0])
    if l0 and (lens == l0).all():
        cols = np.arange(l0 - 1, -1, -1) if reverse else np.arange(l0)
        pos = starts[:, None] + cols
        mat[:len(sel), :l0] = buf[pos]
        return mat
    total = int(lens.sum())
    row = _seg_expand(np.arange(len(sel)), lens, total)
    first = _seg_expand(np.cumsum(lens) - lens, lens, total)
    col = np.arange(total) - first
    if reverse:
        src = _seg_expand(starts + lens - 1, lens, total) - col
    else:
        src = _seg_expand(starts, lens, total) + col
    mat[row, col] = buf[src]
    return mat
