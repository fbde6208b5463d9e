"""Occ-block engine — engine v3: ONE row gather per recurrence step.

The layered engine (v2) needs 3 HBM row gathers per step (2 search levels +
1 field row). This engine restructures the index so a step costs a single
gather, exploiting two facts:

1. rank(pos, c) — the only per-step quantity the LF mapping needs
   (compute_ms_pml.cpp:180-187) — is computable from a classic FM-index
   occ-checkpoint block: per 128 BWT positions store, per character,
   F[c] + occ(c, block_start) plus the block's characters (4-bit packed).
   One row then yields bwt[pos] (the match test of compute_ms_pml.cpp:250)
   AND F[c] + rank(pos, c) via an in-register popcount-style reduction.

2. The threshold-guided jump (compute_ms_pml.cpp:253-277) needs the
   threshold of the run containing the NEXT c-occurrence at/after pos —
   i.e. of the run containing occurrence rank(pos,c) of c. Index that value
   by p' = F[c] + rank(pos,c): thrv[p'] = threshold of the run containing
   occurrence (p' - F[c]) of c. p' is exactly the candidate position the
   step is about to move to — so the threshold lives in the SAME block row
   the NEXT step gathers anyway. The jump decision is therefore *deferred
   one step*: each step carries the unresolved candidate (cand = F + rank,
   minus 1 iff jump-up) and resolves it at the start of the next step from
   the row it gathers for its own work.

   The jump-up candidate cand-1 may fall in the previous block when
   cand % 128 == 0; each row therefore also stores the previous block's
   last character ("prevchar"), from which occ/bwt at position
   block_start - 1 are derived without a second gather.

MS mode (compute_ms_pml.cpp:570-623) carries an SA sample instead: the
jump-down sample is samples_start of the run of occurrence rank — indexed by
p' like the threshold — and the jump-up sample is samples_last of the run of
occurrence rank-1, stored SHIFTED by one entry so both live at offset
cand % 128 of the same row. Document ids (compute_ms_pml.cpp:288-340,625-682)
use the same two layouts. Because those values resolve one step late, MS/doc
emissions lag one scan iteration; kernels append one sentinel iteration and
the host realigns (PML lengths resolve in-step and do not lag).

Memory is O(n) int32 words (~5 bytes/base for PML) versus v2's O(r) — the
right trade when n fits HBM comfortably; `eligible()` gates selection.
Row count n/128 stays under the 2^17-row ROW_CLIFF for n <= 16.7M (see
layered.py GATHER_ROW_CLIFF); larger references use engine v2.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_P = 128
MAX_SIGMA = 15          # 4-bit char packing; rank 15 = block padding
ROW_CLIFF = 1 << 17


class OccArrays(NamedTuple):
    blocks: jnp.ndarray            # [nb, W] i32 rows (see layout in build)
    text: Optional[jnp.ndarray]    # [nt] u8 (MS extension)
    n: jnp.ndarray
    last_run_sample: jnp.ndarray
    last_run_edoc: jnp.ndarray
    first_run_sdoc: jnp.ndarray


class OccMeta(NamedTuple):
    P: int                  # positions per block
    width: int              # row width (i32 words)
    sigma: int              # index alphabet size (build ranks 0..sigma-1)
    dtype: str
    has_samples: bool
    has_doc: bool
    has_text: bool


def eligible(idx, max_n: int = DEFAULT_P * ROW_CLIFF) -> bool:
    """True when the occ-block layout applies: alphabet fits 4-bit packing
    and the block count stays under the gather row-count cliff."""
    sigma = int(np.count_nonzero(np.asarray(idx.cnt)))
    return sigma <= MAX_SIGMA and int(idx.n) <= max_n


def build_occblock(idx, want_samples=None, want_doc=None, want_text=None,
                   P: int = DEFAULT_P):
    """DenseIndex -> (OccArrays on device, OccMeta, OccHost)."""
    if want_samples is None:
        want_samples = idx.c_ssamp is not None
    if want_doc is None:
        want_doc = idx.c_sdoc is not None
    if want_text is None:
        want_text = idx.text is not None
    assert P & (P - 1) == 0

    n = int(idx.n)
    assert n < 2**31, "occ-block engine is int32-only (use engine v2)"
    cnt = np.asarray(idx.cnt, dtype=np.int64)
    F = np.asarray(idx.F, dtype=np.int64)
    index_chars = np.nonzero(cnt)[0]
    sigma = len(index_chars)
    assert sigma <= MAX_SIGMA, "alphabet too large for 4-bit blocks"

    rmap = np.full(256, MAX_SIGMA, dtype=np.uint8)
    rmap[index_chars] = np.arange(sigma, dtype=np.uint8)

    run_heads = np.asarray(idx.run_heads, dtype=np.uint8)
    run_starts = np.asarray(idx.run_starts, dtype=np.int64)
    run_len_rm = np.diff(np.concatenate([run_starts, [n]]))
    bwt = rmap[np.repeat(run_heads, run_len_rm)]           # [n] build ranks

    # block count covers F-space index n inclusive: a forced jump-up from the
    # last occurrence of the largest character carries cand = F[c] + cnt = n,
    # whose (shifted) esamp/edoc entry lives at index n
    nb = -(-(n + 1) // P)
    pad = nb * P - n
    if pad:
        bwt = np.concatenate([bwt, np.full(pad, MAX_SIGMA, dtype=np.uint8)])

    # occ checkpoints in F-space: cp[b][rank] = F[char] + occ(char, b*P)
    blocks2d = bwt.reshape(nb, P)
    bc = np.zeros((nb, 16), dtype=np.int64)
    for rk in range(sigma):
        bc[:, rk] = (blocks2d == rk).sum(axis=1)
    occ_at = np.zeros((nb, 16), dtype=np.int64)
    occ_at[1:] = np.cumsum(bc, axis=0)[:-1]
    cp = occ_at
    cp[:, :sigma] += F[index_chars][None, :]

    # prevchar + chars, 4-bit packed into 17 i32 words (nibble 0 = prevchar)
    prevchar = np.full(nb, MAX_SIGMA, dtype=np.uint8)
    prevchar[1:] = blocks2d[:-1, -1]
    nwords = -(-(P + 1) // 8)
    nib = np.full((nb, nwords * 8), MAX_SIGMA, dtype=np.uint32)
    nib[:, 0] = prevchar
    nib[:, 1:P + 1] = blocks2d
    words = np.zeros((nb, nwords), dtype=np.uint32)
    for j in range(8):
        words += nib[:, j::8].astype(np.uint32) << (4 * j)
    words = words.view(np.int32).astype(np.int64)

    # per-occurrence tables in F-space. The char-grouped run arrays
    # concatenate in exactly (char ascending, BWT order) = F-space order,
    # so one np.repeat lays each table out correctly.
    c_len = np.asarray(idx.c_len, dtype=np.int64)
    padv = lambda a: np.concatenate(
        [a, np.zeros(nb * P - len(a), dtype=np.int64)])
    per_occ = [padv(np.repeat(np.asarray(idx.c_thr, np.int64), c_len))]
    if want_samples:
        ssamp = np.repeat(np.asarray(idx.c_ssamp, np.int64), c_len)
        esamp = np.repeat(np.asarray(idx.c_esamp, np.int64), c_len)
        per_occ.append(padv(ssamp))
        # jump-up reads samples_last of the run of occurrence rank-1: store
        # shifted (length n+1, the forced jump-up from the last occurrence
        # probes index n) so offset cand%P addresses it in the same row
        per_occ.append(padv(np.concatenate([[0], esamp])))
    if want_doc:
        sdoc = np.repeat(np.asarray(idx.c_sdoc, np.int64), c_len)
        edoc = np.repeat(np.asarray(idx.c_edoc, np.int64), c_len)
        per_occ.append(padv(sdoc))
        per_occ.append(padv(np.concatenate([[0], edoc])))

    rows = np.concatenate(
        [cp, words] + [a.reshape(nb, P) for a in per_occ], axis=1)
    W = rows.shape[1]

    text = None
    if want_text and idx.text is not None:
        t_ = np.asarray(idx.text, dtype=np.uint8)
        tp = max(1, 1 << (len(t_) - 1).bit_length())
        if tp != len(t_):
            t_ = np.concatenate([t_, np.zeros(tp - len(t_), dtype=np.uint8)])
        text = jnp.asarray(t_)

    arrays = OccArrays(
        blocks=jnp.asarray(rows.astype(np.int32)),
        text=text,
        n=jnp.asarray(np.asarray(n, dtype=np.int32)),
        last_run_sample=jnp.asarray(
            np.asarray(idx.last_run_sample, dtype=np.int32)),
        last_run_edoc=jnp.asarray(np.asarray(idx.last_run_edoc, np.int32)),
        first_run_sdoc=jnp.asarray(np.asarray(idx.first_run_sdoc, np.int32)),
    )
    meta = OccMeta(P=P, width=W, sigma=sigma, dtype="int32",
                   has_samples=bool(want_samples), has_doc=bool(want_doc),
                   has_text=text is not None)
    host = OccHost(F_all=F, cnt_all=cnt, rmap=rmap,
                   F_sigma=F[index_chars],
                   Fnext_sigma=F[index_chars] + cnt[index_chars],
                   index_chars=tuple(int(c) for c in index_chars))
    return arrays, meta, host


class OccHost:
    """Host companion: per-batch query-rank mapping + the per-char constant
    table gathered once per step by the occ-block and block-bits engines."""

    COLS = 5  # c_blk, empty, Fb, Fnext, run_base

    def __init__(self, F_all, cnt_all, rmap, F_sigma, Fnext_sigma,
                 index_chars, runbase_sigma=None):
        self.F_all = F_all
        self.cnt_all = cnt_all
        self.rmap = rmap
        self.F_sigma = F_sigma
        self.Fnext_sigma = Fnext_sigma
        self.index_chars = index_chars
        # col 4: char_off[char of code rk] — the char-grouped run-table base
        # used by the v4-MS jump indexing (0 when the engine doesn't need it)
        self.runbase_sigma = runbase_sigma
        self._table_cache = {}

    def table_for_alphabet(self, alphabet: tuple):
        """Device [sigma_pad, COLS] int64 per-char constants, row i for the
        query rank of alphabet[i]. Rows pad to a multiple of 16 so batches
        with slightly different alphabets share one compiled step."""
        if alphabet in self._table_cache:
            return self._table_cache[alphabet]
        sigma_q = len(alphabet)
        sq = max(16, -(-sigma_q // 16) * 16)
        mat = np.zeros((sq, self.COLS), dtype=np.int64)
        for i, byte in enumerate(alphabet):
            rk = int(self.rmap[byte])
            mat[i, 0] = rk
            mat[i, 1] = 1 if self.cnt_all[byte] == 0 else 0
            mat[i, 2] = self.F_all[byte]
            mat[i, 3] = 0 if rk == MAX_SIGMA else self.Fnext_sigma[rk]
            if self.runbase_sigma is not None and rk < len(self.runbase_sigma):
                mat[i, 4] = self.runbase_sigma[rk]
        ctab = jnp.asarray(mat)
        self._table_cache[alphabet] = ctab
        return ctab

    def rank_map(self, alphabet: tuple) -> np.ndarray:
        amap = np.zeros(256, dtype=np.uint8)
        for i, c in enumerate(alphabet):
            amap[c] = i
        return amap


def _sel(mat, idx, K, dt):
    """mat[B, K] -> mat[b, idx[b]] via masked sum (in-register select)."""
    sel = jnp.arange(K, dtype=dt)[None, :] == idx[:, None]
    return jnp.sum(jnp.where(sel, mat, 0), axis=1).astype(dt)


def occ_initial_state(ix: OccArrays, B: int):
    dt = jnp.int32
    f = lambda v: jnp.full((B,), v, dtype=dt)
    b = lambda: jnp.zeros((B,), dtype=bool)
    return (f(ix.n - 1),                    # cand (resolves to n-1)
            jnp.zeros((B,), dtype=dt),      # prev_p
            b(), b(),                       # pending, forced
            jnp.zeros((B,), dtype=dt),      # length
            f(ix.last_run_sample) + 1,      # sample_prev (was_match seeds -1)
            jnp.ones((B,), dtype=bool),     # was_match
            b(),                            # was_empty
            f(ix.last_run_edoc))            # doc_prev


def make_occ_step_fn(meta: OccMeta, mode: str, use_doc: bool):
    """One pipelined backward step. carry: see occ_initial_state. Emits
    (val, doc): val = PML length (in-step) or MS sample (lagged one
    iteration); doc lags one iteration. chars must be QUERY-rank mapped;
    `ctab` is OccHost.table_for_alphabet's table."""
    ms = mode == "ms"
    P = meta.P
    logP = int(math.log2(P))
    nwords = -(-(P + 1) // 8)
    NIB = nwords * 8
    C0, W0, T0 = 0, 16, 16 + nwords
    S0 = T0 + P
    E0 = S0 + P
    D0 = T0 + P + (2 * P if meta.has_samples else 0)

    def step(ix: OccArrays, carry, qc, ctab):
        (cand, prev_p, pending, forced, length,
         sample_prev, was_match, was_empty, doc_prev) = carry
        dt = cand.dtype
        B = cand.shape[0]

        # per-char constants: one gather from the [sigma_pad, COLS] table
        # (query ranks are < sigma_pad by construction)
        acc = ctab[qc.astype(jnp.int32)].astype(dt)
        c_blk, empty_i, Fb, Fnext = acc[:, 0], acc[:, 1], acc[:, 2], acc[:, 3]
        empty = empty_i == 1

        # THE gather: block row of the unresolved candidate
        nb = ix.blocks.shape[0]
        row = ix.blocks[jnp.clip(cand >> logP, 0, nb - 1)]    # [B, W]
        off = cand & (P - 1)

        # resolve the previous step's jump direction from thrv[cand % P]
        thr = _sel(row[:, T0:T0 + P], off, P, dt)
        minus1 = forced | (pending & (prev_p < thr))
        p = cand - minus1.astype(dt)
        pos_off = off - minus1.astype(dt)                     # in [-1, P-1]

        # resolve the lagged MS sample / doc id for the previous step
        if ms:
            ssamp = _sel(row[:, S0:S0 + P], off, P, dt)
            esamp = _sel(row[:, E0:E0 + P], off, P, dt)
            s = jnp.where(was_match, sample_prev - 1,
                jnp.where(was_empty, 0,
                jnp.where(minus1, esamp, ssamp)))
        else:
            s = sample_prev
        if use_doc:
            sdoc = _sel(row[:, D0:D0 + P], off, P, dt)
            edoc = _sel(row[:, D0 + P:D0 + 2 * P], off, P, dt)
            jumped = jnp.where(minus1, edoc, sdoc)
            if ms:
                # compute_ms_pml.cpp:639-643: empty char resets to run 0's doc
                d = jnp.where(was_empty, ix.first_run_sdoc,
                    jnp.where(was_match, doc_prev, jumped))
            else:
                # compute_ms_pml.cpp:288-340: empty char keeps the current doc
                d = jnp.where(was_empty | was_match, doc_prev, jumped)
        else:
            d = doc_prev

        # process this step's char from resolved position p (same row):
        # unpack nibbles; nibble 0 is prevchar = bwt[block_start - 1]
        nibs = ((row[:, W0:W0 + nwords, None]
                 >> (4 * jnp.arange(8, dtype=dt))[None, None, :]) & 15
                ).reshape(B, NIB)
        g = jnp.arange(NIB, dtype=dt)[None, :]
        is_c = nibs == c_blk[:, None]
        inblock = jnp.sum(
            jnp.where((g >= 1) & (g - 1 < pos_off[:, None]) & is_c, 1, 0),
            axis=1).astype(dt)
        inblock = inblock - ((pos_off < 0) & (nibs[:, 0] == c_blk)).astype(dt)
        bwt_p = _sel(nibs, pos_off + 1, NIB, dt)

        cp_sel = _sel(row[:, C0:C0 + 16], c_blk, 16, dt)
        A = cp_sel + inblock                                  # F[c] + rank
        is_match = ~empty & (bwt_p == c_blk)
        has_next = A < Fnext
        new_pending = ~empty & ~is_match & has_next
        new_forced = ~empty & ~is_match & ~has_next
        new_length = jnp.where(is_match, length + 1, 0)
        new_cand = jnp.where(empty, Fb, A)

        emit = (s if ms else new_length, d)
        return (new_cand, p, new_pending, new_forced, new_length,
                s, is_match, empty, d), emit

    return step
