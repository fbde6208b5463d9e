"""Block-bits engine — engine v4: ONE slim row gather per PML step.

Engine v3 (occblock.py) already reached one gather per step, but its rows
carry per-occurrence threshold VALUES (P i32 words — 512 B of the 644 B row)
and the threshold test forces a one-step deferred "candidate" pipeline: wide
rows to gather and [B, P]-wide selects over the fat row.

This engine removes both costs with one observation about the PML recurrence
(/root/reference/src/compute_ms_pml.cpp:237-286): the threshold only ever
feeds the single comparison `pos < thr`, where thr is the threshold of the
run containing the NEXT c-occurrence at/after pos. That predicate is a pure
function of (c, pos) — so it is precomputed at build time as ONE BIT per
(character, position). The absolute select() positions are never needed for
PML at all, because the LF of every outcome collapses to arithmetic:

    match      -> new_pos = F[c] + rank(pos, c)          (length + 1)
    jump down  -> new_pos = F[c] + rank(pos, c)          (length = 0)
    jump up    -> new_pos = F[c] + rank(pos, c) - 1      (length = 0)

(rank(j, c) at j = select(k, c) is k by definition, so LF(select(k,c), c)
= F[c] + k; the reference reaches the same values through select + rank,
compute_ms_pml.cpp:253-284.)

A step therefore needs only: bwt[pos], F[c] + rank(pos, c), `has_next`
(= F[c]+rank < F[c]+cnt), and the up/down bit — all of which fit in one
slim row per P BWT positions:

    cp slots      F-space occ checkpoints per packed char code
                  (cp[code] = F[char] + occ(char, block_start))
    char words    the block's characters, 2- or 4-bit codes
    bit words     up-bits: bit (c, pos) = pos < thr_next(c, pos)

In-block rank is computed WITHOUT unpacking the chars to [B, P] lanes: a
SWAR equality mask on the packed words (per code slot: all bits of the
code's group zero after xor) + `lax.population_count`, with the position
cutoff folded into the popcount mask — [B, P/16] element work instead of
[B, P].

Packing variants:
  * pack=4 — up to 8 distinct BWT characters, 4-bit codes.
  * pack=2 — up to 4 distinct characters + the BWT terminator (the DNA
    case). The terminator (exactly one occurrence, byte 1, coerced by the
    builder like ms_rle_string.hpp:66-68) aliases code 0 at its single
    position; the kernel corrects rank/match with three static-scalar
    comparisons, and terminator QUERIES (rank/match/threshold of a
    single-run character) are answered entirely from those scalars.

Per step: 1 row gather + ~15 [B, P/16] element-wise ops + the per-char
constant lookup. No deferral: the carry is just (pos, length).

MS jumps consume per-run SA samples (values, not predicates); the v4-MS
variant (make_blockbits_ms_step_fn) carries jump ids instead and rebuilds the
samples after the scan. Row count = ceil(n/P) and row width trade off
against each other; P is chosen per index size (pick_P).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .occblock import MAX_SIGMA, OccHost, ROW_CLIFF

MAX_SIGMA4 = 8   # pack=4: 8 cp slots
MAX_SIGMA2 = 4   # pack=2: 4 cp slots (+ aliased terminator)
TERM_BYTE = 1    # coerced BWT terminator (ms_rle_string.hpp:21,66-68)
TERM_CODE = 14   # query-rank code for "the terminator character"


class BitArrays(NamedTuple):
    bblocks: jnp.ndarray   # [nb, W] i32 rows (layout above)
    n: jnp.ndarray
    last_run_sample: jnp.ndarray   # carried for initial_state compat
    last_run_edoc: jnp.ndarray
    first_run_sdoc: jnp.ndarray
    text: Optional[jnp.ndarray] = None  # [nt] u8 (MS extension)
    # --- v4-MS side table (one INDEPENDENT gather riding next to THE
    # dependent row gather, so the two can overlap) ---
    msrows: Optional[jnp.ndarray] = None  # [nb, Wm] i32 (run-rank layout)
    # jump tables indexed by jidx (see make_blockbits_ms_step_fn):
    #   jump_t[2j] = c_ssamp[j], [2j+1] = c_esamp[j],
    #   [2r] = 0 (empty-char reset), [2r+1] = last_run_sample (seed)
    jump_t: Optional[jnp.ndarray] = None  # [2r+2] i32/i64 SA samples
    jump_d: Optional[jnp.ndarray] = None  # [2r+2] i32 doc ids (same layout)


class BitMeta(NamedTuple):
    P: int
    width: int
    sigma: int
    pack: int              # bits per stored char: 2 or 4
    dtype: str
    # pack=2 terminator scalars (baked into the jitted step: BitMeta is a
    # static jit argument)
    term_pos: int = -1
    term_code: int = 0
    F_term: int = 0
    has_samples: bool = False
    has_doc: bool = False
    has_text: bool = False
    # wide mode: n >= 2^31 (GRCh38 + revcomp needs ~6.2e9 positions). Lane
    # positions are int64; rows stay int32 with each occ checkpoint split
    # into a low u32 word (the C0 slots) plus one packed byte of high bits
    # (the H0 words) — n < 2^40, matching the reference's SSABYTES=5
    # (include/spumoni_main.hpp:60). In-row SWAR rank/char work remains
    # int32; only checkpoint arithmetic widens.
    wide: bool = False
    # sharded rows (TP): set when the step runs inside a shard_map whose
    # `tp_axis` mesh axis shards `bblocks` by rows — THE gather becomes an
    # owner-masked local gather + one [B, W] psum per step (cheap relative
    # to the layered TP path: v4 does exactly one probe). The escape hatch
    # for indexes past one device's memory (parallel/tp.py).
    tp_axis: Optional[str] = None
    # --- v4-MS fields ---
    has_ms: bool = False   # msrows + jump_t present (MS / doc tracking)
    ms_width: int = 0      # msrows row width (i32 words)
    r: int = 0             # run count (jidx slots: EMPTY = 2r, INIT = 2r+1)
    term_runidx: int = -1  # char-grouped run index of the terminator run


def _pack_of(idx) -> Optional[int]:
    cnt = np.asarray(idx.cnt)
    chars = np.nonzero(cnt)[0]
    real = [c for c in chars if c != TERM_BYTE]
    if len(real) <= MAX_SIGMA2 and cnt[TERM_BYTE] <= 1:
        return 2
    if len(chars) <= MAX_SIGMA4:
        return 4
    return None


def pick_P(n: int, pack: int, over_cliff: bool = False,
           wide: bool = False) -> Optional[int]:
    # fewer rows, one gather per step: prefer the largest P whose row stays
    # <= 256 B, falling back to <= 512 B rows, and keep the row count under
    # ROW_CLIFF (a gather cost step measured on the earlier target; whether
    # it holds on the GPU is ROADMAP design item 4)
    best = None
    for cap in (256, 512):
        for P in (64, 128, 256, 512):
            if -(-n // P) > ROW_CLIFF:
                continue
            if _width(P, pack, wide) * 4 > cap:
                continue
            best = P
        if best is not None:
            break
    if best is None and over_cliff:
        # past the cliff fewer, wider rows gathered faster than many narrow
        # ones on the earlier target: take the largest P whose row still
        # fits the 512 B cap the under-cliff selector honors (512 for
        # pack=2 = 400 B rows; 128 for pack=4 = 288 B rows).
        for P in (512, 256, 128, 64):
            if _width(P, pack, wide) * 4 <= 512:
                return P
    return best


def _width(P: int, pack: int, wide: bool = False) -> int:
    nslots = MAX_SIGMA2 if pack == 2 else MAX_SIGMA4
    nhw = -(-nslots // 4) if wide else 0   # packed checkpoint-high bytes
    if pack == 2:
        return nslots + P // 16 + nslots * (P // 32) + nhw
    return nslots + P // 8 + nslots * (P // 32) + nhw


def eligible(idx) -> bool:
    """Under-cliff eligibility: the row count stays under ROW_CLIFF."""
    pack = _pack_of(idx)
    return pack is not None and pick_P(int(idx.n), pack) is not None


def eligible_any(idx) -> bool:
    """Over-cliff included: one row gather per step against engine v2's
    multi-probe descent at human-genome scale. Past 2^31 positions the
    wide layout (split-checkpoint rows, int64 lanes) extends coverage to
    n < 2^40 — the reference's own SSABYTES=5
    addressing limit (include/spumoni_main.hpp:60)."""
    pack = _pack_of(idx)
    return pack is not None and int(idx.n) < 2**40


_BB_CACHE_VERSION = 1


def _bb_cache_key(idx, P: int, pack: int, wide: bool) -> np.ndarray:
    """Cheap content fingerprint: shape scalars + sampled run/threshold
    values. Strong enough to catch a changed index at the same path."""
    import hashlib

    r = int(idx.run_starts.shape[0])
    h = hashlib.sha256()
    for a in (idx.run_heads, idx.run_starts, idx.c_thr):
        s = np.ascontiguousarray(np.asarray(a)[:: max(1, r // 4096)])
        h.update(s.tobytes())
    dig = np.frombuffer(h.digest()[:16], dtype=np.int64)
    return np.concatenate([
        np.asarray([_BB_CACHE_VERSION, int(idx.n), r, P, pack, int(wide)],
                   dtype=np.int64), dig])


def _manifest_arrays(idx, src_path: Optional[str]) -> dict:
    """O(sigma) scalars stored alongside the cached rows so a later `run`
    can assemble the engine WITHOUT materializing the dense index npz
    (a PML report-only serve needs rows + F/cnt scalars + the null DB,
    not the multi-GB dense index). m_stat pins the
    source index file (size, mtime_ns) — a rebuilt index at the same path
    invalidates the fast start and falls back to the dense load, which
    re-verifies via the content key."""
    import os

    cnt = np.asarray(idx.cnt, dtype=np.int64)
    term_pos = -1
    if cnt[TERM_BYTE]:
        run_heads = np.asarray(idx.run_heads, dtype=np.uint8)
        run_starts = np.asarray(idx.run_starts, dtype=np.int64)
        term_pos = int(run_starts[np.nonzero(run_heads == TERM_BYTE)[0][0]])
    stat = np.asarray([-1, -1], dtype=np.int64)
    if src_path is not None:
        try:
            st = os.stat(src_path)
            stat = np.asarray([st.st_size, st.st_mtime_ns], dtype=np.int64)
        except OSError:
            pass
    return dict(
        m_stat=stat,
        m_cnt=cnt,
        m_F=np.asarray(idx.F, dtype=np.int64),
        m_char_off=np.asarray(idx.char_off, dtype=np.int64),
        m_scalars=np.asarray([int(idx.last_run_sample),
                              int(idx.first_run_sdoc),
                              int(idx.last_run_edoc), term_pos],
                             dtype=np.int64))


class _CacheShim:
    """Duck-typed stand-in for DenseIndex built from the cache manifest —
    exactly the fields _assemble_blockbits touches on the PML (no-MS,
    no-doc) path."""

    def __init__(self, d, n: int, r: int):
        self.n, self.r = n, r
        self.cnt = d["m_cnt"]
        self.F = d["m_F"]
        self.char_off = d["m_char_off"]
        lrs, frs, lre, term_pos = (int(x) for x in d["m_scalars"])
        self.last_run_sample = lrs
        self.first_run_sdoc = frs
        self.last_run_edoc = lre
        self.run_heads = np.asarray([TERM_BYTE], dtype=np.uint8)
        self.run_starts = np.asarray([max(term_pos, 0)], dtype=np.int64)
        self.c_ssamp = self.c_esamp = None
        self.c_sdoc = self.c_edoc = None
        self.text = None


def load_cached(cache_path: str, src_path: str, max_bytes=None):
    """Fast serving start: assemble the block-bits engine straight from the
    rows cache (written by a prior build_blockbits with src_path set),
    skipping the dense-index npz entirely. Returns (arrays, meta, host,
    n, r) or None when the cache is absent, pre-manifest, stale vs the
    index file's (size, mtime_ns), or larger than max_bytes (let the
    caller fall back to the dense path where auto-TP can engage).
    PML-only: MS/doc assembly needs the dense index's O(r) sample/doc
    tables and the text."""
    import os

    try:
        if not os.path.exists(cache_path):
            return None
        d = np.load(cache_path)
        if "m_stat" not in d.files:
            return None
        st = os.stat(src_path)
        m_stat = d["m_stat"]
        if int(m_stat[0]) != st.st_size or int(m_stat[1]) != st.st_mtime_ns:
            return None
        key = d["key"]
        version, n, r, P, pack, wide = (int(x) for x in key[:6])
        if version != _BB_CACHE_VERSION:
            return None
        nb = -(-n // P)
        if max_bytes is not None \
                and nb * _width(P, pack, bool(wide)) * 4 > max_bytes:
            return None
        shim = _CacheShim(d, n, r)
        arrays, meta, host = _assemble_blockbits(shim, d["rows"], P, pack,
                                                 bool(wide))
        return arrays, meta, host, n, r
    except Exception:
        return None


def build_blockbits(idx, P: Optional[int] = None, pack: Optional[int] = None,
                    wide: Optional[bool] = None,
                    cache_path: Optional[str] = None,
                    want_ms: bool = False, want_doc: bool = False,
                    ms_cache_path: Optional[str] = None,
                    src_path: Optional[str] = None):
    """DenseIndex -> (BitArrays on device, BitMeta, OccHost).

    wide=True (auto past 2^31 positions) switches to the split-checkpoint
    row layout + int64 lane positions; rows stay int32 either way.

    cache_path: optional .npz path for the packed rows — the row build is
    the expensive part (~8 min at 2 Gbp) and is deterministic in the index
    content, so `run` invocations after the first load it from disk (the
    reference's analog: the serialized .thrbv index IS its run-time form,
    thresholds_ds.hpp load).

    want_ms / want_doc: additionally build the v4-MS side structures
    (run-rank msrows + jump tables, see build docstring of
    make_blockbits_ms_step_fn) enabling MS queries and doc tracking on
    this engine. ms_cache_path caches the msrows like cache_path."""
    n = int(idx.n)
    if wide is None:
        wide = n >= 2**31
    assert wide or n < 2**31
    assert n < 2**40, "block-bits positions are 40-bit (SSABYTES=5 parity)"
    if pack is None:
        pack = _pack_of(idx)
        assert pack is not None, "alphabet too large for block-bits"
    if P is None:
        P = pick_P(n, pack, over_cliff=True, wide=wide)
        assert P is not None, "n too large for block-bits (use engine v2)"
    assert P % 32 == 0 and P & (P - 1) == 0
    if want_ms:
        assert idx.c_ssamp is not None, "MS needs an index with SA samples"
    if want_doc:
        assert idx.c_sdoc is not None, "doc tracking needs a doc-array index"

    import os

    cache_key = None
    rows_cached = None
    if cache_path is not None:
        cache_key = _bb_cache_key(idx, P, pack, wide)
        if os.path.exists(cache_path):
            try:
                d = np.load(cache_path)
                if (d["key"].shape == cache_key.shape
                        and (d["key"] == cache_key).all()):
                    rows_cached = d["rows"]
            except Exception:
                pass  # unreadable/stale cache: rebuild below
    if rows_cached is not None:
        if "m_stat" not in d.files and src_path is not None:
            # pre-manifest cache: rewrite with the manifest so the NEXT
            # run gets the fast start (rows are already in hand — cheap)
            tmp = f"{cache_path}.tmp{os.getpid()}.npz"  # pid-unique: concurrent
        # processes (multi-host runs) may race to write the same cache
            np.savez(tmp, key=cache_key, rows=rows_cached,
                     **_manifest_arrays(idx, src_path))
            os.replace(tmp, cache_path)
        msrows = _build_msrows(idx, P, pack, ms_cache_path, cache_key) \
            if (want_ms or want_doc) else None
        return _assemble_blockbits(idx, rows_cached, P, pack, wide,
                                   msrows=msrows, want_ms=want_ms,
                                   want_doc=want_doc)

    cnt = np.asarray(idx.cnt, dtype=np.int64)
    F = np.asarray(idx.F, dtype=np.int64)
    index_chars = np.nonzero(cnt)[0]
    nslots = MAX_SIGMA2 if pack == 2 else MAX_SIGMA4

    term_pos, term_code, F_term = -1, 0, 0
    if pack == 2:
        code_chars = np.asarray(
            [c for c in index_chars if c != TERM_BYTE], dtype=np.int64)
        assert len(code_chars) <= MAX_SIGMA2 and cnt[TERM_BYTE] <= 1
    else:
        code_chars = np.asarray(index_chars, dtype=np.int64)
        assert len(code_chars) <= MAX_SIGMA4
    sigma = len(index_chars)

    rmap = np.full(256, MAX_SIGMA, dtype=np.uint8)
    rmap[code_chars] = np.arange(len(code_chars), dtype=np.uint8)
    if pack == 2 and cnt[TERM_BYTE]:
        rmap[TERM_BYTE] = TERM_CODE

    run_heads = np.asarray(idx.run_heads, dtype=np.uint8)
    run_starts = np.asarray(idx.run_starts, dtype=np.int64)
    run_len_rm = np.diff(np.concatenate([run_starts, [n]]))
    bwt_bytes = np.repeat(run_heads, run_len_rm)            # [n] u8

    nb = -(-n // P)
    pad_code = 0
    if pack == 2 and cnt[TERM_BYTE]:
        # terminator position straight from the run table (its run has
        # length 1 since cnt[TERM_BYTE] == 1)
        term_pos = int(run_starts[np.nonzero(run_heads == TERM_BYTE)[0][0]])
        term_code = 0
        F_term = int(F[TERM_BYTE])
        # block padding + any non-code byte aliases a code; they are
        # excluded from rank by the true-count checkpoints only if absent —
        # assert the BWT has none besides the terminator (unique run heads
        # == unique BWT bytes; pad byte 0 is appended separately below)
        from ..utils import present_chars
        assert set(present_chars(run_heads).tolist()) <= (
            set(code_chars.tolist()) | {TERM_BYTE})
        pad_code = 3 if len(code_chars) < 4 else term_code
        # NOTE: pad positions are never gathered for rank at offsets < off
        # with pos < n, and pos <= n-1 always, so pad aliasing is inert
        # except inside the LAST block past offset (n-1)%P — unreachable.

    # Rows are assembled CHUNK-WISE (advisor round 2): the previous
    # whole-index build materialized several [n]-sized int64 temporaries
    # (~17 GB each at 2.1 Gbp) and a second int64 copy of the rows; blocks
    # of ~2^24 positions keep peak extra memory at ~300 MB regardless of n.
    per_word = 32 // pack
    nwcw = P // per_word
    wpc = P // 32
    W = _width(P, pack, wide)
    C0, W0, T0 = 0, nslots, nslots + nwcw
    H0 = T0 + nslots * wpc                 # wide: packed checkpoint-high bytes
    rows = np.zeros((nb, W), dtype=np.int32)
    # occ checkpoints carried in F-space: cp[b][k] = F[char_k] + occ(char_k,
    # b*P), accumulated across chunks
    occ_run = F[code_chars].astype(np.int64).copy()
    char_off = np.asarray(idx.char_off, dtype=np.int64)
    c_start = np.asarray(idx.c_start, dtype=np.int64)
    c_thr = np.asarray(idx.c_thr, dtype=np.int64)
    shifts32 = np.arange(32, dtype=np.uint32)
    CHUNK_ROWS = max(1, (1 << 24) // P)
    for r0 in range(0, nb, CHUNK_ROWS):
        r1 = min(r0 + CHUNK_ROWS, nb)
        rc = r1 - r0
        p0, p1 = r0 * P, r1 * P
        if p1 <= n:
            bb = bwt_bytes[p0:p1]
        else:
            bb = np.concatenate(
                [bwt_bytes[p0:n], np.zeros(p1 - n, dtype=np.uint8)])
        bb2 = bb.reshape(rc, P)

        # occ checkpoints from TRUE characters (alias-free)
        for k, ch in enumerate(code_chars):
            bc = (bb2 == ch).sum(axis=1, dtype=np.int64)
            csum = np.zeros(rc, dtype=np.int64)
            np.cumsum(bc[:-1], out=csum[1:])
            cp = occ_run[k] + csum
            if wide:
                rows[r0:r1, C0 + k] = (
                    cp & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
                rows[r0:r1, H0 + (k >> 2)] |= (
                    (cp >> 32).astype(np.uint32) << ((k & 3) * 8)
                ).view(np.int32)
            else:
                rows[r0:r1, C0 + k] = cp.astype(np.int32)
            occ_run[k] += int(bc.sum())

        # characters, pack-bit codes, little-endian within each i32 word
        cc = rmap[bb]
        if pack == 2 and term_pos >= 0:
            cc[bb == TERM_BYTE] = term_code                 # alias
            cc[bb == 0] = pad_code
        cc2 = cc.reshape(rc, P)
        words = np.zeros((rc, nwcw), dtype=np.uint32)
        for j in range(per_word):
            words += (cc2[:, j::per_word].astype(np.uint32)
                      & ((1 << pack) - 1)) << (pack * j)
        rows[r0:r1, W0:W0 + nwcw] = words.view(np.int32)

        # up-bits: bit (k, pos) = pos < threshold of the run containing the
        # next occurrence of code-char k at/after pos (the `pos < thr`
        # branch of compute_ms_pml.cpp:270-277). Positions past the last
        # run get 1 (don't-care: the kernel forces jump-up when has_next is
        # false).
        pos = np.arange(p0, p1, dtype=np.int64)
        for k, ch in enumerate(code_chars):
            lo, hi = char_off[ch], char_off[ch + 1]
            cs, th = c_start[lo:hi], c_thr[lo:hi]
            ridx = np.searchsorted(cs, pos, side="right")
            past = ridx >= len(cs)
            up = np.where(past, True,
                          pos < th[np.minimum(ridx, len(cs) - 1)])
            packed = (up.reshape(-1, 32).astype(np.uint32)
                      << shifts32[None, :]).sum(axis=1, dtype=np.uint32)
            rows[r0:r1, T0 + k * wpc:T0 + (k + 1) * wpc] = (
                packed.reshape(rc, wpc).view(np.int32))

    if cache_path is not None:
        tmp = f"{cache_path}.tmp{os.getpid()}.npz"  # pid-unique: concurrent
        # processes (multi-host runs) may race to write the same cache
        np.savez(tmp, key=cache_key, rows=rows,
                 **_manifest_arrays(idx, src_path))
        os.replace(tmp, cache_path)
    msrows = _build_msrows(idx, P, pack, ms_cache_path, cache_key) \
        if (want_ms or want_doc) else None
    return _assemble_blockbits(idx, rows, P, pack, wide, msrows=msrows,
                               want_ms=want_ms, want_doc=want_doc)


def _ms_width(P: int, pack: int) -> int:
    nslots = MAX_SIGMA2 if pack == 2 else MAX_SIGMA4
    return nslots * (1 + P // 32)


def _build_msrows(idx, P: int, pack: int,
                  cache_path: Optional[str] = None,
                  cache_key: Optional[np.ndarray] = None) -> np.ndarray:
    """[nb, Wm] i32 run-rank rows for the v4-MS step: per code slot k,
    one char-LOCAL run-rank checkpoint (count of code-char-k runs starting
    before the block) followed by P/32 words of RUN-START bits (bit (k,pos)
    = a run of code-char k starts at pos). In-block char-local run rank is
    then checkpoint + popcount(start bits below pos) — the same SWAR
    pattern as the main row's up-bits, one independent gather away."""
    import os

    n = int(idx.n)
    r = int(idx.r)
    assert r < 2**30, "v4-MS jump ids are int32 (2r+2 slots)"
    nslots = MAX_SIGMA2 if pack == 2 else MAX_SIGMA4
    wpc = P // 32
    Wm = _ms_width(P, pack)
    nb = -(-n // P)

    if cache_path is not None and cache_key is not None \
            and os.path.exists(cache_path):
        try:
            d = np.load(cache_path)
            if (d["key"].shape == cache_key.shape
                    and (d["key"] == cache_key).all()
                    and d["msrows"].shape == (nb, Wm)):
                return d["msrows"]
        except Exception:
            pass

    cnt = np.asarray(idx.cnt, dtype=np.int64)
    index_chars = np.nonzero(cnt)[0]
    if pack == 2:
        code_chars = [c for c in index_chars if c != TERM_BYTE]
    else:
        code_chars = list(index_chars)
    char_off = np.asarray(idx.char_off, dtype=np.int64)
    c_start = np.asarray(idx.c_start, dtype=np.int64)

    msrows = np.zeros((nb, Wm), dtype=np.uint32)
    block_starts = np.arange(nb, dtype=np.int64) * P
    for k, ch in enumerate(code_chars):
        cs = c_start[char_off[ch]:char_off[ch + 1]]
        msrows[:, k] = np.searchsorted(cs, block_starts,
                                       side="left").astype(np.uint32)
        logP = int(math.log2(P))
        blk = cs >> logP
        off = cs & (P - 1)
        np.bitwise_or.at(msrows, (blk, nslots + k * wpc + (off >> 5)),
                         (np.uint32(1) << (off & 31).astype(np.uint32)))
    msrows = msrows.view(np.int32)

    if cache_path is not None and cache_key is not None:
        tmp = f"{cache_path}.tmp{os.getpid()}.npz"  # pid-unique: concurrent
        # processes (multi-host runs) may race to write the same cache
        np.savez(tmp, key=cache_key, msrows=msrows)
        os.replace(tmp, cache_path)
    return msrows


def _assemble_blockbits(idx, rows: np.ndarray, P: int, pack: int, wide: bool,
                        msrows: Optional[np.ndarray] = None,
                        want_ms: bool = False, want_doc: bool = False):
    """Host rows (built or cache-loaded) -> (BitArrays on device, BitMeta,
    OccHost). Everything here is cheap (O(r) scalars), so the cache only
    stores the rows."""
    n = int(idx.n)
    r = int(idx.r)
    cnt = np.asarray(idx.cnt, dtype=np.int64)
    F = np.asarray(idx.F, dtype=np.int64)
    index_chars = np.nonzero(cnt)[0]
    if pack == 2:
        code_chars = np.asarray(
            [c for c in index_chars if c != TERM_BYTE], dtype=np.int64)
    else:
        code_chars = np.asarray(index_chars, dtype=np.int64)
    sigma = len(index_chars)
    W = _width(P, pack, wide)
    assert rows.shape == (-(-n // P), W), (rows.shape, n, P, W)

    rmap = np.full(256, MAX_SIGMA, dtype=np.uint8)
    rmap[code_chars] = np.arange(len(code_chars), dtype=np.uint8)
    term_pos, term_code, F_term = -1, 0, 0
    term_runidx = -1
    char_off = np.asarray(idx.char_off, dtype=np.int64)
    if pack == 2 and cnt[TERM_BYTE]:
        rmap[TERM_BYTE] = TERM_CODE
        run_heads = np.asarray(idx.run_heads, dtype=np.uint8)
        run_starts = np.asarray(idx.run_starts, dtype=np.int64)
        term_pos = int(run_starts[np.nonzero(run_heads == TERM_BYTE)[0][0]])
        F_term = int(F[TERM_BYTE])
        term_runidx = int(char_off[TERM_BYTE])

    pdt = np.int64 if wide else np.int32
    has_ms = msrows is not None
    jump_t = jump_d = None
    text = None
    if has_ms:
        assert msrows.shape == (-(-n // P), _ms_width(P, pack))
        if want_ms:
            sdt = np.int64 if wide else np.int32
            # padded to a 128 multiple: the reconstruction gathers [*, 128]
            # ROWS of this table (scan_engine._take_flat_rows)
            T = np.zeros(-(-(2 * r + 2) // 128) * 128, dtype=sdt)
            T[0:2 * r:2] = np.asarray(idx.c_ssamp, dtype=sdt)
            T[1:2 * r:2] = np.asarray(idx.c_esamp, dtype=sdt)
            T[2 * r + 1] = sdt(idx.last_run_sample)
            jump_t = jnp.asarray(T)
            if idx.text is not None:
                t_ = np.asarray(idx.text, dtype=np.uint8)
                tp = max(1, 1 << (len(t_) - 1).bit_length())
                if tp != len(t_):
                    t_ = np.concatenate(
                        [t_, np.zeros(tp - len(t_), dtype=np.uint8)])
                text = jax.device_put(t_)
        if want_doc:
            D = np.zeros(-(-(2 * r + 2) // 128) * 128, dtype=np.int32)
            D[0:2 * r:2] = np.asarray(idx.c_sdoc, dtype=np.int32)
            D[1:2 * r:2] = np.asarray(idx.c_edoc, dtype=np.int32)
            D[2 * r] = np.int32(idx.first_run_sdoc)   # MS empty-char reset
            D[2 * r + 1] = np.int32(idx.last_run_edoc)
            jump_d = jnp.asarray(D)
    arrays = BitArrays(
        bblocks=jax.device_put(rows),
        n=jnp.asarray(np.asarray(n, dtype=pdt)),
        last_run_sample=jnp.asarray(
            np.asarray(idx.last_run_sample, dtype=pdt)),
        last_run_edoc=jnp.asarray(np.asarray(idx.last_run_edoc, pdt)),
        first_run_sdoc=jnp.asarray(np.asarray(idx.first_run_sdoc, pdt)),
        text=text,
        msrows=jax.device_put(msrows) if has_ms else None,
        jump_t=jump_t, jump_d=jump_d,
    )
    meta = BitMeta(P=P, width=W, sigma=sigma, pack=pack,
                   dtype="int64" if wide else "int32",
                   term_pos=term_pos, term_code=term_code, F_term=F_term,
                   has_samples=want_ms, has_doc=want_doc,
                   has_text=text is not None, wide=wide,
                   has_ms=has_ms, ms_width=_ms_width(P, pack) if has_ms else 0,
                   r=r, term_runidx=term_runidx)
    # F/Fnext tables indexed by QUERY-RANK CODE (OccHost.table_for_alphabet
    # indexes Fnext_sigma[rmap[byte]]); slot TERM_CODE serves the terminator
    f_by_code = np.zeros(16, dtype=np.int64)
    fnext_by_code = np.zeros(16, dtype=np.int64)
    runbase_by_code = np.zeros(16, dtype=np.int64)
    for k, ch in enumerate(code_chars):
        f_by_code[k] = F[ch]
        fnext_by_code[k] = F[ch] + cnt[ch]
        runbase_by_code[k] = char_off[ch]
    if pack == 2 and cnt[TERM_BYTE]:
        f_by_code[TERM_CODE] = F_term
        fnext_by_code[TERM_CODE] = F_term + cnt[TERM_BYTE]
        runbase_by_code[TERM_CODE] = term_runidx
    host = OccHost(F_all=F, cnt_all=cnt, rmap=rmap,
                   F_sigma=f_by_code, Fnext_sigma=fnext_by_code,
                   index_chars=tuple(int(c) for c in index_chars),
                   runbase_sigma=runbase_by_code if has_ms else None)
    return arrays, meta, host


def _make_probe_fn(meta: BitMeta, need_ms: bool = False):
    """Shared per-step math of the block-bits engines: the per-char
    constants, THE dependent row gather, SWAR in-block rank, checkpoint /
    up-bit selects, terminator corrections, and the 3-way branch decision.
    Returns a dict of everything the PML and MS/doc steps consume.
    need_ms additionally gathers the msrows side row (v4-MS)."""
    P, pack, wide = meta.P, meta.pack, meta.wide
    logP = int(math.log2(P))
    nslots = MAX_SIGMA2 if pack == 2 else MAX_SIGMA4
    per_word = 32 // pack
    logW = int(math.log2(per_word))
    nwcw = P // per_word
    wpc = P // 32
    nhw = -(-nslots // 4) if wide else 0
    C0, W0, T0 = 0, nslots, nslots + nwcw
    H0 = T0 + nslots * wpc
    # SWAR constants: per-code-group LSB mask for this packing
    lsb = int(sum(1 << (pack * j) for j in range(per_word)))  # 0x111../0x555..

    def probe(ix: BitArrays, pos, qc, ctab):
        dt = pos.dtype                     # int32, or int64 in wide mode
        i32 = jnp.int32                    # in-row work always stays 32-bit

        # per-char constants: one gather from the [sigma_pad, 5] int64
        # table (40-bit F/Fnext in wide mode; query ranks < sigma_pad)
        acc = ctab[qc.astype(i32)].astype(dt)
        c_blk, empty_i, Fb, Fnext = acc[:, 0], acc[:, 1], acc[:, 2], acc[:, 3]
        empty = empty_i == 1
        rk = jnp.clip(c_blk, 0, nslots - 1).astype(i32)

        # THE gather
        nb_local = ix.bblocks.shape[0]
        blk = (pos >> logP).astype(i32)    # nb < 2^31 even in wide mode
        if meta.tp_axis is not None:
            # sharded rows: the owner shard gathers locally, others
            # contribute zeros; psum reassembles the row on every shard
            # (lanes stay replicated along tp, so carries never diverge)
            tpi = jax.lax.axis_index(meta.tp_axis).astype(i32)
            tp_size = jax.lax.psum(1, meta.tp_axis)
            nb = nb_local * tp_size
            blkc = jnp.clip(blk, 0, nb - 1)
            mine = (blkc // nb_local) == tpi
            local = jnp.clip(blkc - tpi * nb_local, 0, nb_local - 1)
            row = jnp.where(mine[:, None], ix.bblocks[local], 0)
            if need_ms:
                msrow = jnp.where(mine[:, None], ix.msrows[local], 0)
                both = jax.lax.psum(
                    jnp.concatenate([row, msrow], axis=1), meta.tp_axis)
                row, msrow = both[:, :meta.width], both[:, meta.width:]
            else:
                row = jax.lax.psum(row, meta.tp_axis)
                msrow = None
        else:
            nb = nb_local
            blkc = jnp.clip(blk, 0, nb - 1)
            row = ix.bblocks[blkc]                              # [B, W]
            # the MS side row: INDEPENDENT of `row` (same index), so the
            # two gathers can overlap instead of serializing
            msrow = ix.msrows[blkc] if need_ms else None
        off = (pos & (P - 1)).astype(i32)

        # SWAR rank over packed char words: group == code  <=>  all bits of
        # (word ^ code*lsb) in the group are zero
        words = row[:, W0:W0 + nwcw]                            # [B, nwcw]
        y = words ^ (rk * lsb)[:, None]
        z = y | (y >> 1)
        if pack == 4:
            z = z | (y >> 2) | (y >> 3)
        m = ~z & lsb                                            # match mask
        # position cutoff folded into the popcount mask
        wsel = off >> logW
        widx = jnp.arange(nwcw, dtype=i32)[None, :]
        lowmask = (1 << ((off & (per_word - 1)) * pack)) - 1
        mm = jnp.where(widx < wsel[:, None], m,
             jnp.where(widx == wsel[:, None], m & lowmask[:, None], 0))
        inblock = jnp.sum(jax.lax.population_count(mm), axis=1).astype(i32)
        # char at pos: select the word, shift the group out
        selw = (widx == wsel[:, None])
        w_at = jnp.sum(jnp.where(selw, words, 0), axis=1).astype(i32)
        nib = (w_at >> ((off & (per_word - 1)) * pack)) & ((1 << pack) - 1)
        at_pos = nib == rk

        # occ checkpoint select; wide mode reassembles the 40-bit value from
        # the u32 low word + its packed high byte
        sel8 = (jnp.arange(nslots, dtype=i32)[None, :] == rk[:, None])
        cp_lo = jnp.sum(jnp.where(sel8, row[:, C0:C0 + nslots], 0),
                        axis=1).astype(i32)
        if wide:
            selh = (jnp.arange(nhw, dtype=i32)[None, :] ==
                    (rk >> 2)[:, None])
            hw = jnp.sum(jnp.where(selh, row[:, H0:H0 + nhw], 0),
                         axis=1).astype(i32)
            cp_hi = (hw >> ((rk & 3) * 8)) & 0xFF
            cp_sel = ((cp_hi.astype(dt) << 32)
                      | (cp_lo.astype(dt) & 0xFFFFFFFF))
        else:
            cp_sel = cp_lo

        # up/down bit for char c at offset `off`
        bidx = rk * wpc + (off >> 5)
        selb = (jnp.arange(nslots * wpc, dtype=i32)[None, :] == bidx[:, None])
        word = jnp.sum(jnp.where(selb, row[:, T0:T0 + nslots * wpc], 0),
                       axis=1).astype(i32)
        up_bit = (word >> (off & 31)) & 1

        is_tq = None
        if pack == 2 and meta.term_pos >= 0:
            # correct the single terminator alias with static scalars
            tb, to = meta.term_pos >> logP, meta.term_pos & (P - 1)
            at_term_blk = blk == tb
            inblock = inblock - (at_term_blk & (rk == meta.term_code)
                                 & (to < off)).astype(i32)
            at_pos = at_pos & ~(at_term_blk & (off == to))
            # terminator QUERIES: single run, threshold 0 (first-run rule)
            is_tq = c_blk == TERM_CODE
            inblock = jnp.where(is_tq, (pos > meta.term_pos).astype(i32),
                                inblock)
            at_pos = jnp.where(is_tq, pos == meta.term_pos, at_pos)
            cp_sel = jnp.where(is_tq, jnp.asarray(meta.F_term, dt), cp_sel)
            up_bit = jnp.where(is_tq, 0, up_bit)

        A = cp_sel + inblock.astype(dt)                         # F[c] + rank
        is_match = ~empty & at_pos
        has_next = A < Fnext
        jump_up = ~empty & ~is_match & (~has_next | (up_bit == 1))

        out = dict(A=A, Fb=Fb, empty=empty, is_match=is_match,
                   jump_up=jump_up, rk=rk, off=off, is_tq=is_tq,
                   msrow=msrow, acc=acc)
        out["new_pos"] = jnp.where(empty, Fb, A - jump_up.astype(dt))
        return out

    return probe


def make_blockbits_step_fn(meta: BitMeta, mode: str, use_doc: bool):
    """One backward PML step. carry = (pos, length, sample, doc) for state
    compatibility with the other engines; sample/doc pass through. chars
    must be QUERY-rank mapped; `ctab` is OccHost.table_for_alphabet's."""
    assert mode == "pml" and not use_doc, \
        "MS / doc tracking use make_blockbits_ms_step_fn"
    probe = _make_probe_fn(meta)

    def step(ix: BitArrays, carry, qc, ctab):
        pos, length, sample, doc = carry
        pr = probe(ix, pos, qc, ctab)
        new_length = jnp.where(pr["is_match"], length + 1, 0)
        return (pr["new_pos"], new_length, sample, doc), (new_length, doc)

    return step


def make_blockbits_ms_step_fn(meta: BitMeta, mode: str, use_doc: bool):
    """v4-MS / v4-doc step: one extra INDEPENDENT msrow gather per step.

    The MS recurrence (compute_ms_pml.cpp:570-623) differs from PML only in
    what a jump assigns: samples_start / samples_last of the jump-target
    run — per-run VALUES, which would force a second dependent gather. This
    kernel instead carries (jidx, d): jidx identifies the last jump target
    as 2*run + (1 if jump-up) in the char-grouped run numbering (EMPTY = 2r
    for the absent-char reset, INIT = 2r+1 for the seed), and d counts the
    match-extends since (each match does sample -= 1, :582). The actual
    sample matrix is reconstructed AFTER the scan as jump_t[jidx] - d —
    [B, L] INDEPENDENT gathers that pipeline at memory bandwidth, keeping
    the scan itself at one dependent gather per step.

    The jump-target run index needs the char-LOCAL run rank at pos: msrows
    carries per-code run-rank checkpoints + run-start bits (same SWAR
    pattern as the main row's up-bits), and the char-grouped base
    (char_off[c]) rides the per-char table as column 4.

    Doc tracking (compute_ms_pml.cpp:288-340,625-682) reuses jidx
    unchanged: doc ids also change only on jumps — docs = jump_d[jidx].
    The one semantic split: an absent char RESETS the MS doc to run 0's
    start doc (:639-643) but KEEPS the PML doc (:303); the EMPTY slot holds
    first_run_sdoc, so MS routes empties there while PML keeps jidx.

    mode='ms': carry (pos, jidx, d), emit (jidx, d).
    mode='pml' (use_doc): carry (pos, length, jidx), emit (length, jidx).
    """
    assert meta.has_ms, "index built without want_ms/want_doc"
    ms = mode == "ms"
    assert ms or use_doc, "use make_blockbits_step_fn for plain PML"
    P, pack = meta.P, meta.pack
    nslots = MAX_SIGMA2 if pack == 2 else MAX_SIGMA4
    wpc = P // 32
    MB0 = nslots
    probe = _make_probe_fn(meta, need_ms=True)
    EMPTY = 2 * meta.r

    def step(ix: BitArrays, carry, qc, ctab):
        if ms:
            pos, jidx, d = carry
        else:
            pos, length, jidx = carry
        i32 = jnp.int32
        pr = probe(ix, pos, qc, ctab)
        msrow, off, rk = pr["msrow"], pr["off"], pr["rk"]
        B = pos.shape[0]

        # char-local run rank at pos: checkpoint + popcount(start bits at
        # offsets < off) over the code's P/32 bit words
        sel8 = (jnp.arange(nslots, dtype=i32)[None, :] == rk[:, None])
        rc_sel = jnp.sum(jnp.where(sel8, msrow[:, :nslots], 0),
                         axis=1).astype(i32)
        widx = jnp.arange(wpc, dtype=i32)[None, :]
        selg = (jnp.arange(nslots, dtype=i32)[:, None] == rk[:, None, None])
        # .astype(i32): under x64 jnp.sum promotes int32 -> int64, and a
        # 64-bit popcount on a sign-extended word with bit 31 set counts 32
        # phantom high bits
        bits = jnp.sum(jnp.where(
            selg, msrow[:, MB0:].reshape(B, nslots, wpc), 0),
            axis=1).astype(i32)
        wcut = (off >> 5)[:, None]
        lowmask = ((1 << (off & 31)) - 1)[:, None]
        mb = jnp.where(widx < wcut, bits,
             jnp.where(widx == wcut, bits & lowmask, 0))
        k_local = rc_sel + jnp.sum(jax.lax.population_count(mb),
                                   axis=1).astype(i32)

        base = pr["acc"][:, 4].astype(i32)     # char_off[c] (table col 4)
        jdown = 2 * (base + k_local)
        if pr["is_tq"] is not None:
            jdown = jnp.where(pr["is_tq"], 2 * meta.term_runidx, jdown)
        # jump-up targets run k_local-1's END entry: 2*(run-1)+1 = jdown-1
        jjump = jnp.maximum(jnp.where(pr["jump_up"], jdown - 1, jdown), 0)

        if ms:
            new_jidx = jnp.where(pr["is_match"], jidx,
                       jnp.where(pr["empty"], EMPTY, jjump))
            new_d = jnp.where(pr["is_match"], d + 1, 0)
            return (pr["new_pos"], new_jidx, new_d), (new_jidx, new_d)
        # PML + doc: empty KEEPS the current doc (and matches do too)
        new_jidx = jnp.where(pr["is_match"] | pr["empty"], jidx, jjump)
        new_length = jnp.where(pr["is_match"], length + 1, 0)
        return (pr["new_pos"], new_length, new_jidx), (new_length, new_jidx)

    return step


def ms_initial_state(ix: BitArrays, meta: BitMeta, B: int, mode: str):
    """Seed for make_blockbits_ms_step_fn: empty pattern at the last BWT
    row, jidx at the INIT slot (jump_t[2r+1] = last_run_sample = SA[n-1],
    compute_ms_pml.cpp:574-575)."""
    dt = ix.n.dtype
    i32 = jnp.int32
    pos0 = jnp.full((B,), ix.n - 1, dtype=dt)
    init = jnp.full((B,), 2 * meta.r + 1, dtype=i32)
    if mode == "ms":
        return (pos0, init, jnp.zeros((B,), dtype=i32))
    return (pos0, jnp.zeros((B,), dtype=dt), init)
