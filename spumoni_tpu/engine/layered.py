"""Layered (multi-way B+-tree style) index layout — engine v2.

Motivation: a dependent 1-element random gather per probe is the expensive
part of a step, and a 16-64-wide contiguous row gather costs little more than
one element. The per-character binary search of engine v1 (log2(R_c) ~ 18-27
dependent scalar probes per step) is therefore replaced by a NODE-ary
layered search:

  level t of char c holds every NODE^t-th run-start of c, padded with the
  sentinel n to whole NODE-entry rows. Searching descends
  D = ceil(log_NODE(R_c)) levels; each level is ONE row gather + a NODE-wide
  compare-count.

Per-run fields are packed so ONE row gather provides exactly what a step
consumes: row k+1 = [start_k, len_k, cum_k, thr_{k+1}(, esamp_k, ssamp_{k+1},
edoc_k, sdoc_{k+1})] — the current run's match/rank data plus the next run's
jump-down targets. Per-char scalars (F, cnt, lo0, hi0, level row offsets)
pack into one [256, 16] "charmeta" row gather.

Per step: 1 charmeta + D level + 1 field row-gathers
(vs ~28 scalar gathers for engine v1).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_NODE = 64


class LayeredArrays(NamedTuple):
    charmeta: jnp.ndarray            # [256, 16]: F, cnt, lo0, hi0, rowoff[t]..
    levels: Tuple[jnp.ndarray, ...]  # D arrays [rows_t, NODE]
    fields: jnp.ndarray              # [rp, W]: row k+1 = run k + next-run data
    text: Optional[jnp.ndarray]      # [nt] u8 (MS extension)
    # per-char fused table (charmeta ++ root level row): one row gather
    # yields every per-char constant plus the root search node
    rootmat: Optional[jnp.ndarray]   # [256, 16+NODE] int64
    n: jnp.ndarray
    last_run_sample: jnp.ndarray
    last_run_edoc: jnp.ndarray
    first_run_sdoc: jnp.ndarray


class LayeredMeta(NamedTuple):
    depth: int                # D
    node: int                 # NODE width
    dtype: str
    width: int                # W (row width)
    has_samples: bool
    has_doc: bool
    has_text: bool
    fused_root: bool = False  # per-char lookups via the fused rootmat row
    group: int = 1            # field rows grouped G runs per physical row
    # index sharding (SURVEY §2.2 "gather across shards ≈ TP"): when set,
    # the step runs inside a shard_map whose `tp_axis` mesh axis shards the
    # `fields` table by rows — each device holds rows [s*R_loc, (s+1)*R_loc)
    # and a probe becomes owner-masked local gather + psum over the axis.
    # Used when the packed index exceeds one device's memory (the reference
    # has no analog: its index always fits host RAM, thresholds_ds.hpp).
    tp_axis: Optional[str] = None


# field slot order inside a row; START/LEN/CUM/ESAMP/EDOC describe run k
# (stored at row k+1), THR/SSAMP/SDOC describe run k+1 (the jump-down target)
F_START, F_LEN, F_CUM, F_THR, F_ESAMP, F_SSAMP, F_EDOC, F_SDOC = range(8)


# Row gathers slowed sharply past ~2^17 rows on the earlier target,
# independent of row width, so tables bigger than this are stored with GROUP
# runs packed per physical row and the target selected in-register after the
# gather. Whether the step exists on the GPU is ROADMAP design item 4.
GATHER_ROW_CLIFF = 1 << 17
FIELD_GROUP = 16


def build_layered(idx, want_samples=None, want_doc=None, want_text=None,
                  node: int = DEFAULT_NODE, fuse_root: bool = True,
                  group: Optional[int] = None, dtype=None):
    """DenseIndex -> (LayeredArrays on device, LayeredMeta).

    dtype: position type override; defaults to int32 when the BWT fits
    (int64 past 2^31 — a human genome + revcomp needs it)."""
    if want_samples is None:
        want_samples = idx.c_ssamp is not None
    if want_doc is None:
        want_doc = idx.c_sdoc is not None
    if want_text is None:
        want_text = idx.text is not None

    n = int(idx.n)
    if dtype is None:
        dtype = np.int32 if n < 2**31 - 2 else np.int64
    char_off = np.asarray(idx.char_off, dtype=np.int64)
    runs_per_char = np.diff(char_off)
    max_rc = int(runs_per_char.max()) if idx.r else 1
    D = max(1, math.ceil(math.log(max(max_rc, 2), node)))
    assert 4 + D <= 16, "depth too large for charmeta row"

    c_start = np.asarray(idx.c_start, dtype=np.int64)

    # --- levels ---
    levels = []
    rowoffs = np.zeros((D, 256), dtype=np.int64)
    for t in range(D):
        step = node ** t
        rows_all = []
        off = 0
        for c in range(256):
            lo, hi = char_off[c], char_off[c + 1]
            entries = c_start[lo:hi:step]
            nrows = max(1, -(-len(entries) // node))
            pad = nrows * node - len(entries)
            if pad:
                entries = np.concatenate(
                    [entries, np.full(pad, n, dtype=np.int64)])
            rowoffs[t, c] = off
            rows_all.append(entries.reshape(nrows, node))
            off += nrows
        levels.append(np.concatenate(rows_all, axis=0).astype(dtype))

    # --- charmeta ---
    charmeta = np.zeros((256, 16), dtype=np.int64)
    charmeta[:, 0] = np.asarray(idx.F)
    charmeta[:, 1] = np.asarray(idx.cnt)
    charmeta[:, 2] = char_off[:256]
    charmeta[:, 3] = char_off[1:257]
    for t in range(D):
        charmeta[:, 4 + t] = rowoffs[t]

    # --- packed fields: one row per run holding exactly what a step needs.
    # Row j+1 describes run j:   [start_j, len_j, cum_j, thr_{j+1}
    #                            (, esamp_j, ssamp_{j+1}, edoc_j, sdoc_{j+1})]
    # (match/rank need run k's start/len/cum; a jump-down needs the NEXT
    # run's threshold/start-sample/doc; a jump-up needs run k's
    # end-sample/doc — nothing else is ever read.)
    # Row 0 is the virtual predecessor of run 0 so a dead search
    # (pos before the first c-run, probing row lo0) still reads the first
    # c-run's threshold (0) and start sample as its "next".
    # PML-only rows carry just (start, len, cum, thr); samples/doc slots
    # exist only when the index needs them (halves field bytes + probe cost)
    W = 8 if (want_samples or want_doc) else 4
    r = int(idx.r)
    # rows 0..r fit. Power-of-two padding buckets compile shapes across
    # indexes, but past 2^20 rows it can waste nearly 2x the dominant device
    # array (8.6 vs 4.8 GB at r = 1.5e8) — large tables pad to the next
    # 2^20 multiple instead (same compile-cache bucketing granularity).
    if r < (1 << 20):
        rp = max(2, 1 << r.bit_length())
    else:
        rp = -(-(r + 2) // (1 << 20)) * (1 << 20)
    if group is None:
        group = FIELD_GROUP if rp > GATHER_ROW_CLIFF else 1
    if rp % group:
        rp = -(-rp // group) * group
    fields = np.zeros((rp, W), dtype=np.int64)
    fields[:, F_START] = n  # sentinel start for padded/virtual slots
    fields[1:r + 1, F_START] = c_start
    fields[1:r + 1, F_LEN] = np.asarray(idx.c_len)
    fields[1:r + 1, F_CUM] = np.asarray(idx.c_cum)
    thr = np.asarray(idx.c_thr)
    fields[:r, F_THR] = thr          # row j holds thr of run j (next of j-1)
    if want_samples:
        ss = np.asarray(idx.c_ssamp)
        es = np.asarray(idx.c_esamp)
        fields[1:r + 1, F_ESAMP] = es
        fields[:r, F_SSAMP] = ss
    if want_doc:
        sd = np.asarray(idx.c_sdoc)
        ed = np.asarray(idx.c_edoc)
        fields[1:r + 1, F_EDOC] = ed
        fields[:r, F_SDOC] = sd

    text = None
    if want_text and idx.text is not None:
        t_ = np.asarray(idx.text, dtype=np.uint8)
        tp = max(1, 1 << (len(t_) - 1).bit_length())
        if tp != len(t_):
            t_ = np.concatenate([t_, np.zeros(tp - len(t_), dtype=np.uint8)])
        text = jax.device_put(t_)

    # fused per-char table: charmeta ++ root-level row (rank is always 0 at
    # the root, so the root row is a pure function of the char)
    root_rows = np.zeros((256, node), dtype=np.int64)
    lvl = levels[D - 1].astype(np.int64)
    for c in range(256):
        root_rows[c] = lvl[rowoffs[D - 1, c]]
    rootmat = (jnp.asarray(np.concatenate([charmeta, root_rows], axis=1))
               if fuse_root else None)

    if group > 1:
        fields = fields.reshape(rp // group, group * W)

    arrays = LayeredArrays(
        rootmat=rootmat,
        charmeta=jnp.asarray(charmeta.astype(dtype)),
        levels=tuple(jax.device_put(np.ascontiguousarray(lv))
                     for lv in levels),
        fields=jax.device_put(np.ascontiguousarray(fields.astype(dtype))),
        text=text,
        n=jnp.asarray(np.asarray(n, dtype=dtype)),
        last_run_sample=jnp.asarray(np.asarray(idx.last_run_sample, dtype=dtype)),
        last_run_edoc=jnp.asarray(np.asarray(idx.last_run_edoc, dtype=dtype)),
        first_run_sdoc=jnp.asarray(np.asarray(idx.first_run_sdoc, dtype=dtype)),
    )
    meta = LayeredMeta(depth=D, node=node, dtype=np.dtype(dtype).name, width=W,
                       has_samples=bool(want_samples), has_doc=bool(want_doc),
                       has_text=text is not None, fused_root=fuse_root,
                       group=group)
    host = LayeredHost(charmeta_np=charmeta, root_np=root_rows,
                       index_chars=tuple(int(c) for c in range(256)
                                         if runs_per_char[c] > 0))
    return arrays, meta, host


class LayeredHost:
    """Host-side companion data for the reduced-alphabet fused lookup:
    reads are rank-mapped on the host so the per-char table shrinks from
    256 rows to |alphabet| rows (padded to a multiple of 16)."""

    def __init__(self, charmeta_np, root_np, index_chars):
        self.charmeta_np = charmeta_np      # [256, 16] int64
        self.root_np = root_np              # [256, NODE] int64
        self.index_chars = index_chars
        self._table_cache = {}

    def table_for_alphabet(self, alphabet: tuple):
        """Device [sigma_pad, 16+NODE] int64 table for the given char tuple."""
        key = alphabet
        if key in self._table_cache:
            return self._table_cache[key]
        sigma = len(alphabet)
        sigma_pad = max(16, -(-sigma // 16) * 16)
        mat = np.zeros((sigma_pad, 16 + self.root_np.shape[1]), dtype=np.int64)
        mat[:sigma, :16] = self.charmeta_np[list(alphabet)]
        mat[:sigma, 16:] = self.root_np[list(alphabet)]
        ctab = jnp.asarray(mat)
        self._table_cache[key] = ctab
        return ctab

    def rank_map(self, alphabet: tuple) -> np.ndarray:
        amap = np.zeros(256, dtype=np.uint8)
        for i, c in enumerate(alphabet):
            amap[c] = i
        return amap


def make_layered_step_fn(meta: LayeredMeta, mode: str, use_doc: bool):
    """One backward step over a [B] batch using the layered search."""
    ms = mode == "ms"
    D, NODE, W = meta.depth, meta.node, meta.width

    fused = meta.fused_root
    G = meta.group

    def step(ix: LayeredArrays, carry, chars, ctab=None):
        """chars are raw bytes, unless `ctab` (a reduced-alphabet table)
        is given — then chars are alphabet ranks < ctab.shape[0]."""
        pos, length, sample, doc = carry
        dt = pos.dtype
        c = chars.astype(dt)

        if ctab is not None or fused:
            # per-char lookups: one gather of (charmeta ++ root row)
            tab = ctab if ctab is not None else ix.rootmat
            acc = tab[chars.astype(jnp.int32)].astype(dt)
            cm = acc[:, :16]
            root_row = acc[:, 16:]
        else:
            cm = ix.charmeta[c]                 # [B, 16]
            root_row = None
        Fc, cntc, lo0, hi0 = cm[:, 0], cm[:, 1], cm[:, 2], cm[:, 3]

        # NODE-ary descent: rank = index within char of last run-start <= pos;
        # m == 0 is only possible at the root (pos before the first c-run).
        rank = jnp.zeros_like(pos)
        dead = jnp.zeros(pos.shape, dtype=bool)
        if root_row is not None:
            m = jnp.sum(root_row <= pos[:, None], axis=1).astype(dt)
            dead = m == 0
            rank = jnp.maximum(m - 1, 0)
        start_t = D - 2 if root_row is not None else D - 1
        for t in range(start_t, -1, -1):
            rows = ix.levels[t][cm[:, 4 + t] + rank]          # [B, NODE]
            m = jnp.sum(rows <= pos[:, None], axis=1).astype(dt)
            if t == D - 1:
                dead = m == 0
            rank = rank * NODE + jnp.maximum(m - 1, 0)
        valid_k = ~dead
        k = lo0 + rank

        # one field-row gather: row k+1 holds run k's start/len/cum/esamp/edoc
        # AND run k+1's thr/ssamp/sdoc. Dead lanes probe row lo0 — their
        # "next c-run" is run lo0, whose threshold is 0, forcing the
        # jump-down the reference takes when rank(pos,c) == 0
        # (compute_ms_pml.cpp:259-268).
        tp = meta.tp_axis
        rows_local = ix.fields.shape[0]       # local shard rows under TP
        tp_size = jax.lax.psum(1, tp) if tp else 1
        rp = rows_local * G * tp_size
        probe = jnp.clip(jnp.where(valid_k, k + 1, lo0), 0, rp - 1)
        prow = probe // G if G > 1 else probe
        if tp:
            # sharded fields: the owner shard gathers the row locally,
            # every other shard contributes zeros, psum over the tp axis
            # reassembles the row on all shards (lanes stay replicated
            # along tp, so the scan carry never diverges across shards).
            owner = prow // rows_local
            mine = owner == jax.lax.axis_index(tp)
            grow = ix.fields[jnp.where(mine, prow - owner * rows_local, 0)]
            grow = jnp.where(mine[:, None], grow, 0)
            grow = jax.lax.psum(grow, tp)
        else:
            grow = ix.fields[prow]
        if G == 1:
            row = grow                                        # [B, W]
        else:
            # grouped rows: gather the G-run physical row, select the target
            # run's W-slot window in-register (masked sum — cheaper than
            # take_along_axis on this part)
            grow = grow.reshape(-1, G, W)                     # [B, G, W]
            sel = (jnp.arange(G, dtype=dt)[None, :] == (probe % G)[:, None])
            row = jnp.sum(jnp.where(sel[:, :, None], grow, 0),
                          axis=1).astype(dt)

        start_k, len_k, cum_k = row[:, F_START], row[:, F_LEN], row[:, F_CUM]
        is_match = valid_k & (pos < start_k + len_k)
        rnk = jnp.where(valid_k,
                        cum_k + jnp.minimum(pos - start_k, len_k), 0)
        has_next = jnp.where(valid_k, (rank + 1) < (hi0 - lo0), cntc > 0)
        thr = row[:, F_THR]

        jump_down = (~is_match) & has_next & (pos >= thr)
        empty = cntc == 0

        new_length = jnp.where(is_match, length + 1, 0)
        new_pos = jnp.where(empty, Fc,
                  jnp.where(is_match | jump_down, Fc + rnk, Fc + rnk - 1))

        if ms:
            new_sample = jnp.where(empty, 0,
                         jnp.where(is_match, sample - 1,
                         jnp.where(jump_down, row[:, F_SSAMP],
                                   row[:, F_ESAMP])))
        else:
            new_sample = sample
        if use_doc:
            jumped = jnp.where(jump_down, row[:, F_SDOC], row[:, F_EDOC])
            if ms:
                new_doc = jnp.where(empty, ix.first_run_sdoc,
                          jnp.where(is_match, doc, jumped))
            else:
                new_doc = jnp.where(empty | is_match, doc, jumped)
        else:
            new_doc = doc

        emit = (new_sample if ms else new_length, new_doc)
        return (new_pos, new_length, new_sample, new_doc), emit

    return step
