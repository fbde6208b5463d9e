"""Sharded-index ("tensor parallel") querying — SURVEY §2.2.

The reference's index always fits host RAM (sdsl structures, loaded whole in
`pml_t`/`ms_t`, compute_ms_pml.cpp:694-838). On a device the packed `fields`
table of a human-pangenome index (r ≈ 1e8 runs × 8 slots × 8 B ≈ 6.4 GB, plus
text for MS mode) can exceed one card's memory — the answer is to shard the
dominant table by rows over a mesh axis and turn each probe into an
owner-masked local gather + `psum` (the all-to-all row exchange pattern).

Implemented with `shard_map` rather than pjit sharding constraints so the
per-device memory is GUARANTEED to be the shard (XLA's SPMD partitioner may
lower a gather into a row-sharded table as a full all-gather of the operand,
which silently reinstates the replicated footprint).

Mesh layout: 2-D ("data", "model") — read lanes shard over "data", the
`fields` table shards over "model", and every lane's scan carry stays
replicated along "model" (the psum keeps all model shards in lockstep).
Bandwidth cost: one [B_local, G·W] psum per scan step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.layered import F_START, LayeredArrays, LayeredMeta
from .mesh import _fused_classify_core, replicate_index
from ..utils import encode_rows, log, present_chars


def make_tp_mesh(n_data: int, n_model: int, devices=None) -> Mesh:
    """(data, model) mesh over the first n_data * n_model devices. The
    cards of one host are joined all to all, so the device order is the
    algorithm's alone: a plain reshape."""
    devices = devices if devices is not None else jax.devices()
    if len(devices) < n_data * n_model:
        raise ValueError(f"a {n_data}x{n_model} mesh needs "
                         f"{n_data * n_model} devices, have {len(devices)}")
    grid = np.asarray(devices[:n_data * n_model]).reshape(n_data, n_model)
    return Mesh(grid, ("data", "model"))


def shard_index_tp(arrays: LayeredArrays, meta: LayeredMeta, mesh: Mesh,
                   model_axis: str = "model"):
    """Places the index on a 2-D mesh with `fields` row-sharded over
    `model_axis` (rows padded to a multiple of the axis size) and every other
    array replicated. Returns (arrays, meta with tp_axis set)."""
    S = mesh.shape[model_axis]
    f = np.asarray(arrays.fields)
    rows = f.shape[0]
    if rows % S:
        pad = -(-rows // S) * S - rows
        # Pad with the same sentinel pattern as build_layered (layered.py):
        # every padded run slot gets F_START = n (an unreachable start), rest
        # zero.  The probe row is always <= r < original rp so pad rows are
        # never gathered today; the sentinel keeps them inert even if that
        # invariant ever loosens (a zero START would parse as a valid run
        # at position 0).
        padblock = np.zeros((pad, f.shape[1]), f.dtype)
        width = meta.width
        padblock[:, F_START::width] = int(np.asarray(arrays.n))
        f = np.concatenate([f, padblock], axis=0)
    fields = jax.device_put(
        jnp.asarray(f), NamedSharding(mesh, P(model_axis, None)))
    rest = replicate_index(arrays._replace(fields=None), mesh)
    return (rest._replace(fields=fields),
            meta._replace(tp_axis=model_axis))


def shard_index_tp_bits(arrays, meta, mesh: Mesh, model_axis: str = "model"):
    """Block-bits (engine v4) variant: `bblocks` row-sharded over
    `model_axis` (zero-padded to a multiple of the axis size — pad rows map
    to positions >= n and are never gathered), everything else replicated.
    One [B, W] psum per step reassembles the single gathered row — v4's
    one-probe step makes this the cheap TP path."""
    S = mesh.shape[model_axis]
    bb = np.asarray(arrays.bblocks)
    rows = bb.shape[0]
    if rows % S:
        pad = -(-rows // S) * S - rows
        bb = np.concatenate(
            [bb, np.zeros((pad, bb.shape[1]), bb.dtype)], axis=0)
    bblocks = jax.device_put(
        jnp.asarray(bb), NamedSharding(mesh, P(model_axis, None)))
    rest = replicate_index(arrays._replace(bblocks=None), mesh)
    return (rest._replace(bblocks=bblocks),
            meta._replace(tp_axis=model_axis))


class TpPmlClassifier:
    """PML classification with the index sharded over the 'model' axis
    (layered or block-bits engine).

    Same classify-only contract as ShardedPmlClassifier(want_values=False):
    per-read (found, above, below, sum_maxes) summaries leave the mesh."""

    def __init__(self, arrays, meta, mesh: Mesh,
                 bin_width: int, max_value_thr: int, host=None,
                 data_axis: str = "data", model_axis: str = "model"):
        self.bits = hasattr(arrays, "bblocks")
        assert self.bits or hasattr(arrays, "fields"), \
            "index sharding: layered or block-bits engines only"
        self.mesh = mesh
        self.data_axis, self.model_axis = data_axis, model_axis
        self.host = host
        self.bin_width = bin_width
        self.max_value_thr = max_value_thr
        if self.bits:
            self.arrays, self.meta = shard_index_tp_bits(arrays, meta, mesh,
                                                         model_axis)
            self.n_slots = int(self.arrays.bblocks.shape[0])
        else:
            self.arrays, self.meta = shard_index_tp(arrays, meta, mesh,
                                                    model_axis)
            # Total run SLOTS including shard-pad rows (not the logical run
            # count r) — used only to size probe clamping in the step fn;
            # pad slots carry the inert F_START=n sentinel.
            self.n_slots = int(self.arrays.fields.shape[0]) * self.meta.group
        self.n_data = mesh.shape[data_axis]
        self._fn_cache = {}

    def _classify_fn(self, ctab_present: bool):
        key = ctab_present
        if key in self._fn_cache:
            return self._fn_cache[key]
        meta, r, bw = self.meta, self.n_slots, self.bin_width
        da, ma = self.data_axis, self.model_axis

        def inner(ix, rev, lens, thr, ctab):
            return _fused_classify_core(ix, rev, lens, thr, meta, "pml",
                                        r, bw, ctab)

        ix_specs = jax.tree_util.tree_map(lambda _: P(), self.arrays)
        if self.bits:
            ix_specs = ix_specs._replace(bblocks=P(ma, None))
        else:
            ix_specs = ix_specs._replace(fields=P(ma, None))
        fn = jax.jit(shard_map(
            inner, mesh=self.mesh,
            in_specs=(ix_specs, P(da, None), P(da), P(), P()),
            out_specs=(P(da), P(da), P(da), P(da)),
            check_vma=False))
        self._fn_cache[key] = fn
        return fn

    def classify(self, reads, pad_to: int = 128):
        nreads = len(reads)
        maxm = max((len(r) for r in reads), default=1)
        L = pad_to
        while L < maxm:
            L *= 2
        B = max(self.n_data, 1 << max(0, (nreads - 1)).bit_length())
        if B % self.n_data:
            B = ((B // self.n_data) + 1) * self.n_data
        _, rev, lens = encode_rows(reads, B, L, want_fwd=False)

        ctab = None
        if self.host is not None:
            alphabet = tuple(sorted(
                set(self.host.index_chars)
                | set(int(x) for x in present_chars(rev)) | {0}))
            rev = self.host.rank_map(alphabet)[rev]
            ctab = replicate_index(
                self.host.table_for_alphabet(alphabet), self.mesh)

        rev_d = jax.device_put(
            jnp.asarray(rev), NamedSharding(self.mesh, P(self.data_axis, None)))
        lens_d = jax.device_put(
            jnp.asarray(lens), NamedSharding(self.mesh, P(self.data_axis)))
        thr = jnp.asarray(self.max_value_thr)
        found, above, below, sums = self._classify_fn(ctab is not None)(
            self.arrays, rev_d, lens_d, thr, ctab)
        found = np.asarray(found)[:nreads]
        return {
            "found": found,
            "above": np.asarray(above)[:nreads],
            "below": np.asarray(below)[:nreads],
            "sum_maxes": np.asarray(sums)[:nreads],
            "total_found": int(found.sum()),
        }


def _pad_rows_to(a: np.ndarray, S: int) -> np.ndarray:
    if a.shape[0] % S:
        pad = -(-a.shape[0] // S) * S - a.shape[0]
        a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)],
                           axis=0)
    return a


def shard_index_tp_ms(arrays, meta, mesh: Mesh, model_axis: str = "model"):
    """v4-MS variant of shard_index_tp_bits: `bblocks` AND `msrows`
    row-sharded over `model_axis` (identical padded row counts — the probe
    psums both rows in one message), the flat jump tables 1-D sharded, and
    `text` dropped (TpMsQuery shards its rows512 extension table
    separately). The escape hatch for MS indexes past one device: at GRCh38
    scale the MS engine is rows 4.9 GB + msrows ~3.3 GB + jump table 4.6 GB
    + text 6.2 GB — none of it needs to be whole on any one device."""
    S = mesh.shape[model_axis]
    sh2 = NamedSharding(mesh, P(model_axis, None))
    sh1 = NamedSharding(mesh, P(model_axis))
    bb = _pad_rows_to(np.asarray(arrays.bblocks), S)
    ms = _pad_rows_to(np.asarray(arrays.msrows), S)
    assert bb.shape[0] == ms.shape[0]
    jt = _pad_rows_to(np.asarray(arrays.jump_t), S)
    jd = (_pad_rows_to(np.asarray(arrays.jump_d), S)
          if arrays.jump_d is not None else None)
    rest = replicate_index(
        arrays._replace(bblocks=None, msrows=None, jump_t=None, jump_d=None,
                        text=None), mesh)
    out = rest._replace(
        bblocks=jax.device_put(jnp.asarray(bb), sh2),
        msrows=jax.device_put(jnp.asarray(ms), sh2),
        jump_t=jax.device_put(jnp.asarray(jt), sh1),
        jump_d=jax.device_put(jnp.asarray(jd), sh1) if jd is not None
        else None)
    return out, meta._replace(tp_axis=model_axis)


def _tp_take_1d(table, idx, axis: str):
    """Gather from a 1-D table sharded over `axis`: owner-masked local
    take + one psum (indices are identical across the axis, so the sum
    reassembles exact values)."""
    ln = table.shape[0]
    S = jax.lax.psum(1, axis)
    tpi = jax.lax.axis_index(axis).astype(jnp.int32)
    loc = idx - tpi * ln
    mine = (loc >= 0) & (loc < ln)
    v = jnp.where(mine, table[jnp.clip(loc, 0, ln - 1)], 0)
    return jax.lax.psum(v, axis)


class TpMsQuery:
    """Full MS (-M) querying with the index sharded over 'model': the v4-MS
    scan (one row + one msrow gather per step, psum-reassembled), the flat
    jump-table reconstruction, and the rows512 text extension all run on
    model-axis shards. Value contract of ScanEngine.query in MS mode:
    {'pointers', 'lengths'} (+ 'docs') per read.

    fallback: reads containing index-absent characters take the
    reference's sequential-carry quirk path (compute_ms_pml.cpp:802-810,
    not a pure LCP); those rare reads are re-queried on the given
    fallback engine (the native CPU oracle) instead of TP-ing the
    sequential kernel."""

    def __init__(self, arrays, meta, mesh: Mesh, host, use_doc: bool = False,
                 fallback=None, data_axis: str = "data",
                 model_axis: str = "model"):
        assert meta.has_ms and arrays.jump_t is not None, \
            "TP MS needs a v4-MS assembly (build_blockbits want_ms=True)"
        assert arrays.text is not None, "TP MS extension needs the text"
        if use_doc:
            assert arrays.jump_d is not None
        self.mesh, self.host = mesh, host
        self.use_doc = use_doc
        self.fallback = fallback
        self.data_axis, self.model_axis = data_axis, model_axis
        self.n_data = mesh.shape[data_axis]
        S = mesh.shape[model_axis]
        # rows512 extension table, row-sharded (host-side reshape of the
        # text; at true >HBM scale build it straight from the host text)
        text = np.asarray(arrays.text)
        self.nt = int(text.shape[0])
        rows = -(-self.nt // 512) + 1
        t = np.zeros((rows * 512,), np.uint8)
        t[:self.nt] = text
        t512 = _pad_rows_to(
            np.ascontiguousarray(t.view(np.uint32).reshape(rows, 128)), S)
        self.t512 = jax.device_put(
            jnp.asarray(t512), NamedSharding(mesh, P(model_axis, None)))
        self.arrays, self.meta = shard_index_tp_ms(arrays, meta, mesh,
                                                   model_axis)
        self._fn_cache = {}

    def _query_fn(self):
        if self._fn_cache:
            return self._fn_cache[0]
        from ..engine.blockbits import (make_blockbits_ms_step_fn,
                                        ms_initial_state)
        from ..engine.scan_engine import _flip_rows, extend_pointers_sweep

        meta, ma, da = self.meta, self.model_axis, self.data_axis
        use_doc, nt = self.use_doc, self.nt
        step = make_blockbits_ms_step_fn(meta, "ms", use_doc)

        def inner(ix, t512, rev, fwd, lens, ctab):
            B = rev.shape[0]
            state = ms_initial_state(ix, meta, B, "ms")
            state, (a_mat, b_mat) = jax.lax.scan(
                lambda c, ch: step(ix, c, ch, ctab), state, rev.T)
            jidx, dcr = a_mat.T, b_mat.T
            vals = (_tp_take_1d(ix.jump_t, jidx, ma)
                    - dcr.astype(ix.jump_t.dtype))
            dt = vals.dtype
            lens_dt = lens.astype(dt)
            ptrs_fwd = _flip_rows(vals, lens_dt)
            lens_mat = extend_pointers_sweep(
                t512, fwd, lens_dt, ptrs_fwd, nt, None,
                text_two_gather=True, tp_axis=ma)
            docs = (_tp_take_1d(ix.jump_d, jidx, ma).astype(dt)
                    if use_doc else jnp.zeros((B, 1), dt))
            return vals, ptrs_fwd, lens_mat, docs

        ix_specs = jax.tree_util.tree_map(lambda _: P(), self.arrays)
        ix_specs = ix_specs._replace(
            bblocks=P(ma, None), msrows=P(ma, None), jump_t=P(ma),
            **({"jump_d": P(ma)} if self.arrays.jump_d is not None else {}))
        fn = jax.jit(shard_map(
            inner, mesh=self.mesh,
            in_specs=(ix_specs, P(ma, None), P(da, None), P(da, None),
                      P(da), P()),
            out_specs=(P(da, None), P(da, None), P(da, None), P(da, None)),
            check_vma=False))
        self._fn_cache[0] = fn
        return fn

    def query(self, reads, pad_to: int = 128):
        nreads = len(reads)
        maxm = max((len(r) for r in reads), default=1)
        L = pad_to
        while L < maxm:
            L *= 2
        B = max(self.n_data, 1 << max(0, (nreads - 1)).bit_length())
        if B % self.n_data:
            B = ((B // self.n_data) + 1) * self.n_data
        fwd, rev, lens = encode_rows(reads, B, L)
        alphabet = tuple(sorted(
            {0} | set(int(x) for x in present_chars(rev))))
        ctab = replicate_index(
            self.host.table_for_alphabet(alphabet), self.mesh)
        revm = self.host.rank_map(alphabet)[rev]
        dsh = NamedSharding(self.mesh, P(self.data_axis, None))
        lsh = NamedSharding(self.mesh, P(self.data_axis))
        vals, ptrs_fwd, lens_mat, docs = self._query_fn()(
            self.arrays, self.t512,
            jax.device_put(jnp.asarray(revm), dsh),
            jax.device_put(jnp.asarray(fwd), dsh),
            jax.device_put(jnp.asarray(lens), lsh), ctab)
        vals = np.asarray(vals)
        lens_mat = np.asarray(lens_mat)
        ptrs_fwd = np.asarray(ptrs_fwd)
        out = {"pointers": [vals[i, :lens[i]][::-1].copy()
                            for i in range(nreads)],
               "lengths": [lens_mat[i, :lens[i]].copy()
                           for i in range(nreads)]}
        if self.use_doc:
            docs = np.asarray(docs)
            out["docs"] = [docs[i, :lens[i]][::-1].copy()
                           for i in range(nreads)]
        # reference quirk path: pointer <= 0 lanes (index-absent chars) are
        # not a pure LCP — re-query those reads on the exact fallback
        anom = [i for i in range(nreads)
                if lens[i] and (ptrs_fwd[i, :lens[i]] <= 0).any()]
        if anom and self.fallback is not None:
            log("tp", f"{len(anom)} of {nreads} reads hold characters absent "
                      f"from the index: their lengths come from the native "
                      f"engine (reference carry semantics)")
            sub = self.fallback.query([reads[i] for i in anom])
            for j, i in enumerate(anom):
                out["lengths"][i] = np.asarray(sub["lengths"][j])
        return out
