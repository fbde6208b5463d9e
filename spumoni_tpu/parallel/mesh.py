"""Scale-out layer: data-parallel querying over a jax.sharding.Mesh.

The reference's only parallelism is OpenMP threads over read batches
(compute_ms_pml.cpp:894,1082). The device equivalent (SURVEY.md §2.2):

  * the index arrays are REPLICATED across the mesh (they are the "weights");
  * read batches are sharded along the 'data' axis (each device runs the
    lockstep scan over its shard of lanes);
  * classification verdicts are computed on device and merged with psum —
    only per-read summaries (or, when requested, the full value matrix)
    return to the host.

The same code path runs on one GPU (trivial mesh), a multi-GPU host, or —
with jax.distributed — several hosts, since pjit + NamedSharding compile to
the collectives (NCCL on GPUs) automatically.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.arrays import IndexArrays, IndexMeta
from ..engine.layered import LayeredArrays, make_layered_step_fn
from ..engine.occblock import make_occ_step_fn, occ_initial_state
from ..engine.scan_engine import make_step_fn
from ..utils import encode_rows, present_chars


def make_data_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def replicate_index(arrays, mesh: Mesh):
    """Places every index array replicated on the mesh (any pytree)."""
    repl = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, repl), arrays)


def _step_fn_for(arrays, meta, mode, use_doc, r):
    if hasattr(arrays, "bblocks"):
        from ..engine.blockbits import make_blockbits_step_fn
        return make_blockbits_step_fn(meta, mode, use_doc)
    if hasattr(arrays, "blocks"):
        return make_occ_step_fn(meta, mode, use_doc)
    if isinstance(arrays, LayeredArrays) or hasattr(arrays, "fields"):
        return make_layered_step_fn(meta, mode, use_doc)
    return make_step_fn(meta, mode, use_doc, r)


def _dtype_of(ix):
    if hasattr(ix, "bblocks"):
        return ix.n.dtype      # wide v4: int64 positions over int32 rows
    if hasattr(ix, "blocks"):
        return ix.blocks.dtype
    return (ix.fields if hasattr(ix, "fields") else ix.c_start).dtype


def _takes_ctab(ix) -> bool:
    return (hasattr(ix, "bblocks") or hasattr(ix, "blocks")
            or hasattr(ix, "fields"))


def _initial_core(ix, B, dt):
    if hasattr(ix, "blocks"):
        return occ_initial_state(ix, B)
    return (jnp.full((B,), ix.n - 1, dtype=dt),
            jnp.zeros((B,), dtype=dt),
            jnp.full((B,), ix.last_run_sample, dtype=dt),
            jnp.full((B,), ix.last_run_edoc, dtype=dt))


def _fused_classify_core(ix, reads_rev, lens, max_value_thr, meta,
                         mode: str, r: int, bin_width: int, ctab=None):
    """Unjitted body of fused_classify_kernel — also runs inside the
    shard_map of the sharded-index (TP) path (parallel/tp.py)."""
    B, L = reads_rev.shape
    dt = _dtype_of(ix)
    step = _step_fn_for(ix, meta, mode, False, r)
    occ = hasattr(ix, "blocks") or hasattr(ix, "bblocks")
    assert mode == "pml" or not occ, "occ engine: fused classify is PML-only"

    lens = lens.astype(dt)
    nbins = jnp.maximum(lens // bin_width, 1)

    core0 = _initial_core(ix, B, dt)
    neg1 = jnp.full((B,), -1, dtype=dt)
    zero = jnp.zeros((B,), dtype=dt)

    def fused_step(carry, x):
        ch, i = x
        (core, prev_b, cur_max, above, below, summ) = carry
        if occ or hasattr(ix, "fields"):
            core, (val, _) = step(ix, core, ch, ctab)
        else:
            core, (val, _) = step(ix, core, ch)
        fwd = lens - 1 - i
        active = fwd >= 0
        b = jnp.minimum(fwd // bin_width, nbins - 1)
        closing = active & (prev_b >= 0) & (b != prev_b)
        above = above + jnp.where(closing & (cur_max >= max_value_thr), 1, 0)
        below = below + jnp.where(closing & (cur_max < max_value_thr), 1, 0)
        summ = summ + jnp.where(closing, cur_max, 0)
        cur_max = jnp.where(closing, neg1, cur_max)
        cur_max = jnp.where(active, jnp.maximum(cur_max, val), cur_max)
        prev_b = jnp.where(active, b, prev_b)
        return (core, prev_b, cur_max, above, below, summ), ()

    xs = (reads_rev.T, jnp.arange(L, dtype=dt))
    (core, prev_b, cur_max, above, below, summ), _ = jax.lax.scan(
        fused_step, (core0, neg1, neg1, zero, zero, zero), xs)
    # close the final open bin
    has = lens > 0
    above = above + jnp.where(has & (cur_max >= max_value_thr), 1, 0)
    below = below + jnp.where(has & (cur_max < max_value_thr), 1, 0)
    summ = summ + jnp.where(has, cur_max, 0)
    found = (above > below) & has
    return found, above.astype(jnp.int32), below.astype(jnp.int32), summ


@functools.partial(
    jax.jit, static_argnames=("meta", "mode", "r", "bin_width"))
def fused_classify_kernel(ix, reads_rev, lens, max_value_thr, meta,
                          mode: str, r: int, bin_width: int, ctab=None):
    """Scan + classification fully fused: the windowed bin-max statistics of
    compute_ms_pml.cpp:975-995 are folded into the scan carry (bins appear in
    decreasing order as the read is processed right-to-left; a bin closes
    when the per-lane window id changes), so no [B, L] value matrix is
    materialized or post-processed. Returns per-read
    (found, above, below, sum_maxes) only — the O(B) summary that leaves the
    device in classify-only mode.
    """
    return _fused_classify_core(ix, reads_rev, lens, max_value_thr, meta,
                                mode, r, bin_width, ctab)


@functools.partial(
    jax.jit,
    static_argnames=("meta", "mode", "use_doc", "r", "bin_width", "max_bins"))
def sharded_classify_kernel(ix: IndexArrays, reads_rev, lens, max_value_thr,
                            meta: IndexMeta, mode: str, use_doc: bool, r: int,
                            bin_width: int, max_bins: int, ctab=None):
    """Full device-side PML pipeline for one sharded batch: lockstep scan ->
    per-lane bin-max classification -> global psum of found counts.

    reads_rev [B, L] is sharded on axis 0; the index is replicated. Returns
    (vals [B, L] reversed order, found [B], above [B], below [B],
    sum_maxes [B], total_found scalar).
    """
    B, L = reads_rev.shape
    dt = _dtype_of(ix)
    step = _step_fn_for(ix, meta, mode, use_doc, r)
    occ = hasattr(ix, "blocks") or hasattr(ix, "bblocks")
    assert mode == "pml" and not use_doc or not occ

    core0 = _initial_core(ix, B, dt)
    if occ:
        body = lambda carry, ch: step(ix, carry, ch, ctab)
    else:
        body = lambda carry, ch: step(ix, carry, ch)
    _, (vals, docs) = jax.lax.scan(body, core0, reads_rev.T)
    vals = vals.T  # [B, L] (reversed read order per lane)
    docs = docs.T if use_doc else None

    # classification on the reversed values: window maxima are computed on the
    # un-reversed view via index flip (gather), preserving the tail-merge rule
    p = jnp.arange(L)
    flip_idx = jnp.clip(lens[:, None] - 1 - p[None, :], 0, L - 1)
    fwd_vals = jnp.take_along_axis(vals, flip_idx.astype(jnp.int32), axis=1)

    nbins = jnp.maximum(lens // bin_width, 1)
    binid = jnp.minimum(p[None, :] // bin_width, nbins[:, None] - 1)
    valid = p[None, :] < lens[:, None]
    neg = jnp.full_like(fwd_vals, -1)
    above = jnp.zeros((B,), dtype=jnp.int32)
    sum_maxes = jnp.zeros((B,), dtype=fwd_vals.dtype)
    for j in range(max_bins):
        sel = jnp.where(valid & (binid == j), fwd_vals, neg)
        mx = jnp.max(sel, axis=1)
        has = mx >= 0
        above = above + ((mx >= max_value_thr) & has).astype(jnp.int32)
        sum_maxes = sum_maxes + jnp.where(has, mx, 0)
    below = nbins.astype(jnp.int32) - above
    is_read = lens > 0
    found = (above > below) & is_read
    total_found = jnp.sum(found.astype(jnp.int32))
    return vals, docs, found, above, below, sum_maxes, total_found


class ShardedPmlClassifier:
    """Data-parallel PML classification over a mesh (replicated index)."""

    def __init__(self, arrays, meta, mesh: Mesh,
                 bin_width: int, max_value_thr: int, axis: str = "data",
                 host=None):
        self.mesh = mesh
        self.axis = axis
        self.arrays = replicate_index(arrays, mesh)
        self.meta = meta
        self.host = host  # Layered/OccHost: enables the per-char tables
        self.occ = hasattr(arrays, "blocks") or hasattr(arrays, "bblocks")
        if self.occ and host is None:
            raise ValueError("occ/block-bits engines require their OccHost")
        self.r = int(arrays.bblocks.shape[0] if hasattr(arrays, "bblocks")
                     else arrays.blocks.shape[0] if hasattr(arrays, "blocks")
                     else (arrays.fields if hasattr(arrays, "fields")
                           else arrays.c_start).shape[0])
        self.bin_width = bin_width
        self.max_value_thr = max_value_thr
        self.ndev = mesh.devices.size

    def classify(self, reads, pad_to: int = 128, want_values: bool = True):
        """Returns dict of per-read outputs (host numpy). The batch is padded
        to a lane count divisible by the mesh size and sharded over it."""
        nreads = len(reads)
        maxm = max((len(r) for r in reads), default=1)
        L = pad_to
        while L < maxm:
            L *= 2
        B = max(self.ndev, 1 << max(0, (nreads - 1)).bit_length())
        if B % self.ndev:
            B = ((B // self.ndev) + 1) * self.ndev
        _, rev, lens = encode_rows(reads, B, L, want_fwd=False)

        ctab = None
        if self.occ:
            # occ-block reads are always query-rank mapped
            alphabet = tuple(sorted(
                {0} | set(int(x) for x in present_chars(rev))))
            rev = self.host.rank_map(alphabet)[rev]
            ctab = replicate_index(
                self.host.table_for_alphabet(alphabet), self.mesh)
        elif (not want_values and self.host is not None
                and hasattr(self.arrays, "fields")):
            # reduced-alphabet fused lookup (rank-mapped reads) — only the
            # fused kernel below accepts ctab
            alphabet = tuple(sorted(
                set(self.host.index_chars)
                | set(int(x) for x in present_chars(rev)) | {0}))
            rev = self.host.rank_map(alphabet)[rev]
            ctab = replicate_index(
                self.host.table_for_alphabet(alphabet), self.mesh)

        shard = NamedSharding(self.mesh, P(self.axis, None))
        shard1 = NamedSharding(self.mesh, P(self.axis))
        rev_d = jax.device_put(jnp.asarray(rev), shard)
        lens_d = jax.device_put(jnp.asarray(lens), shard1)
        if not want_values:
            # classify-only: fused scan+binmax kernel, O(B) leaves the devices
            found, above, below, sums = fused_classify_kernel(
                self.arrays, rev_d, lens_d, self.max_value_thr, self.meta,
                "pml", self.r, self.bin_width, ctab)
            return {
                "found": np.asarray(found)[:nreads],
                "above": np.asarray(above)[:nreads],
                "below": np.asarray(below)[:nreads],
                "sum_maxes": np.asarray(sums)[:nreads],
                "total_found": int(np.asarray(found)[:nreads].sum()),
            }
        max_bins = max(1, -(-L // self.bin_width))
        vals, _, found, above, below, sums, total = sharded_classify_kernel(
            self.arrays, rev_d, lens_d, self.max_value_thr, self.meta, "pml",
            False, self.r, self.bin_width, max_bins, ctab)
        out = {
            "found": np.asarray(found)[:nreads],
            "above": np.asarray(above)[:nreads],
            "below": np.asarray(below)[:nreads],
            "sum_maxes": np.asarray(sums)[:nreads],
            "total_found": int(total),
        }
        if want_values:
            v = np.asarray(vals)
            out["lengths"] = [v[i, :lens[i]][::-1].copy()
                              for i in range(nreads)]
        return out
