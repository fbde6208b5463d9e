#!/usr/bin/env python
"""Promotion-digested classification AT GENOME SCALE — the reference's
default mode (spumoni.cpp:294-342) at its stated scale (README.md:4-6).

The small-config digested ratio (~0.76-1.45x vs CPU) is a cache artifact:
a digested 5 Mbp reference indexes to ~1.1 Mbp, which fits the CPU's LLC.
This config digests the 2.1 Gbp scale pangenome (-> ~450 Mbp promoted
text), so the CPU is DRAM-bound again, and measures both sides.

  device  digest text+reads, build index (cached), fused classify on GPU
  cpu     32-thread-extrapolated native baseline on the same digested index
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

CACHE = os.path.join(REPO, ".bench_cache", "digested_scale")
B, L = 131072, 1024


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def _assets():
    """Digested text/raw-index/reads, cached (CPU-only; built once)."""
    import bench
    from spumoni_tpu.io.minimizers import digest_packed, digest_promotion
    from spumoni_tpu.io.fastx_batch import PackedReads
    from spumoni_tpu.native import RawIndex, build_raw_index

    os.makedirs(CACHE, exist_ok=True)
    raw_path = os.path.join(CACHE, "raw.npz")
    reads_path = os.path.join(CACHE, "dreads.npz")
    if os.path.exists(raw_path) and os.path.exists(reads_path):
        d = np.load(raw_path)
        raw = RawIndex(int(d["n"]), d["run_heads"], d["run_starts"],
                       d["thresholds"], d["samples_start"], d["samples_last"])
        r = np.load(reads_path)
        return raw, r["buf"], r["offs"]

    t0 = time.time()
    text = bench._scale_text()
    log(f"scale text regenerated ({time.time()-t0:.0f} s)")
    dtext = np.frombuffer(digest_promotion(text.tobytes()), np.uint8)
    log(f"digested: {len(text)/1e9:.2f} Gbp -> {len(dtext)/1e6:.0f} Mbp "
        f"({time.time()-t0:.0f} s)")
    # digested reads via the whole-batch production path
    reads = bench.make_reads(np.random.default_rng(1), text, B, L)
    buf = reads.reshape(-1)
    offs = np.arange(B + 1, dtype=np.int64) * L
    pk = digest_packed(PackedReads([str(i) for i in range(B)], buf, offs),
                       True, False)
    np.savez(reads_path, buf=pk.buf, offs=pk.offs)
    log(f"reads digested ({time.time()-t0:.0f} s)")
    del text, reads
    raw = build_raw_index(dtext)
    log(f"index built: n={raw.n} r={raw.r} ({time.time()-t0:.0f} s)")
    np.savez(raw_path, n=raw.n, run_heads=raw.run_heads,
             run_starts=raw.run_starts, thresholds=raw.thresholds,
             samples_start=raw.samples_start, samples_last=raw.samples_last)
    return raw, pk.buf, pk.offs


def device(args):
    import jax
    import jax.numpy as jnp
    from spumoni_tpu.engine.layered import build_layered
    from spumoni_tpu.engine.scan_engine import _pack_rows
    from spumoni_tpu.index.format import build_dense_index
    from spumoni_tpu.parallel.mesh import fused_classify_kernel
    from spumoni_tpu.utils import present_chars

    raw, buf, offs = _assets()
    t0 = time.time()
    dense = build_dense_index(raw)
    arrays, meta, host = build_layered(dense)
    log(f"layered index resident ({time.time()-t0:.0f} s)")

    lens = np.diff(offs)
    Ld = 256
    rev = _pack_rows(buf, offs, np.arange(B), B, Ld, reverse=True)
    lens = np.minimum(lens, Ld)
    alphabet = tuple(sorted({0} | set(int(c) for c in host.index_chars)
                            | set(int(x) for x in present_chars(rev))))
    ctab = host.table_for_alphabet(alphabet)
    rev = host.rank_map(alphabet)[rev]
    rev_d = jax.device_put(rev)
    lens_d = jax.device_put(jnp.asarray(lens))
    rp = int(arrays.fields.shape[0])
    bin_width, thr = 150, 4

    def step():
        return fused_classify_kernel(arrays, rev_d, lens_d, thr, meta,
                                     "pml", rp, bin_width, ctab)

    f, a, b_, s = step()
    found = np.asarray(f)
    log(f"first step done ({time.time()-t0:.0f} s); "
        f"pos_found={found[::2].mean():.4f} neg_found={found[1::2].mean():.4f}")
    assert found[::2].mean() > 0.95 and found[1::2].mean() < 0.05, \
        (found[::2].mean(), found[1::2].mean())
    reps, t1 = 3, time.time()
    for _ in range(reps):
        f, a, b_, s = step()
    np.asarray(f)
    dt = (time.time() - t1) / reps
    res = {"metric": "pml_digested_classify_reads_per_s_chip_scale",
           "value": round(B / dt, 2),
           "unit": "reads/s (1024bp raw, promotion-digested, 2.1 Gbp ref)"}
    print(json.dumps(res), flush=True)
    with open(os.path.join(CACHE, "device_result.json"), "w") as f_:
        json.dump(res, f_)


def cpu(args):
    import subprocess

    _assets()  # ensure cache
    n_reads = 64
    code = f"""
import os, sys, time
import numpy as np
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
from spumoni_tpu.native import NativeQueryEngine
d = np.load(os.path.join({CACHE!r}, "raw.npz"))
eng = NativeQueryEngine(int(d["n"]), d["run_heads"], d["run_starts"],
                        d["thresholds"], d["samples_start"], d["samples_last"])
r = np.load(os.path.join({CACHE!r}, "dreads.npz"))
buf, offs = r["buf"], r["offs"]
reads = [buf[offs[i]:offs[i+1]].tobytes() for i in range({n_reads})]
threads = os.cpu_count() or 1
eng.query_pml(reads[:4], threads=threads)
t0 = time.time()
eng.query_pml(reads, threads=threads)
print(len(reads) / (time.time() - t0) / threads)
"""
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    per_thread = float(out.stdout.strip().splitlines()[-1])
    res = {"metric": "pml_digested_cpu32_reads_per_s_scale",
           "value": round(per_thread * 32, 2),
           "unit": "reads/s (1024bp raw, 32-thread linear extrapolation)"}
    print(json.dumps(res), flush=True)
    with open(os.path.join(CACHE, "cpu_result.json"), "w") as f_:
        json.dump(res, f_)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cmd", choices=["device", "cpu", "assets",
                                    "device_doc", "cpu_doc",
                                    "doc_assets"])
    args = ap.parse_args()
    if args.cmd in ("assets", "doc_assets"):
        os.environ["JAX_PLATFORMS"] = "cpu"
        (_assets if args.cmd == "assets" else _doc_assets)()
        return
    {"device": device, "cpu": cpu, "device_doc": device_doc,
     "cpu_doc": cpu_doc}[args.cmd](args)




# --------------------------------------------------------------------------
# doc_scale: BASELINE config 5 — minimizer-digested + doc-array MULTI-CLASS
# at genome scale. Documents are 8 x 260 Mbp
# genomes at 2% pairwise divergence (distinct enough that a read's majority
# doc id is a meaningful class verdict; 0.2%-divergent strains would tie).
# Digestion is per-document, matching RefBuilder's per-input digestion
# (refbuilder.cpp:33-218), then concatenated with an .fdi-style length
# table feeding the DocumentArray (doc_array.cpp:18-108).
# --------------------------------------------------------------------------
CACHE_DOC = os.path.join(os.path.dirname(CACHE), "doc_scale")
NDOCS, DOC_LEN, DOC_DIV = 8, 260_000_000, 0.02
B_DOC = 65536


def _doc_assets():
    from spumoni_tpu.io.minimizers import digest_packed, digest_promotion
    from spumoni_tpu.io.fastx_batch import PackedReads
    from spumoni_tpu.native import RawIndex, build_raw_index
    from spumoni_tpu.index.format import build_doc_arrays

    os.makedirs(CACHE_DOC, exist_ok=True)
    raw_path = os.path.join(CACHE_DOC, "raw.npz")
    reads_path = os.path.join(CACHE_DOC, "dreads.npz")
    if os.path.exists(raw_path) and os.path.exists(reads_path):
        d = np.load(raw_path)
        raw = RawIndex(int(d["n"]), d["run_heads"], d["run_starts"],
                       d["thresholds"], d["samples_start"],
                       d["samples_last"])
        r = np.load(reads_path)
        return (raw, d["doc_lens"], d["start_doc"], d["end_doc"],
                r["buf"], r["offs"], r["src_doc"])

    rng = np.random.default_rng(7)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    t0 = time.time()
    base = rng.choice(acgt, size=DOC_LEN)
    docs_digested, doc_lens = [], []
    read_parts, src_doc = [], []
    n_per_doc = B_DOC // NDOCS
    L = 1024
    for di in range(NDOCS):
        g = base.copy()
        if di:
            mut = rng.random(DOC_LEN) < DOC_DIV
            g[mut] = rng.choice(acgt, size=int(mut.sum()))
        dg = np.frombuffer(digest_promotion(g.tobytes()), np.uint8)
        docs_digested.append(dg)
        doc_lens.append(len(dg))
        # positive reads from THIS doc (8% sequencing error), raw DNA
        starts = rng.integers(0, DOC_LEN - L, size=n_per_doc // 2)
        pos = g[starts[:, None] + np.arange(L)[None, :]].copy()
        mut = rng.random(pos.shape) < 0.08
        pos[mut] = rng.choice(acgt, size=int(mut.sum()))
        neg = rng.choice(acgt, size=(n_per_doc - n_per_doc // 2, L))
        read_parts.append(pos)
        read_parts.append(neg)
        src_doc.extend([di] * (n_per_doc // 2))
        src_doc.extend([-1] * (n_per_doc - n_per_doc // 2))
        log(f"doc {di}: digested {DOC_LEN/1e6:.0f} Mbp -> "
            f"{len(dg)/1e6:.1f} Mbp ({time.time()-t0:.0f} s)")
        del g
    dtext = np.concatenate(docs_digested)
    del docs_digested
    reads = np.concatenate(read_parts)
    del read_parts
    src_doc = np.asarray(src_doc, np.int32)
    buf = reads.reshape(-1)
    offs = np.arange(len(reads) + 1, dtype=np.int64) * L
    pk = digest_packed(
        PackedReads([str(i) for i in range(len(reads))], buf, offs),
        True, False)
    np.savez(reads_path, buf=pk.buf, offs=pk.offs, src_doc=src_doc)
    log(f"reads digested ({time.time()-t0:.0f} s)")
    del reads, buf
    raw = build_raw_index(dtext)
    log(f"doc index built: n={raw.n} r={raw.r} ({time.time()-t0:.0f} s)")
    ds, de = build_doc_arrays(raw, doc_lens)
    np.savez(raw_path, n=raw.n, run_heads=raw.run_heads,
             run_starts=raw.run_starts, thresholds=raw.thresholds,
             samples_start=raw.samples_start, samples_last=raw.samples_last,
             doc_lens=np.asarray(doc_lens, np.int64),
             start_doc=ds, end_doc=de)
    return (raw, np.asarray(doc_lens), ds, de, pk.buf, pk.offs, src_doc)


def device_doc(args):
    """Digested + doc-array multi-class at scale: v2 layered scan with doc
    tracking (the digested alphabet's sigma > 8 rules out the v4 row
    formats — the measured reason this config cannot ride the one-gather
    engine), on-device bin-max verdict + majority-doc class."""
    import jax
    import jax.numpy as jnp
    from spumoni_tpu.engine.layered import build_layered
    from spumoni_tpu.engine.scan_engine import (_pack_rows,
                                                query_batch_kernel_v2)
    from spumoni_tpu.index.format import build_dense_index
    from spumoni_tpu.utils import present_chars

    raw, doc_lens, ds, de, buf, offs, src_doc = _doc_assets()
    t0 = time.time()
    dense = build_dense_index(raw, doc_start=ds, doc_end=de)
    arrays, meta, host = build_layered(dense)
    log(f"layered+doc index resident ({time.time()-t0:.0f} s)")

    lens = np.diff(offs)[:B_DOC]
    Ld = 256
    rev = _pack_rows(buf, offs, np.arange(B_DOC), B_DOC, Ld, reverse=True)
    lens = np.minimum(lens, Ld)
    alphabet = tuple(sorted({0} | set(int(c) for c in host.index_chars)
                            | set(int(x) for x in present_chars(rev))))
    ctab = host.table_for_alphabet(alphabet)
    rev = host.rank_map(alphabet)[rev]
    rev_d = jax.device_put(rev)
    lens_d = jax.device_put(jnp.asarray(lens))
    # thr=3: each document appears ONCE here (8 docs at 2% pairwise
    # divergence), so positive PMLs run shorter than the 14-near-copy
    # digested config that supports thr=4; bin-max still separates
    # cleanly (neg_found = 0 measured)
    bin_width, thr = 150, 3
    nd = len(doc_lens)

    import functools

    @functools.partial(jax.jit, static_argnames=("meta",))
    def verdicts(arrays, ctab, meta, rev_, lens_):
        # arrays/ctab as ARGUMENTS: a closure would capture the 6.6 GB
        # index as lowered constants (baked into the executable)
        vals, docs, _ = query_batch_kernel_v2(arrays, rev_, meta, "pml",
                                              True, ctab)
        iota = jnp.arange(vals.shape[1])[None, :]
        act = (iota < lens_[:, None]) & (vals >= thr)
        # majority doc over above-threshold positions: nd counts per lane
        counts = jnp.stack(
            [jnp.sum(act & (docs == di), axis=1) for di in range(nd)],
            axis=1)
        best = jnp.argmax(counts, axis=1)
        # bin-max FOUND verdict (same rule as fused_classify_kernel)
        nbins = -(-Ld // bin_width)
        bidx = jnp.minimum(iota // bin_width, nbins - 1)
        binmax = jnp.stack(
            [jnp.max(jnp.where((bidx == b_) & (iota < lens_[:, None]),
                               vals, -1), axis=1) for b_ in range(nbins)],
            axis=1)
        has = jnp.sum(binmax >= 0, axis=1)
        above = jnp.sum(binmax > thr, axis=1)
        found = above * 2 > has
        return found, best

    found, best = verdicts(arrays, ctab, meta, rev_d, lens_d)
    found, best = np.asarray(found), np.asarray(best)
    log(f"first step done ({time.time()-t0:.0f} s)")
    pos = src_doc >= 0
    pos_found = float(found[pos].mean())
    neg_found = float(found[~pos].mean())
    doc_acc = float((best[pos & found] ==
                     src_doc[pos & found]).mean())
    log(f"pos_found={pos_found:.4f} neg_found={neg_found:.4f} "
        f"doc_acc={doc_acc:.4f}")
    # 2% pairwise divergence is a deliberately HARD multi-class setting:
    # ~98% of any read's positions lie in sequence shared by all 8 docs,
    # where the run-boundary doc id is arbitrary among them
    # (doc_array.cpp:18-108 semantics) — majority-doc accuracy rises with
    # document distinctness (the reference's multi-species use case)
    # single-copy documents + 8% read error leave digested positive PMLs
    # short (the 14-near-copy digested config reaches 0.95+ found; one-copy
    # docs measure 0.82 at thr=3 with neg = 0.0) — assert the SEPARATION,
    # report the absolute rates in the result
    assert pos_found > 0.75 and neg_found < 0.05, (pos_found, neg_found)
    assert doc_acc > 0.60, doc_acc

    reps, t1 = 3, time.time()
    for _ in range(reps):
        found, best = verdicts(arrays, ctab, meta, rev_d, lens_d)
    np.asarray(found)
    dt = (time.time() - t1) / reps
    res = {"metric": "pml_digested_doc_multiclass_reads_per_s_chip_scale",
           "value": round(B_DOC / dt, 2),
           "unit": (f"reads/s (1024bp raw, promotion-digested, {nd} docs x "
                    f"{DOC_LEN/1e6:.0f} Mbp, pos_found={pos_found:.3f}, "
                    f"neg_found={neg_found:.3f}, doc_acc={doc_acc:.3f})")}
    print(json.dumps(res), flush=True)
    with open(os.path.join(CACHE_DOC, "device_result.json"), "w") as f_:
        json.dump(res, f_)


def cpu_doc(args):
    import subprocess

    _doc_assets()  # ensure cache
    n_reads = 64
    code = f"""
import os, sys, time
import numpy as np
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
from spumoni_tpu.native import NativeQueryEngine
d = np.load(os.path.join({CACHE_DOC!r}, "raw.npz"))
eng = NativeQueryEngine(int(d["n"]), d["run_heads"], d["run_starts"],
                        d["thresholds"], d["samples_start"], d["samples_last"],
                        start_doc=d["start_doc"], end_doc=d["end_doc"])
r = np.load(os.path.join({CACHE_DOC!r}, "dreads.npz"))
buf, offs = r["buf"], r["offs"]
reads = [buf[offs[i]:offs[i+1]].tobytes() for i in range({n_reads})]
threads = os.cpu_count() or 1
eng.query_pml(reads[:4], with_docs=True, threads=threads)
t0 = time.time()
eng.query_pml(reads, with_docs=True, threads=threads)
print(len(reads) / (time.time() - t0) / threads)
"""
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    per_thread = float(out.stdout.strip().splitlines()[-1])
    res = {"metric": "pml_digested_doc_cpu32_reads_per_s_scale",
           "value": round(per_thread * 32, 2),
           "unit": "reads/s (1024bp raw, 32-thread linear extrapolation)"}
    print(json.dumps(res), flush=True)
    with open(os.path.join(CACHE_DOC, "cpu_result.json"), "w") as f_:
        json.dump(res, f_)


if __name__ == "__main__":
    main()
