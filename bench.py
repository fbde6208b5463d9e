#!/usr/bin/env python
"""Benchmark: PML classification throughput on one GPU vs multithreaded CPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

Workload (mirrors BASELINE.json config 3, pangenome classification):
  * synthetic 5-strain pangenome (5 x 1 Mbp, 1% divergence) -> ~1M-run index
  * 131072 nanopore-like reads of 1024 bp (half mutated substrings @ 8% error,
    half random) per batch
  * measured path: device-resident reads -> lockstep PML scan (engine v4
    block-bits: ONE 208-byte occ/char/threshold-bit row gather per step +
    SWAR popcount rank, blockbits.py) -> on-device bin-max classification ->
    per-read verdict summaries to host (O(B) transfer)

Baseline: the in-repo native CPU engine (same recurrence as reference
SPUMONI's query loop, rank/select via binary search), measured with all local
cores and extrapolated linearly to the 32 threads of BASELINE.md. The
extrapolation favors the CPU (real scaling is sublinear), so vs_baseline is
conservative.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache")
SCALE_CACHE = os.path.join(CACHE, "scale")
N_STRAINS = 5
STRAIN_LEN = 1_000_000
B, L = 131072, 1024
BASELINE_THREADS = 32


def get_index():
    import spumoni_tpu  # noqa: F401
    from spumoni_tpu.native import build_raw_index, RawIndex

    os.makedirs(CACHE, exist_ok=True)
    path = os.path.join(CACHE, f"pangenome_{N_STRAINS}x{STRAIN_LEN}.npz")
    rng = np.random.default_rng(0)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, size=STRAIN_LEN)
    copies = [base]
    for _ in range(N_STRAINS - 1):
        c = base.copy()
        mut = rng.random(len(c)) < 0.01
        c[mut] = rng.choice(acgt, size=int(mut.sum()))
        copies.append(c)
    text = np.concatenate(copies)
    if os.path.exists(path):
        d = np.load(path)
        raw = RawIndex(int(d["n"]), d["run_heads"], d["run_starts"],
                       d["thresholds"], d["samples_start"], d["samples_last"])
    else:
        raw = build_raw_index(text)
        np.savez(path, n=raw.n, run_heads=raw.run_heads,
                 run_starts=raw.run_starts, thresholds=raw.thresholds,
                 samples_start=raw.samples_start,
                 samples_last=raw.samples_last)
    return raw, text, rng


def make_reads(rng, text, n_reads, read_len):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    tb = text.tobytes()
    out = np.empty((n_reads, read_len), dtype=np.uint8)
    for i in range(n_reads):
        if i % 2 == 0:
            st = int(rng.integers(0, len(tb) - read_len))
            rd = np.frombuffer(tb[st:st + read_len], np.uint8).copy()
            mut = rng.random(read_len) < 0.08
            rd[mut] = rng.choice(acgt, size=int(mut.sum()))
            out[i] = rd
        else:
            out[i] = rng.choice(acgt, size=read_len)
    return out


def bench_device(raw, text, rng):
    import jax
    import jax.numpy as jnp
    from spumoni_tpu.index.format import build_dense_index
    from spumoni_tpu.engine.blockbits import build_blockbits
    from spumoni_tpu.parallel.mesh import fused_classify_kernel

    dense = build_dense_index(raw)
    arrays, meta, host = build_blockbits(dense)

    reads = make_reads(rng, text, B, L)
    rev = np.ascontiguousarray(reads[:, ::-1])
    # block-bits reads are query-rank mapped on the host
    alphabet = tuple(sorted({0} | set(int(x) for x in np.unique(rev))))
    ctab = host.table_for_alphabet(alphabet)
    rev = host.rank_map(alphabet)[rev]
    lens = np.full((B,), L, dtype=np.int64)

    bin_width, thr = 150, 7
    rp = int(arrays.bblocks.shape[0])

    def step(rev_d, lens_d):
        return fused_classify_kernel(arrays, rev_d, lens_d, thr, meta, "pml",
                                     rp, bin_width, ctab)

    rev_d = jax.device_put(jnp.asarray(rev))
    lens_d = jax.device_put(jnp.asarray(lens))
    jax.block_until_ready((rev_d, lens_d))
    found, above, below, _ = step(rev_d, lens_d)   # compile + warm
    found = np.asarray(found)
    n_found = int(found.sum())
    assert 0 < n_found < B, "classification degenerate"
    # positives are even lanes: sanity check separation
    assert found[::2].mean() > 0.95 and found[1::2].mean() < 0.05, \
        (found[::2].mean(), found[1::2].mean())

    reps = 3
    t0 = time.time()
    for _ in range(reps):
        found, above, below, _ = step(rev_d, lens_d)
    np.asarray(found)
    dt = (time.time() - t0) / reps
    return B / dt, B * L / dt


def bench_cpu(raw, text, rng):
    """Measured in a CLEAN SUBPROCESS: the JAX runtime keeps background
    threads busy, which starves an in-process CPU measurement on small hosts
    and would inflate vs_baseline."""
    import subprocess

    n_reads = 256
    reads = np.stack([np.frombuffer(r, np.uint8) if isinstance(r, bytes)
                      else r for r in make_reads(rng, text, n_reads, L)])
    tmp = os.path.join(CACHE, "cpu_bench_in.npz")
    np.savez(tmp, reads=reads, n=raw.n, run_heads=raw.run_heads,
             run_starts=raw.run_starts, thresholds=raw.thresholds,
             samples_start=raw.samples_start, samples_last=raw.samples_last)
    code = f"""
import os, sys, time
import numpy as np
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
from spumoni_tpu.native import NativeQueryEngine
d = np.load({tmp!r})
eng = NativeQueryEngine(int(d["n"]), d["run_heads"], d["run_starts"],
                        d["thresholds"], d["samples_start"], d["samples_last"])
reads = [r.tobytes() for r in d["reads"]]
threads = os.cpu_count() or 1
eng.query_pml(reads[:16], threads=threads)
t0 = time.time()
eng.query_pml(reads, threads=threads)
dt = time.time() - t0
print(len(reads) / dt / threads)
"""
    # spumoni_tpu's package __init__ imports jax: keep the child on the CPU
    # platform so it never opens the GPU the parent holds
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, env=env)
    per_thread = float(out.stdout.strip().splitlines()[-1])
    return per_thread * BASELINE_THREADS  # linear extrapolation to 32 threads


def bench_device_ms(raw, text, rng):
    """Full MS mode (BASELINE config 2): pointer scan + text extension —
    the production engine selection (v4-MS scan + rows512 two-gather
    extension, as pipeline.run auto-selects)."""
    import jax
    import jax.numpy as jnp
    from spumoni_tpu.engine.blockbits import build_blockbits
    from spumoni_tpu.engine.scan_engine import (build_text_rows512,
                                                extend_pointers_sweep,
                                                query_batch_kernel_v4ms)
    from spumoni_tpu.index.format import build_dense_index

    B_ms = 65536
    dense = build_dense_index(raw, text=text, with_samples=True)
    arrays, meta, host = build_blockbits(dense, want_ms=True)
    nt = int(arrays.text.shape[0])
    tw = build_text_rows512(arrays.text, nt)

    reads = make_reads(rng, text, B_ms, L)
    rev = np.ascontiguousarray(reads[:, ::-1])
    alphabet = tuple(sorted({0} | set(int(x) for x in np.unique(rev))))
    ctab = host.table_for_alphabet(alphabet)
    rev_d = jax.device_put(jnp.asarray(host.rank_map(alphabet)[rev]))
    fwd_d = jax.device_put(jnp.asarray(reads))
    lens_d = jax.device_put(jnp.asarray(np.full((B_ms,), L, np.int32)))

    def step():
        ptrs, _, _ = query_batch_kernel_v4ms(arrays, rev_d, meta, "ms",
                                             False, ctab)
        lens_ = extend_pointers_sweep(tw, fwd_d, lens_d, ptrs[:, ::-1], nt,
                                      None, text_two_gather=True)
        return lens_

    np.asarray(step()[:1])  # compile + warm
    reps, t0 = 3, time.time()
    for _ in range(reps):
        out = step()
    np.asarray(out[:1])
    dt = (time.time() - t0) / reps
    return B_ms / dt


def bench_cpu_ms(raw, text, rng):
    import subprocess

    n_reads = 64
    reads = np.stack(list(make_reads(rng, text, n_reads, L)))
    tmp = os.path.join(CACHE, "cpu_bench_ms_in.npz")
    np.savez(tmp, reads=reads, text=text, n=raw.n, run_heads=raw.run_heads,
             run_starts=raw.run_starts, thresholds=raw.thresholds,
             samples_start=raw.samples_start, samples_last=raw.samples_last)
    code = f"""
import os, sys, time
import numpy as np
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
from spumoni_tpu.native import NativeQueryEngine
d = np.load({tmp!r})
eng = NativeQueryEngine(int(d["n"]), d["run_heads"], d["run_starts"],
                        d["thresholds"], d["samples_start"], d["samples_last"],
                        text=d["text"])
reads = [r.tobytes() for r in d["reads"]]
threads = os.cpu_count() or 1
eng.query_ms(reads[:8], threads=threads)
t0 = time.time()
eng.query_ms(reads, threads=threads)
print(len(reads) / (time.time() - t0) / threads)
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, env=env)
    return float(out.stdout.strip().splitlines()[-1]) * BASELINE_THREADS


def bench_e2e(raw, text, rng):
    """End-to-end: reads FILE -> batched host decode -> device scan ->
    async writer (values file + bin-max report) — the full
    `spumoni run -P -n -c` path including all host IO (the reference
    comparison is end-to-end, BASELINE.md)."""
    import tempfile

    from spumoni_tpu.index.format import build_dense_index, save_dense_index
    from spumoni_tpu.index.null_db import EmpNullDatabase
    from spumoni_tpu.pipeline import RunConfig, run

    n_reads = 65536
    d = tempfile.mkdtemp(prefix="spumoni_e2e_")
    prefix = os.path.join(d, "idx")
    dense = build_dense_index(raw)
    save_dense_index(dense, prefix + ".fa.thrbv.spumoni")
    ndb = EmpNullDatabase(rng.integers(0, 7, 4000).astype(np.int64))
    ndb.ks_stat_threshold = 0.1
    ndb.save(prefix + ".fa.pmlnulldb")
    reads_path = os.path.join(d, "reads.fa")
    reads = make_reads(rng, text, n_reads, L)
    with open(reads_path, "w") as f:
        for i in range(n_reads):
            f.write(f">r{i}\n{reads[i].tobytes().decode()}\n")

    # 2 batches of 32k reads: big kernels (a scan step costs about the same
    # at 8k or 64k lanes, so reads/s grows with B) while the
    # prefetch (decode+stage) and writer threads still overlap across the
    # batch boundary
    cfg = dict(ref_file=prefix, pattern_file=reads_path, pml_requested=True,
               min_digest=False, write_report=True, batch_bases=33_554_432)
    run(RunConfig(**cfg))          # warm (compile + caches)
    t0 = time.time()
    run(RunConfig(**cfg))
    dt = time.time() - t0
    assert os.path.getsize(reads_path + ".pseudo_lengths") > n_reads * L
    # report-only counterpart: the classify-only serving path (O(B)
    # summaries leave the device; no value files) — reported on stderr
    cfg_ro = dict(cfg, report_only=True)
    run(RunConfig(**cfg_ro))
    t1 = time.time()
    run(RunConfig(**cfg_ro))
    dt_ro = time.time() - t1
    print(json.dumps({
        "metric": "pml_e2e_report_only_reads_per_s",
        "value": round(n_reads / dt_ro, 2),
        "unit": "reads/s (1024bp)",
    }), file=sys.stderr, flush=True)
    return n_reads / dt


def _digested_setup(text, rng, n_reads):
    """Promotion-minimizer digestion (the reference's default mode for large
    references, spumoni.cpp:294-319): digest the pangenome AND the reads
    with bonsai-semantics k=4 w=11 minimizers; reads shrink ~4.6x and the
    index alphabet grows to sigma~200 (exercises the layered engine's full
    one-hot root path — block-bits needs sigma <= 8 and won't be picked)."""
    import spumoni_tpu  # noqa: F401
    from spumoni_tpu.io.minimizers import digest_promotion
    from spumoni_tpu.native import build_raw_index

    dtext = np.frombuffer(digest_promotion(text.tobytes()), np.uint8)
    raw_d = build_raw_index(dtext)
    reads = make_reads(rng, text, n_reads, L)
    dreads = [digest_promotion(reads[i].tobytes()) for i in range(n_reads)]
    return raw_d, dtext, dreads


def bench_device_digested(text, rng):
    import jax
    import jax.numpy as jnp
    from spumoni_tpu.index.format import build_dense_index
    from spumoni_tpu.engine.layered import build_layered
    from spumoni_tpu.parallel.mesh import fused_classify_kernel

    # the digested 5 Mbp reference indexes to ~1.1 Mbp, which fits the
    # CPU's last-level cache, so this config favours the CPU baseline
    B_d = int(os.environ.get("SPUMONI_BENCH_DIGESTED_B", 65536))
    raw_d, dtext, dreads = _digested_setup(text, rng, B_d)
    dense = build_dense_index(raw_d)
    arrays, meta, host = build_layered(dense)

    Ld = 256  # digested 1024 bp reads run ~180-230 symbols
    rev = np.zeros((B_d, Ld), dtype=np.uint8)
    lens = np.zeros((B_d,), dtype=np.int64)
    for i, rd in enumerate(dreads):
        a = np.frombuffer(rd, np.uint8)[:Ld]
        rev[i, :len(a)] = a[::-1]
        lens[i] = len(a)
    alphabet = tuple(sorted({0} | set(host.index_chars)
                            | set(int(x) for x in np.unique(rev))))
    ctab = host.table_for_alphabet(alphabet)
    rev = host.rank_map(alphabet)[rev]

    bin_width, thr = 150, 4
    rp = int(arrays.fields.shape[0])

    def step(rev_d, lens_d):
        return fused_classify_kernel(arrays, rev_d, lens_d, thr, meta, "pml",
                                     rp, bin_width, ctab)

    rev_d = jax.device_put(jnp.asarray(rev))
    lens_d = jax.device_put(jnp.asarray(lens))
    np.asarray(lens_d[:1])
    found, above, below, _ = step(rev_d, lens_d)   # compile + warm
    found = np.asarray(found)
    assert found[::2].mean() > 0.95 and found[1::2].mean() < 0.05, \
        (found[::2].mean(), found[1::2].mean())

    reps, t0 = 3, time.time()
    for _ in range(reps):
        found, above, below, _ = step(rev_d, lens_d)
    np.asarray(found)
    dt = (time.time() - t0) / reps
    return B_d / dt


def bench_cpu_digested(text, rng):
    import subprocess

    n_reads = 512
    raw_d, dtext, dreads = _digested_setup(text, rng, n_reads)
    tmp = os.path.join(CACHE, "cpu_bench_dig_in.npz")
    np.savez(tmp, n=raw_d.n, run_heads=raw_d.run_heads,
             run_starts=raw_d.run_starts, thresholds=raw_d.thresholds,
             samples_start=raw_d.samples_start,
             samples_last=raw_d.samples_last,
             reads=np.array([r.hex() for r in dreads]))
    code = f"""
import os, sys, time
import numpy as np
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
from spumoni_tpu.native import NativeQueryEngine
d = np.load({tmp!r})
eng = NativeQueryEngine(int(d["n"]), d["run_heads"], d["run_starts"],
                        d["thresholds"], d["samples_start"], d["samples_last"])
reads = [bytes.fromhex(str(h)) for h in d["reads"]]
threads = os.cpu_count() or 1
eng.query_pml(reads[:16], threads=threads)
t0 = time.time()
eng.query_pml(reads, threads=threads)
print(len(reads) / (time.time() - t0) / threads)
"""
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    per_thread = float(out.stdout.strip().splitlines()[-1])
    return per_thread * BASELINE_THREADS


def bench_cpu_e2e(raw, text, rng):
    """CPU counterpart of bench_e2e, e2e-on-both-sides: the
    SAME file -> decode -> query -> classify -> value-file+report pipeline
    (pipeline.run with device='cpu' -> NativeQueryEngine), reader and writer
    on the critical path exactly like the reference's omp-critical loops
    (compute_ms_pml.cpp:901,1001-1021). Clean subprocess;
    measured with all local cores, extrapolated linearly to 32 — linear
    scaling favors the CPU (the reference serializes output under a critical
    section, so its real writer does NOT scale)."""
    import subprocess
    import tempfile

    from spumoni_tpu.index.format import build_dense_index, save_dense_index
    from spumoni_tpu.index.null_db import EmpNullDatabase

    n_reads = 2048
    d = tempfile.mkdtemp(prefix="spumoni_e2e_cpu_")
    prefix = os.path.join(d, "idx")
    dense = build_dense_index(raw)
    save_dense_index(dense, prefix + ".fa.thrbv.spumoni")
    ndb = EmpNullDatabase(rng.integers(0, 7, 4000).astype(np.int64))
    ndb.ks_stat_threshold = 0.1
    ndb.save(prefix + ".fa.pmlnulldb")
    reads_path = os.path.join(d, "reads.fa")
    reads = make_reads(rng, text, n_reads, L)
    with open(reads_path, "w") as f:
        for i in range(n_reads):
            f.write(f">r{i}\n{reads[i].tobytes().decode()}\n")

    code = f"""
import os, sys, time
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
os.environ["JAX_PLATFORMS"] = "cpu"
from spumoni_tpu.pipeline import RunConfig, run
cfg = dict(ref_file={prefix!r}, pattern_file={reads_path!r},
           pml_requested=True, min_digest=False, write_report=True,
           device="cpu", threads=os.cpu_count() or 1)
run(RunConfig(**cfg))                    # warm (mmap/page caches)
t0 = time.time()
run(RunConfig(**cfg))
print({n_reads} / (time.time() - t0))
"""
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    per_all = float(out.stdout.strip().splitlines()[-1])
    ncpu = os.cpu_count() or 1
    return per_all * (BASELINE_THREADS / ncpu)


def _scale_ready():
    return all(os.path.exists(os.path.join(SCALE_CACHE, f))
               for f in ("bb.npz", "raw.npz", "reads.npz"))


def bench_device_scale():
    """Human-genome-scale PML classify (BASELINE.md's stated >=5x target is
    "on a human-genome PML index"): 2.1 Gbp / r~1.5e8 synthetic pangenome,
    prebuilt by scripts/build_scale.py, engine v4 over-cliff (P=512: one
    400-byte row gather per step). Index rows = 1.64 GB device-resident."""
    import jax
    import jax.numpy as jnp
    from spumoni_tpu.engine.blockbits import BitArrays, BitMeta
    from spumoni_tpu.engine.occblock import OccHost
    from spumoni_tpu.parallel.mesh import fused_classify_kernel

    d = np.load(os.path.join(SCALE_CACHE, "bb.npz"))
    P, width, sigma, pack, term_pos, term_code, F_term = (
        int(x) for x in d["meta"])
    meta = BitMeta(P=P, width=width, sigma=sigma, pack=pack, dtype="int32",
                   term_pos=term_pos, term_code=term_code, F_term=F_term)
    arrays = BitArrays(
        bblocks=jax.device_put(d["bblocks"]),
        n=jnp.asarray(d["n"]),
        last_run_sample=jnp.asarray(d["last_run_sample"]),
        last_run_edoc=jnp.asarray(d["last_run_edoc"]),
        first_run_sdoc=jnp.asarray(d["first_run_sdoc"]))
    host = OccHost(F_all=d["F_all"], cnt_all=d["cnt_all"], rmap=d["rmap"],
                   F_sigma=d["F_sigma"], Fnext_sigma=d["Fnext_sigma"],
                   index_chars=tuple(int(c) for c in d["index_chars"]))

    reads = np.load(os.path.join(SCALE_CACHE, "reads.npz"))["reads"]
    rev = np.ascontiguousarray(reads[:, ::-1])
    alphabet = tuple(sorted({0} | set(int(x) for x in np.unique(rev))))
    ctab = host.table_for_alphabet(alphabet)
    rev = host.rank_map(alphabet)[rev]
    lens = np.full((B,), L, dtype=np.int64)

    bin_width, thr = 150, 7
    rp = int(arrays.bblocks.shape[0])

    def step(rev_d, lens_d):
        return fused_classify_kernel(arrays, rev_d, lens_d, thr, meta, "pml",
                                     rp, bin_width, ctab)

    t_tr = time.time()
    rev_d = jax.device_put(np.ascontiguousarray(rev))
    lens_d = jax.device_put(jnp.asarray(lens))
    np.asarray(lens_d[:1])
    print(f"  transfers done ({time.time() - t_tr:.0f} s)", file=sys.stderr,
          flush=True)
    found, above, below, _ = step(rev_d, lens_d)   # compile + warm
    found = np.asarray(found)
    print(f"  first step done ({time.time() - t_tr:.0f} s)", file=sys.stderr,
          flush=True)
    assert found[::2].mean() > 0.95 and found[1::2].mean() < 0.05, \
        (found[::2].mean(), found[1::2].mean())

    reps = 3
    t0 = time.time()
    for _ in range(reps):
        found, above, below, _ = step(rev_d, lens_d)
    np.asarray(found)
    dt = (time.time() - t0) / reps
    return B / dt


def bench_cpu_scale():
    """32-thread-extrapolated CPU baseline on the SAME 2.1 Gbp index (clean
    subprocess, same methodology as bench_cpu). At this scale the index is
    ~3 GB — every rank probe of the reference-style query loop misses LLC,
    which is exactly why BASELINE.md pins the >=5x target to a human-genome
    index. Linear thread extrapolation still FAVORS the CPU: 32 threads of
    random DRAM misses contend for memory channels."""
    import subprocess

    n_reads = 32
    code = f"""
import os, sys, time
import numpy as np
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
from spumoni_tpu.native import NativeQueryEngine
d = np.load(os.path.join({SCALE_CACHE!r}, "raw.npz"))
eng = NativeQueryEngine(int(d["n"]), d["run_heads"], d["run_starts"],
                        d["thresholds"], d["samples_start"], d["samples_last"])
reads = [r.tobytes()
         for r in np.load(os.path.join({SCALE_CACHE!r}, "reads.npz"))["reads"][:{n_reads}]]
threads = os.cpu_count() or 1
eng.query_pml(reads[:2], threads=threads)
rates = []
for _ in range(3):
    t0 = time.time()
    eng.query_pml(reads, threads=threads)
    rates.append(len(reads) / (time.time() - t0) / threads)
rates.sort()
print(rates[1])   # median of 3: single-shot DRAM-bound rates vary ~1.6x
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, env=env)
    per_thread = float(out.stdout.strip().splitlines()[-1])
    return per_thread * BASELINE_THREADS


def _scale_text():
    """Regenerate the scale config's 2.1 Gbp pangenome text deterministically
    (bit-identical to scripts/build_scale.py gen_text: same rng seed, params,
    and draw order), so the 2.1 GB text never has to live in the cache.
    The generation params come from raw.npz when recorded there (cache built
    with non-default --strains/--mbp/--div would otherwise silently mismatch
    the regenerated text); caches from before the params were recorded fall
    back to the defaults they were built with."""
    n_strains, strain_len, div = 14, 150_000_000, 0.002
    d = np.load(os.path.join(SCALE_CACHE, "raw.npz"))
    if "gen_params" in d.files:
        gp = d["gen_params"]
        n_strains, strain_len, div = int(gp[0]), int(gp[1]), float(gp[2])
    rng = np.random.default_rng(0)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, size=strain_len)
    parts = [base]
    for _ in range(n_strains - 1):
        c = base.copy()
        mut = rng.random(strain_len) < div
        c[mut] = rng.choice(acgt, size=int(mut.sum()))
        parts.append(c)
    return np.concatenate(parts)


def bench_device_ms_scale():
    """Full MS mode (-M: pointer scan + text extension) at human-genome
    scale — the 2.1 Gbp / r~1.5e8 index of the scale config.  Engine
    v4-MS runs the pointer scan (ONE dependent row gather per step + one
    independent msrow gather that pipelines with it — vs v2's five
    over-cliff probes, the round-4 ms_scale bottleneck) and the
    bulk-sweep extension compares against the [nt/512, 128]-u32 text rows
    (build_text_rows512: device memory = the text bytes, 2.1 GB; serves
    both the 64 B bulk pass and the 256 B long-tail windows). Device
    memory: rows 1.6 GB + msrows 1.1 GB + jump table 1.2 GB + text rows
    2.1 GB."""
    import jax
    import jax.numpy as jnp
    from spumoni_tpu.engine.blockbits import _assemble_blockbits, _build_msrows
    from spumoni_tpu.engine.scan_engine import (extend_pointers_sweep,
                                                query_batch_kernel_v4ms)
    from spumoni_tpu.index.format import build_dense_index
    from spumoni_tpu.native import RawIndex

    B_ms = 65536
    t0 = time.time()
    text = _scale_text()
    print(f"  text regenerated ({time.time() - t0:.0f} s)", file=sys.stderr,
          flush=True)
    d = np.load(os.path.join(SCALE_CACHE, "raw.npz"))
    raw = RawIndex(int(d["n"]), d["run_heads"], d["run_starts"],
                   d["thresholds"], d["samples_start"], d["samples_last"])
    dense = build_dense_index(raw, with_samples=True)  # no text: the
    # extension reads the rows512 table below, not arrays.text
    bb = np.load(os.path.join(SCALE_CACHE, "bb.npz"))
    P_bb, _, _, pack_bb = (int(x) for x in bb["meta"][:4])
    msrows = _build_msrows(dense, P_bb, pack_bb)
    arrays, meta, host = _assemble_blockbits(dense, bb["bblocks"], P_bb,
                                             pack_bb, False, msrows=msrows,
                                             want_ms=True)
    print(f"  v4-MS index resident ({time.time() - t0:.0f} s)",
          file=sys.stderr, flush=True)

    # host-built NON-overlapping [rows, 128]-u32 text rows
    # (build_text_rows512 layout): device memory = the text bytes (2.1 GB),
    # where the [rows, 17]-u64 overlapped table holds 2.125x the text
    nt = len(text)
    rows = -(-nt // 512) + 1
    t_ = np.concatenate([text, np.zeros(rows * 512 - nt, np.uint8)])
    tw_host = np.ascontiguousarray(t_.view(np.uint32).reshape(rows, 128))
    del t_
    tw = jax.device_put(tw_host)
    del tw_host
    print(f"  text rows resident ({time.time() - t0:.0f} s)",
          file=sys.stderr, flush=True)

    reads = np.load(os.path.join(SCALE_CACHE, "reads.npz"))["reads"][:B_ms]
    rev = np.ascontiguousarray(reads[:, ::-1])
    alphabet = tuple(sorted({0} | set(int(x) for x in np.unique(rev))))
    ctab = host.table_for_alphabet(alphabet)
    rev_d = jax.device_put(host.rank_map(alphabet)[rev])
    fwd_d = jax.device_put(jnp.asarray(reads))
    lens_d = jax.device_put(jnp.asarray(np.full((B_ms,), L, np.int32)))

    def step():
        ptrs, _, _ = query_batch_kernel_v4ms(arrays, rev_d, meta, "ms",
                                             False, ctab)
        return extend_pointers_sweep(tw, fwd_d, lens_d, ptrs[:, ::-1], nt,
                                     None, text_two_gather=True)

    out = step()                        # compile + warm
    lengths = np.asarray(out)           # one-time d2h for the sanity check
    print(f"  first step done ({time.time() - t0:.0f} s)", file=sys.stderr,
          flush=True)
    # exactness spot check: a few reads against the native oracle (random
    # reads on a 2.1 Gbp index average MS ~ log4(n) ~ 15.6, so a LARGE
    # statistical pos/neg gap does not exist at this scale — exact equality
    # is the meaningful check)
    from spumoni_tpu.native import NativeQueryEngine
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last, text=text)
    ncheck = 4
    _, nat_lens = native.query_ms(
        [reads[i].tobytes() for i in range(ncheck)], threads=2)[:2]
    for i in range(ncheck):
        assert np.array_equal(lengths[i], nat_lens[i]), f"read {i} differs"
    pos_mean = float(lengths[::2].mean())
    neg_mean = float(lengths[1::2].mean())
    assert pos_mean > neg_mean, (pos_mean, neg_mean)
    print(f"  exact vs native on {ncheck} reads; pos_mean={pos_mean:.1f} "
          f"neg_mean={neg_mean:.1f}", file=sys.stderr, flush=True)

    reps, t1 = 2, time.time()
    for _ in range(reps):
        out = step()
    np.asarray(out[:1])
    dt = (time.time() - t1) / reps
    return B_ms / dt


def bench_cpu_ms_scale():
    """32-thread-extrapolated CPU MS (-M) on the same 2.1 Gbp index (same
    methodology as bench_cpu_scale; the native engine's extension reads the
    text directly, like the reference's SLP random access)."""
    import subprocess

    n_reads = 32
    code = f"""
import os, sys, time
import numpy as np
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
import bench
from spumoni_tpu.native import NativeQueryEngine
d = np.load(os.path.join({SCALE_CACHE!r}, "raw.npz"))
eng = NativeQueryEngine(int(d["n"]), d["run_heads"], d["run_starts"],
                        d["thresholds"], d["samples_start"], d["samples_last"],
                        text=bench._scale_text())
reads = [r.tobytes()
         for r in np.load(os.path.join({SCALE_CACHE!r}, "reads.npz"))["reads"][:{n_reads}]]
threads = os.cpu_count() or 1
eng.query_ms(reads[:2], threads=threads)
t0 = time.time()
eng.query_ms(reads, threads=threads)
print(len(reads) / (time.time() - t0) / threads)
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, env=env)
    per_thread = float(out.stdout.strip().splitlines()[-1])
    return per_thread * BASELINE_THREADS


def _scale_line():
    dev = bench_device_scale()
    cpu32 = bench_cpu_scale()
    return {
        "metric": "pml_classify_reads_per_s_chip_human_scale",
        "value": round(dev, 2),
        "unit": "reads/s (1024bp, 2.1Gbp r=1.5e8 index)",
        "vs_baseline": round(dev / cpu32, 3),
    }


def main():
    import jax

    if jax.default_backend() != "gpu":
        # a measurement without the GPU is no measurement: never fall back
        raise SystemExit(f"bench.py measures the GPU; JAX's backend is "
                         f"{jax.default_backend()!r}")
    cfg = os.environ.get("SPUMONI_BENCH_CONFIG")
    if cfg == "scale":
        # BASELINE.md's ">=5x ... on a human-genome PML index" config alone
        print(json.dumps(_scale_line()))
        return
    if cfg == "ms_scale":
        # full MS (-M) at human-genome scale
        dev = bench_device_ms_scale()
        cpu32 = bench_cpu_ms_scale()
        print(json.dumps({
            "metric": "ms_full_reads_per_s_chip_human_scale",
            "value": round(dev, 2),
            "unit": "reads/s (1024bp, 2.1Gbp r=1.5e8 index)",
            "vs_baseline": round(dev / cpu32, 3),
        }))
        return
    if cfg == "e2e":
        raw, text, rng = get_index()
        dev = bench_e2e(raw, text, rng)
        cpu32 = bench_cpu_e2e(raw, text, rng)  # e2e-on-both-sides: the same
        # file->report pipeline.run driven by the native CPU engine
        print(json.dumps({
            "metric": "pml_e2e_file_to_report_reads_per_s",
            "value": round(dev, 2),
            "unit": "reads/s (1024bp)",
            "vs_baseline": round(dev / cpu32, 3),
        }))
        return
    if cfg == "digested":
        # BASELINE config 5: minimizer-digested index (promotion scheme)
        raw, text, rng = get_index()
        dev = bench_device_digested(text, rng)
        cpu32 = bench_cpu_digested(text, rng)
        print(json.dumps({
            "metric": "pml_digested_classify_reads_per_s_chip",
            "value": round(dev, 2),
            "unit": "reads/s (1024bp raw, promotion-digested)",
            "vs_baseline": round(dev / cpu32, 3),
        }))
        return
    if cfg == "ms":
        # BASELINE config 2: full MS (-M) — pointers + extended lengths
        raw, text, rng = get_index()
        dev = bench_device_ms(raw, text, rng)
        cpu32 = bench_cpu_ms(raw, text, rng)
        print(json.dumps({
            "metric": "ms_full_reads_per_s_chip",
            "value": round(dev, 2),
            "unit": "reads/s (1024bp)",
            "vs_baseline": round(dev / cpu32, 3),
        }))
        return
    # default: the human-scale config is the headline whenever its prebuilt
    # cache exists (scripts/build_scale.py; BASELINE.md pins the >=5x target
    # to a human-genome index). The 5 Mbp config is always measured too and
    # reported on stderr so regressions in the small config stay visible;
    # stdout carries exactly ONE JSON line (the headline) for the driver.
    raw, text, rng = get_index()
    dev_reads_s, dev_bases_s = bench_device(raw, text, rng)
    cpu32_reads_s = bench_cpu(raw, text, rng)
    small = {
        "metric": "pml_classify_reads_per_s_chip",
        "value": round(dev_reads_s, 2),
        "unit": "reads/s (1024bp)",
        "vs_baseline": round(dev_reads_s / cpu32_reads_s, 3),
    }
    # GRCh38-scale (6.2 Gbp through pipeline.build/run): report the latest
    # measured artifacts on stderr when present (scripts/grch38_scale.py
    # run/cpu write them; re-measuring inline would add ~12 min of index
    # load + upload per bench invocation)
    g38 = os.path.join(CACHE, "grch38")
    try:
        with open(os.path.join(g38, "run_result.json")) as f:
            gr = json.load(f)
        with open(os.path.join(g38, "cpu_result.json")) as f:
            gc = json.load(f)
        gr["vs_baseline_stream"] = round(
            gr.get("stream_reads_per_s", 0) / max(gc["value"], 1e-9), 3)
        print(json.dumps(gr), file=sys.stderr, flush=True)
        print(json.dumps(gc), file=sys.stderr, flush=True)
    except (OSError, KeyError, ValueError):
        pass
    if _scale_ready():
        print(json.dumps(small), file=sys.stderr, flush=True)
        print(json.dumps(_scale_line()))
    else:
        print(json.dumps(small))


if __name__ == "__main__":
    main()
