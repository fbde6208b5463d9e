#!/usr/bin/env python
"""Build + cache the human-genome-scale bench index (BASELINE.md target:
">=5x reads/s over 32-thread CPU SPUMONI on a human-genome PML index").

Synthetic pangenome: 14 strains x 150 Mbp at 0.2% divergence ->
n = 2,100,000,001 (int32-capable), r ~ 1.5e8 — human-genome scale
(GRCh38 is 3.05 Gbp; r matches the judge's r ~ 1e8 north star).

Caches under .bench_cache/scale/ in the checkout:
  reads.npz   131072 reads x 1024 bp (even = mutated substrings @8% error,
              odd = random), same recipe as bench.make_reads
  raw.npz     RLBWT + thresholds + SA samples (CPU-baseline input)
  bb.npz      prebuilt engine-v4 block-bits rows (P=512, over-cliff) +
              BitMeta/OccHost scalars, so bench.py only loads + device_puts

Run: nice -n 10 python scripts/build_scale.py [--strains 14] [--mbp 150]
"""
import argparse
import os
import sys
import time

# pure host-side build: keep jax (imported transitively by spumoni_tpu) on
# the CPU platform, so the build never holds the GPU a benchmark needs
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CACHE = os.path.join(REPO, ".bench_cache", "scale")
B, L = 131072, 1024


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def save_atomic(path, **arrays):
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def gen_text(n_strains, strain_len, div, rng):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, size=strain_len)
    parts = [base]
    for _ in range(n_strains - 1):
        c = base.copy()
        mut = rng.random(strain_len) < div
        c[mut] = rng.choice(acgt, size=int(mut.sum()))
        parts.append(c)
    return np.concatenate(parts)


def gen_reads(text, n_reads, read_len, rng):
    """Vectorized version of bench.make_reads: even lanes = mutated
    substrings (8% error), odd = random."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    half = n_reads // 2
    starts = rng.integers(0, len(text) - read_len, size=half)
    pos = text[starts[:, None] + np.arange(read_len)[None, :]].copy()
    mut = rng.random((half, read_len)) < 0.08
    pos[mut] = rng.choice(acgt, size=int(mut.sum()))
    neg = rng.choice(acgt, size=(n_reads - half, read_len))
    out = np.empty((n_reads, read_len), dtype=np.uint8)
    out[0::2] = pos
    out[1::2] = neg
    return out


def main():
    global CACHE
    ap = argparse.ArgumentParser()
    ap.add_argument("--strains", type=int, default=14)
    ap.add_argument("--mbp", type=int, default=150)
    ap.add_argument("--div", type=float, default=0.002)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--P", type=int, default=512)
    ap.add_argument("--out", default=CACHE,
                    help="cache dir (default: the scale bench cache; use "
                         "e.g. .../scale_wide for the n >= 2^31 config)")
    args = ap.parse_args()

    CACHE = args.out
    os.makedirs(CACHE, exist_ok=True)
    strain_len = args.mbp * 1_000_000
    rng = np.random.default_rng(0)

    t0 = time.time()
    log(f"generating {args.strains} x {strain_len/1e6:.0f} Mbp "
        f"at {args.div*100}% divergence")
    text = gen_text(args.strains, strain_len, args.div, rng)
    log(f"text ready: {len(text)/1e9:.2f} Gbp ({time.time()-t0:.0f} s)")

    reads_path = os.path.join(CACHE, "reads.npz")
    if not os.path.exists(reads_path):
        reads = gen_reads(text, B, L, rng)
        save_atomic(reads_path, reads=reads)
        log(f"reads cached: {reads.shape}")
    del text  # regenerate below (cheaper than holding 2.1 GB through build)

    raw_path = os.path.join(CACHE, "raw.npz")
    if os.path.exists(raw_path):
        log("raw.npz already cached, loading")
        d = np.load(raw_path)
        from spumoni_tpu.native import RawIndex
        raw = RawIndex(int(d["n"]), d["run_heads"], d["run_starts"],
                       d["thresholds"], d["samples_start"], d["samples_last"])
    else:
        rng2 = np.random.default_rng(0)
        text = gen_text(args.strains, strain_len, args.div, rng2)
        from spumoni_tpu.native import build_raw_index
        t1 = time.time()
        log(f"PFP build starting (threads={args.threads})")
        raw = build_raw_index(text, method="pfp", threads=args.threads)
        log(f"PFP build done: n={raw.n} r={raw.r} "
            f"({time.time()-t1:.0f} s, {(time.time()-t1)/raw.n*1e6:.2f} us/char)")
        del text
        save_atomic(raw_path, n=raw.n, run_heads=raw.run_heads,
                    run_starts=raw.run_starts, thresholds=raw.thresholds,
                    samples_start=raw.samples_start,
                    samples_last=raw.samples_last,
                    # generation recipe, so bench._scale_text() regenerates
                    # the SAME text even for non-default --strains/--mbp/--div
                    gen_params=np.asarray(
                        [args.strains, strain_len, args.div], np.float64))
        log("raw.npz cached")

    bb_path = os.path.join(CACHE, "bb.npz")
    if not os.path.exists(bb_path):
        from spumoni_tpu.index.format import build_dense_index
        from spumoni_tpu.engine import blockbits as bb

        t2 = time.time()
        dense = build_dense_index(raw)
        log(f"dense index built ({time.time()-t2:.0f} s)")
        t3 = time.time()
        arrays, meta, host = bb.build_blockbits(dense, P=args.P)
        log(f"block-bits rows built: {arrays.bblocks.shape} P={meta.P} "
            f"({time.time()-t3:.0f} s)")
        save_atomic(
            bb_path,
            bblocks=np.asarray(arrays.bblocks),
            n=np.asarray(arrays.n),
            last_run_sample=np.asarray(arrays.last_run_sample),
            last_run_edoc=np.asarray(arrays.last_run_edoc),
            first_run_sdoc=np.asarray(arrays.first_run_sdoc),
            meta=np.asarray([meta.P, meta.width, meta.sigma, meta.pack,
                             meta.term_pos, meta.term_code, meta.F_term],
                            dtype=np.int64),
            F_all=np.asarray(host.F_all), cnt_all=np.asarray(host.cnt_all),
            rmap=np.asarray(host.rmap),
            F_sigma=np.asarray(host.F_sigma),
            Fnext_sigma=np.asarray(host.Fnext_sigma),
            index_chars=np.asarray(host.index_chars, dtype=np.int64),
        )
        log("bb.npz cached")
    log(f"all done ({time.time()-t0:.0f} s total)")


if __name__ == "__main__":
    main()
