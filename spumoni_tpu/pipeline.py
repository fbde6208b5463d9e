"""Build / run orchestration — the L5 layer of the framework
(counterpart of build_main/run_main in /root/reference/src/spumoni.cpp:553-755).

Differences from the reference by design:
  * no subprocess helper binaries — index construction is the in-process
    native library: SA-IS + LCP sweep, or the prefix-free-parsing induction
    (--build-method pfp) for references past the SA-IS memory budget;
  * idempotent build stages keyed by a content hash of the generated
    reference (the analog of the reference's 19-temp-file "quick build",
    spumoni.cpp:570-601);
  * querying runs on the GPU lockstep engines by default (`device='gpu'`),
    with the multithreaded native CPU engine as `device='cpu'` — the
    baseline and the oracle. A missing GPU is an error, never a silent
    switch to the host.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time

import numpy as np

from .constants import (DEFAULT_BIN_SIZE, DEFAULT_MIN_K, DEFAULT_MIN_W,
                        MAX_BIN_SIZE, MIN_BIN_SIZE)
from .glibc_rand import GlibcRand
from .index import refbuilder
from .index.format import (DenseIndex, build_dense_index, build_doc_arrays,
                           load_dense_index, save_dense_index)
from .index.null_db import EmpNullDatabase
from .classify import binmax
from .classify.kstest import KSTest, find_ks_threshold
from .classify.report import (report_header, report_line, write_values_record)
from .io.fasta import batch_iter, iter_query_reads
from .io.minimizers import digest
from .native import NativeQueryEngine, build_raw_index


def log(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


#: stats of the most recent run()'s streaming loop (see run())
LAST_RUN_STATS: dict = {}


class DeviceUnavailable(RuntimeError):
    """device='gpu' asked for on a process where JAX found no GPU."""


def check_device(device: str) -> None:
    """device='gpu' runs the JAX engines and needs JAX's GPU backend. The
    one exception is a caller that restricted JAX to the CPU platform
    itself (JAX_PLATFORMS=cpu, as the test suite does): the JAX engines
    then run on the host because they were asked to. device='cpu' is the
    native engine and needs nothing."""
    if device == "cpu":
        return
    if device != "gpu":
        raise ValueError(f"unknown device {device!r}: expected gpu or cpu")
    import jax
    backend = jax.default_backend()
    if backend == "gpu" or (backend == "cpu"
                            and jax.config.jax_platforms == "cpu"):
        return
    raise DeviceUnavailable(
        f"--device gpu needs a GPU, but JAX's default backend is "
        f"{backend!r}; use --device cpu for the native CPU engine")


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BuildConfig:
    """Mirror of SpumoniBuildOptions (spumoni_main.hpp:134-231)."""
    ref_file: str = ""
    input_list: str = ""
    output_prefix: str = ""
    ms_index: bool = False
    pml_index: bool = False
    build_doc: bool = False
    use_minimizers: bool = True
    use_promotions: bool = False
    use_dna_letters: bool = False
    is_general_text: bool = False
    use_rev_comp: bool = True
    keep_files: bool = False
    k: int = DEFAULT_MIN_K
    w: int = DEFAULT_MIN_W
    bin_size: int = DEFAULT_BIN_SIZE
    verbose: bool = False
    build_method: str = "auto"  # 'auto' | 'sais' | 'pfp' (native builder path)
    emit_ref_formats: bool = False  # also write the reference binary's
                                    # .bwt.heads/.bwt.len/.thr_pos/.ssa/.esa
                                    # intermediates (index/interchange.py)

    def validate(self) -> None:
        if not self.ref_file and not self.input_list:
            raise ValueError("a reference file (-r) or file list (-i) is required")
        if self.ref_file and not os.path.isfile(self.ref_file):
            raise FileNotFoundError(self.ref_file)
        if self.input_list and not os.path.isfile(self.input_list):
            raise FileNotFoundError(self.input_list)
        if not self.output_prefix:
            raise ValueError("an output prefix (-o) is required")
        if not self.ms_index and not self.pml_index:
            raise ValueError("at least one index type (-M or -P) is required")
        # -d with a single reference file needs a pre-made .fa.fdi
        # (spumoni_main.hpp:186-196); otherwise the doc-array build would
        # only fail later with a missing-.fdi error.
        if (self.build_doc and self.ref_file and not self.input_list
                and not os.path.isfile(self.output_prefix + ".fa.fdi")):
            raise ValueError(
                "cannot build a document array (-d) when indexing a single "
                "file unless a *.fa.fdi file is provided for it; use a file "
                "list (-i) instead")
        if self.use_minimizers and not self.is_general_text:
            if self.use_promotions and self.use_dna_letters:
                raise ValueError("only one minimizer type may be specified")
            if not self.use_promotions and not self.use_dna_letters:
                raise ValueError("a minimizer type (-m or -a) is required, "
                                 "or disable digestion with -n")
        else:
            if self.use_promotions or self.use_dna_letters:
                raise ValueError("minimizer type given but digestion disabled")
        if self.k > 4:
            raise ValueError("small window size (k) cannot exceed 4")
        if self.w < self.k:
            raise ValueError("large window (w) must be >= small window (k)")
        if not MIN_BIN_SIZE <= self.bin_size <= MAX_BIN_SIZE:
            raise ValueError(f"bin size must be in [{MIN_BIN_SIZE},{MAX_BIN_SIZE}]")


def _ref_paths(cfg: BuildConfig):
    parent = os.path.dirname(os.path.abspath(cfg.output_prefix))
    name = os.path.basename(cfg.output_prefix)
    ext = ".bin" if cfg.use_promotions else ".fa"
    ref_path = os.path.join(parent, name + ext)
    null_path = os.path.join(parent, "spumoni_null_reads.fa")
    return ref_path, null_path


def build(cfg: BuildConfig) -> str:
    """Runs the full build; returns the built-reference path (the run-time
    index prefix is that path)."""
    cfg.validate()
    t_start = time.time()
    ref_path, null_path = _ref_paths(cfg)
    rand = GlibcRand(0)  # process-wide rand() state (refbuilder.cpp:84)

    # ---- reference preparation (L4) ----
    if cfg.input_list:
        log("build_main", f"input: list of files ({cfg.input_list})")
        res = refbuilder.build_reference_from_filelist(
            cfg.input_list, ref_path, null_path, cfg.build_doc,
            cfg.use_promotions, cfg.use_dna_letters, cfg.k, cfg.w,
            cfg.use_rev_comp, rand=rand)
    elif not cfg.is_general_text:
        log("build_main", f"input: single reference file ({cfg.ref_file})")
        refbuilder.parse_null_reads(cfg.ref_file, null_path, rand=rand)
        res = refbuilder.build_reference(cfg.ref_file, ref_path,
                                         cfg.use_promotions,
                                         cfg.use_dna_letters, cfg.k, cfg.w,
                                         cfg.use_rev_comp)
        res.null_read_path = null_path
    else:
        log("build_main", "general text reference used directly")
        refbuilder.parse_null_reads_from_general_text(cfg.ref_file, null_path,
                                                      rand=rand)
        ref_path = cfg.ref_file
        with open(cfg.ref_file, "rb") as f:
            text = np.frombuffer(f.read(), dtype=np.uint8)
        res = refbuilder.RefBuildResult(ref_path, text, null_path)
        res.null_read_path = null_path

    # ---- index construction (replaces PFP/pfp_thresholds subprocesses) ----
    text = res.text
    # SA-IS is in-memory: ~13 bytes/char peak with 32-bit indexes
    # (n < 2^31), ~26 beyond. The PFP path (build_method='pfp', auto-selected
    # for very large texts) needs only O(parse + dict) working memory.
    from .native import PFP_AUTO_THRESHOLD
    uses_sais = cfg.build_method == "sais" or (
        cfg.build_method == "auto"
        and not (len(text) > PFP_AUTO_THRESHOLD and len(text) > 0
                 and int(text.min()) >= 3))
    if uses_sais:
        try:
            avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
            need = (13 if len(text) < 2**31 - 2 else 26) * len(text)
            if need > avail:
                raise MemoryError(
                    f"SA-IS construction needs ~{need / 1e9:.1f} GB "
                    f"({len(text) / 1e6:.0f} Mbp reference) but only "
                    f"{avail / 1e9:.1f} GB RAM is available; use "
                    f"--build-method pfp (O(parse+dict) memory)")
        except (ValueError, OSError):
            pass
    content_hash = hashlib.sha256(text.tobytes()).hexdigest()[:16]
    raw = _build_raw_cached(ref_path, text, content_hash, cfg.build_method)
    n, r = raw.n, raw.r
    log("build_main", f"bwt statistics: r = {r}, n = {n}, n/r = {n / r:.3f}")

    if cfg.emit_ref_formats:
        from .index.interchange import export_reference_index
        paths = export_reference_index(raw, ref_path)
        log("build_main", "wrote reference-format intermediates: "
            + ", ".join(os.path.basename(p) for p in paths))

    # ---- document array (L2, doc_array.cpp) ----
    doc_start = doc_end = None
    if cfg.build_doc:
        fdi = res.fdi_path or (ref_path + ".fdi")
        seq_lengths = refbuilder.read_fdi(fdi)
        doc_start, doc_end = build_doc_arrays(raw, seq_lengths)

    # CPU engine used for null-DB generation (build-time self-query,
    # spumoni.cpp:654); the build never needs the device.
    cpu_engine = NativeQueryEngine(
        raw.n, raw.run_heads, raw.run_starts, raw.thresholds,
        raw.samples_start, raw.samples_last, start_doc=doc_start,
        end_doc=doc_end, text=text)
    threads = os.cpu_count() or 1

    if cfg.ms_index:
        log("build_ms", "building the MS index")
        dense = build_dense_index(raw, text=text, with_samples=True,
                                  doc_start=doc_start, doc_end=doc_end)
        save_dense_index(dense, ref_path + ".thrbv.ms")
        _write_stats(dense, cfg.output_prefix + ".ms_index_stats.txt")

        log("build_main", "building the empirical null statistic database for MS")
        qfn = lambda reads: cpu_engine.query_ms(reads, threads=threads)[1]
        null_db = EmpNullDatabase.from_null_reads(
            qfn, res.null_read_path, cfg.use_promotions, cfg.use_dna_letters,
            cfg.k, cfg.w, cfg.is_general_text)
        if not cfg.is_general_text:
            null_db.ks_stat_threshold = find_ks_threshold(
                qfn, res.null_read_path, null_db, cfg.bin_size,
                cfg.use_promotions, cfg.use_dna_letters, cfg.k, cfg.w,
                rand=rand)
        else:
            null_db.ks_stat_threshold = 0.10
        null_db.save(ref_path + ".msnulldb")

    if cfg.pml_index:
        log("build_pml", "building the PML index")
        dense = build_dense_index(raw, with_samples=False,
                                  doc_start=doc_start, doc_end=doc_end)
        save_dense_index(dense, ref_path + ".thrbv.spumoni")
        _write_stats(dense, cfg.output_prefix + ".pml_index_stats.txt")

        log("build_main", "building the empirical null statistic database for PML")
        qfn = lambda reads: cpu_engine.query_pml(reads, threads=threads)
        null_db = EmpNullDatabase.from_null_reads(
            qfn, res.null_read_path, cfg.use_promotions, cfg.use_dna_letters,
            cfg.k, cfg.w, cfg.is_general_text)
        if not cfg.is_general_text:
            null_db.ks_stat_threshold = find_ks_threshold(
                qfn, res.null_read_path, null_db, cfg.bin_size,
                cfg.use_promotions, cfg.use_dna_letters, cfg.k, cfg.w,
                rand=rand)
        else:
            null_db.ks_stat_threshold = 0.10
        null_db.save(ref_path + ".pmlnulldb")

    if cfg.build_doc:
        np.savez(ref_path + ".doc.npz", start_runs_doc=doc_start,
                 end_runs_doc=doc_end)

    if not cfg.keep_files:
        _rm_temp_files(ref_path)
    log("build_main", f"total elapsed time for build process (s): "
                      f"{time.time() - t_start:.3f}")
    return ref_path


def _build_raw_cached(ref_path: str, text: np.ndarray, content_hash: str,
                      method: str = "auto"):
    """Quick-build analog: cache the raw index keyed by the text hash."""
    from .native import RawIndex
    cache = ref_path + ".rawindex.npz"
    if os.path.exists(cache):
        data = np.load(cache)
        if str(data.get("content_hash")) == content_hash:
            log("build_main", "quick build is activated (raw index cache hit)")
            return RawIndex(int(data["n"]), data["run_heads"],
                            data["run_starts"], data["thresholds"],
                            data["samples_start"], data["samples_last"])
    raw = build_raw_index(text, method=method)
    np.savez(cache, content_hash=content_hash, n=raw.n,
             run_heads=raw.run_heads, run_starts=raw.run_starts,
             thresholds=raw.thresholds, samples_start=raw.samples_start,
             samples_last=raw.samples_last)
    return raw


def import_reference_build(cfg: BuildConfig) -> str:
    """Builds run-ready indexes from a reference binary's intermediate files
    (<ref_file>.bwt.heads/.bwt.len/.thr_pos/.ssa/.esa) — i.e. resumes a
    reference `spumoni build` at the point after pfp_thresholds ran
    (spumoni.cpp:524-545). `cfg.ref_file` is the built-reference path the
    intermediates are named after (usually `<prefix>.fa`); indexes are
    written next to it so `run -r <prefix>` works unchanged.

    The empirical null databases are rebuilt from `spumoni_null_reads.fa`
    in the same directory when present (the reference keeps it for its own
    quick-build, spumoni.cpp:570-601); without it, value-output runs work
    but classification (-c) has no threshold source."""
    from .index.interchange import import_reference_index

    ref_path = cfg.ref_file
    raw = import_reference_index(ref_path,
                                 with_samples=cfg.ms_index)
    n, r = raw.n, raw.r
    log("import_ref", f"imported reference intermediates: r = {r}, n = {n}, "
                      f"n/r = {n / r:.3f}")

    text = None
    if cfg.ms_index and os.path.isfile(ref_path):
        with open(ref_path, "rb") as f:
            t = np.frombuffer(f.read(), dtype=np.uint8)
        if len(t) + 1 != n and len(t) and t[0] == ord(">"):
            # the built reference is a FASTA (RefBuilder's .fa output,
            # refbuilder.cpp:318): the indexed text is the concatenation of
            # its record sequences
            from .io.fasta import read_fastx
            t = np.frombuffer(
                b"".join(rec.seq for rec in read_fastx(ref_path)), np.uint8)
        if len(t) + 1 == n:
            text = t
        else:
            log("import_ref", f"WARNING: {ref_path} is {len(t)} bytes but "
                              f"the BWT implies a {n - 1}-byte text; MS runs "
                              f"will emit pointers without lengths")

    doc_start = doc_end = None
    if cfg.build_doc:
        # rebuild the document array from the imported SA samples + the
        # .fdi sequence boundaries, exactly like the reference's -d build
        # (doc_array.cpp:18-108 consumes .ssa/.esa + .fdi) — or, without an
        # .fdi, read the reference's own serialized .doc directly
        # (doc_array.cpp:184-201)
        fdi = ref_path + ".fdi"
        doc_file = ref_path + ".doc"
        if os.path.isfile(fdi):
            seq_lengths = refbuilder.read_fdi(fdi)
            doc_start, doc_end = build_doc_arrays(raw, seq_lengths)
        elif os.path.isfile(doc_file):
            from .index.interchange import read_reference_doc
            doc_start, doc_end = read_reference_doc(doc_file)
            if len(doc_start) != r:
                raise ValueError(f"{doc_file} holds {len(doc_start)} "
                                 f"entries for {r} runs")
            log("import_ref", f"document array read from {doc_file}")
        else:
            raise FileNotFoundError(f"-d import needs {fdi} or {doc_file}")
        np.savez(ref_path + ".doc.npz", start_runs_doc=doc_start,
                 end_runs_doc=doc_end)

    null_path = os.path.join(os.path.dirname(os.path.abspath(ref_path)),
                             "spumoni_null_reads.fa")
    have_nulls = os.path.isfile(null_path)
    engine = None
    if have_nulls:
        engine = NativeQueryEngine(
            raw.n, raw.run_heads, raw.run_starts, raw.thresholds,
            raw.samples_start, raw.samples_last, text=text)
    else:
        # no null reads: fall back to the reference's own serialized null
        # databases (emp_null_database.cpp:82-141) so a reference-built
        # index classifies without spumoni_null_reads.fa
        from .index.interchange import read_reference_nulldb
        converted = []
        for want_ms, ext in ((True, ".msnulldb"), (False, ".pmlnulldb")):
            if want_ms and not cfg.ms_index:
                continue
            if not want_ms and not cfg.pml_index:
                continue
            src = ref_path + ext
            if not os.path.isfile(src):
                continue
            d = read_reference_nulldb(src)
            db = EmpNullDatabase(d["null_stats"])
            # keep the reference's RECORDED scalars (its mean/percentile
            # computation is definitionally ours, but trust the file)
            db.ks_stat_threshold = d["ks_stat_threshold"]
            db.mean_null_stat = d["mean_null_stat"]
            db.percentile_value = d["percentile_value"]
            db.save(src)
            converted.append(ext)
        if converted:
            log("import_ref", "null databases read from the reference's "
                              f"serialized {'/'.join(converted)}")
        else:
            log("import_ref", f"WARNING: {null_path} not found and no "
                              f"reference .msnulldb/.pmlnulldb to read; "
                              f"skipping the null databases "
                              f"(classification runs need them)")

    threads = os.cpu_count() or 1
    rand = GlibcRand(0)
    for want_ms in (True, False):
        if want_ms and not cfg.ms_index:
            continue
        if not want_ms and not cfg.pml_index:
            continue
        kind = "ms" if want_ms else "spumoni"
        dense = build_dense_index(raw, text=text if want_ms else None,
                                  with_samples=want_ms,
                                  doc_start=doc_start, doc_end=doc_end)
        save_dense_index(dense, f"{ref_path}.thrbv.{kind}")
        _write_stats(dense, cfg.output_prefix
                     + (".ms" if want_ms else ".pml") + "_index_stats.txt")
        if have_nulls:
            if want_ms:
                qfn = lambda reads: engine.query_ms(reads, threads=threads)[1]
            else:
                qfn = lambda reads: engine.query_pml(reads, threads=threads)
            null_db = EmpNullDatabase.from_null_reads(
                qfn, null_path, cfg.use_promotions, cfg.use_dna_letters,
                cfg.k, cfg.w, cfg.is_general_text)
            null_db.ks_stat_threshold = find_ks_threshold(
                qfn, null_path, null_db, cfg.bin_size,
                cfg.use_promotions, cfg.use_dna_letters, cfg.k, cfg.w,
                rand=rand)
            null_db.save(ref_path + (".msnulldb" if want_ms
                                     else ".pmlnulldb"))
    return ref_path


def _rm_temp_files(ref_path: str) -> None:
    """Counterpart of rm_temp_build_files (spumoni.cpp:502-522)."""
    p = ref_path + ".rawindex.npz"
    if os.path.exists(p):
        os.remove(p)


def _write_stats(dense: DenseIndex, path: str) -> None:
    """*.ms_index_stats.txt / *.pml_index_stats.txt
    (compute_ms_pml.cpp:204-209,532-538)."""
    with open(path, "w") as f:
        for key, val in dense.index_stats().items():
            f.write(f"{key}: {val}\n")


# ---------------------------------------------------------------------------
# run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunConfig:
    """Mirror of SpumoniRunOptions (spumoni_main.hpp:233-330)."""
    ref_file: str = ""        # index prefix (without .fa/.bin)
    pattern_file: str = ""
    ms_requested: bool = False
    pml_requested: bool = False
    use_doc: bool = False
    write_report: bool = False
    min_digest: bool = True
    use_promotions: bool = False
    use_dna_letters: bool = False
    is_general_text: bool = False
    k: int = DEFAULT_MIN_K
    w: int = DEFAULT_MIN_W
    bin_size: int = DEFAULT_BIN_SIZE
    threads: int = 1
    device: str = "gpu"       # 'gpu' (JAX engines) | 'cpu' (native engine)
    batch_bases: int = 33_554_432  # bases per batch: a scan step costs
                              # about the same at 8k or 64k lanes, so
                              # reads/s grows with the lanes per kernel call
    resume: bool = False      # resume from the per-host read cursor
    process_index: int = 0    # multi-host read sharding (parallel.distributed)
    process_count: int = 1
    ks_report: bool = False   # classify via windowed KS test instead of
                              # bin-max (the reference's build-time-live path,
                              # ks_test.cpp + compute_ms_pml.cpp:942-967)
    report_only: bool = False  # -c without value files: classification is
                              # fused on device and only O(B) verdict
                              # summaries cross the host link (extension
                              # flag; the reference always writes values)
    tp_devices: int = 0       # sharded index ("TP", parallel/tp.py):
                              # >1 forces that many devices on the 'model'
                              # axis (index rows sharded, one psum/step);
                              # 0 = auto — engages when the estimated
                              # engine footprint exceeds the per-device
                              # memory budget (utils.hbm_budget).
                              # Classify-only PML or -M value runs: the
                              # escape hatch for indexes past one device.
    engine: str = "auto"      # 'auto' | 'layered' (v2) | 'occ' (v3) |
                              # 'bits' (v4 block-bits / v4-MS).
                              # auto: v4 when eligible, else v2; v3 only
                              # on request (occblock.py)

    @property
    def mode(self) -> str:
        if self.ms_requested and not self.pml_requested:
            return "ms"
        if self.pml_requested and not self.ms_requested:
            return "pml"
        raise ValueError("exactly one of -M or -P must be specified")

    def validate(self) -> None:
        _ = self.mode
        if not self.ref_file or not self.pattern_file:
            raise ValueError("both a reference (-r) and pattern file (-p) "
                             "are required")
        if not os.path.isfile(self.pattern_file):
            raise FileNotFoundError(self.pattern_file)
        if self.min_digest and not self.is_general_text:
            if self.use_promotions and self.use_dna_letters:
                raise ValueError("only one minimizer type may be specified")
            if not self.use_promotions and not self.use_dna_letters:
                raise ValueError("a minimizer type (-m or -a) is required, "
                                 "or disable digestion with -n")
        # general-text restrictions (spumoni_main.hpp:305-310)
        if self.is_general_text and self.min_digest:
            raise ValueError("general-text querying requires -n (no digestion)")
        if self.is_general_text and self.write_report:
            raise ValueError("classification is not available for general text")
        if not MIN_BIN_SIZE <= self.bin_size <= MAX_BIN_SIZE:
            raise ValueError(f"bin size must be in [{MIN_BIN_SIZE},{MAX_BIN_SIZE}]")
        if self.report_only:
            if not self.write_report:
                raise ValueError("--report-only requires -c")
            if self.ks_report:
                raise ValueError("--report-only is bin-max only (the KS "
                                 "statistic needs the full value vectors)")
            if self.use_doc:
                # doc_numbers is a per-position VALUE file
                # (compute_ms_pml.cpp:853-860) — emitting it would defeat
                # --report-only's contract (only O(B) verdicts leave the
                # device). Reject instead of silently dropping the output
                # the user asked for.
                raise ValueError("--report-only cannot produce .doc_numbers "
                                 "(-d writes per-position value files); run "
                                 "without --report-only for doc output")
        if self.tp_devices > 1:
            pml_ok = (self.report_only and self.mode == "pml"
                      and not self.use_doc)
            ms_ok = self.mode == "ms" and not self.report_only
            if not (pml_ok or ms_ok):
                raise ValueError("--tp-devices (sharded index) supports "
                                 "-P -c --report-only without -d "
                                 "(classify-only PML) or -M value runs")
            if self.engine == "occ":
                raise ValueError("--tp-devices supports the layered and "
                                 "block-bits engines")


def _make_engine(cfg: RunConfig, dense: DenseIndex, index_path=None):
    if cfg.device == "cpu":
        ss = _unorder_samples(dense, "c_ssamp")
        es = _unorder_samples(dense, "c_esamp")
        if ss is None:  # PML-only index carries no SA samples
            ss = np.zeros(dense.r, dtype=np.int64)
            es = np.zeros(dense.r, dtype=np.int64)
        eng = NativeQueryEngine(
            dense.n, dense.run_heads, dense.run_starts,
            _unorder(dense, "c_thr"), ss, es,
            start_doc=_unorder(dense, "c_sdoc"),
            end_doc=_unorder(dense, "c_edoc"),
            text=dense.text)

        class _CpuWrapper:
            def query(self, reads):
                out = {}
                if cfg.mode == "pml":
                    if cfg.use_doc:
                        lengths, docs = eng.query_pml(reads, with_docs=True,
                                                      threads=cfg.threads)
                        out["lengths"], out["docs"] = lengths, docs
                    else:
                        out["lengths"] = eng.query_pml(reads,
                                                       threads=cfg.threads)
                else:
                    res = eng.query_ms(reads, with_docs=cfg.use_doc,
                                       threads=cfg.threads)
                    out["pointers"], out["lengths"] = res[0], res[1]
                    if cfg.use_doc:
                        out["docs"] = res[2]
                return out

            def classify(self, reads, bin_width, max_value_thr):
                vals = self.query(reads)["lengths"]
                n = len(reads)
                out = {"found": np.zeros(n, dtype=bool),
                       "above": np.zeros(n, dtype=np.int64),
                       "below": np.zeros(n, dtype=np.int64),
                       "sum_maxes": np.zeros(n, dtype=np.int64)}
                for i in range(n):
                    r_ = binmax.classify(vals[i], bin_width, max_value_thr)
                    out["found"][i] = r_.status == "FOUND"
                    out["above"][i] = r_.bins_above
                    out["below"][i] = r_.bins_below
                    out["sum_maxes"][i] = int(r_.bin_maxes.sum())
                return out
        return _CpuWrapper()

    from .engine.scan_engine import ScanEngine
    if cfg.engine == "occ":
        from .engine import occblock
        if not occblock.eligible(dense):
            raise ValueError("occ engine needs sigma <= 15 and n under the "
                             "gather row-count cliff (use engine=layered)")
        arrays, meta, host = occblock.build_occblock(dense)
    elif cfg.engine == "bits" or (
            cfg.engine == "auto" and _blockbits_eligible(dense)
            and (cfg.mode == "pml" or dense.has_samples)
            and (not cfg.use_doc or dense.has_doc)
            # v4-MS jump ids are int32 (2r+2 slots)
            and (cfg.mode == "pml" and not cfg.use_doc
                 or dense.r < 2**30)):
        from .engine import blockbits
        if not blockbits.eligible_any(dense):
            raise ValueError("block-bits engine needs sigma <= 8 and "
                             "positions under 2^40 (use engine=layered)")
        # the packed-rows build is minutes at genome scale; cache it next
        # to the index (content-keyed) so later runs load it directly
        cache = (index_path + ".bbrows.npz") if index_path else None
        want_ms = cfg.mode == "ms"
        want_doc = cfg.use_doc
        arrays, meta, host = blockbits.build_blockbits(
            dense, cache_path=cache, want_ms=want_ms, want_doc=want_doc,
            ms_cache_path=(index_path + ".bbms.npz")
            if index_path and (want_ms or want_doc) else None,
            src_path=(index_path + ".npz") if index_path else None)
    else:
        from .engine.layered import build_layered
        arrays, meta, host = build_layered(dense)
    return ScanEngine(arrays, meta, mode=cfg.mode, use_doc=cfg.use_doc, host=host)


def _tp_decision(cfg: "RunConfig", dense: DenseIndex) -> int:
    """Model-axis size for the sharded-index path: the explicit
    --tp-devices, or (auto) the smallest power of two whose per-device
    shard fits the memory budget when the estimated engine footprint
    exceeds it. 1 = no TP (a replicated index needs no collective per
    step, so it is the choice whenever the index fits)."""
    pml_ok = cfg.report_only and cfg.mode == "pml" and not cfg.use_doc
    ms_ok = cfg.mode == "ms" and not cfg.report_only
    if cfg.device == "cpu" or not (pml_ok or ms_ok):
        return 1  # validate() rejects tp_devices > 1 outside these combos
    if cfg.tp_devices > 1:
        return cfg.tp_devices
    if cfg.tp_devices < 0:  # explicit off
        return 1
    import jax
    ndev = len(jax.devices())
    if ndev < 2:
        return 1
    from .utils import hbm_budget
    budget = hbm_budget()
    if budget is None:
        log("run", "the backend reports no device memory limit: "
                   "auto-TP stays off")
        return 1
    from .engine import blockbits
    bits_ok = cfg.engine in ("auto", "bits") and blockbits.eligible_any(dense)
    if ms_ok:
        if not (bits_ok and dense.has_samples and dense.r < 2**30
                and dense.text is not None
                and (not cfg.use_doc or dense.has_doc)):
            return 1  # TP MS rides the v4-MS assembly only
        ssz = 8 if dense.n >= 2**31 else 4
        nb = -(-dense.n // 512)
        est = (nb * 404                      # v4 rows (wide upper bound)
               + nb * 68 * 4                 # msrows (pack=2: 68 i32 words)
               + (2 * dense.r + 2) * ssz     # jump_t
               + (((2 * dense.r + 2) * 4) if cfg.use_doc else 0)
               + dense.n)                    # text rows512 = the text bytes
    elif bits_ok:
        est = (-(-dense.n // 512)) * 404     # v4 P=512 row bytes (wide)
    else:
        est = (dense.r + 1) * 8 * 4 * 2      # layered fields upper bound
    if est <= budget:
        return 1
    tp_n = 2
    while tp_n < ndev and est / tp_n > budget:
        tp_n *= 2
    log("run", f"auto TP: estimated index {est / 1e9:.1f} GB exceeds the "
               f"{budget / 1e9:.1f} GB per-device budget")
    return tp_n


def _make_tp_engine(cfg: "RunConfig", dense: DenseIndex, tp_n: int,
                    max_value_thr: int):
    """Engine adapter for the sharded-index path (parallel/tp.py): the
    classify-only PML variant (v4 block-bits rows when eligible — ONE psum
    per step — else the layered fields table), or the full-MS value
    variant (v4-MS rows + msrows + jump tables + rows512 text, all
    row-sharded; TpMsQuery)."""
    import jax

    from .parallel.tp import TpMsQuery, TpPmlClassifier, make_tp_mesh

    ndev = len(jax.devices())
    if ndev % tp_n or ndev < tp_n:
        raise ValueError(f"--tp-devices {tp_n} does not divide the "
                         f"{ndev} available devices")
    from .engine import blockbits
    mesh = make_tp_mesh(ndev // tp_n, tp_n)
    if cfg.mode == "ms":
        if not (blockbits.eligible_any(dense) and dense.has_samples
                and dense.r < 2**30 and dense.text is not None):
            raise ValueError("--tp-devices for -M needs a v4-MS-capable "
                             "index (SA samples + text, sigma <= 8, "
                             "r < 2^30)")
        arrays, meta, host = blockbits.build_blockbits(
            dense, want_ms=True, want_doc=cfg.use_doc)
        # reads with index-absent chars take the reference's sequential-
        # carry quirk (not a pure LCP): a semantic of the reference, not a
        # device fallback — those rare reads are served by the native
        # engine (TpMsQuery logs how many)
        fb = _make_engine(
            RunConfig(**{**cfg.__dict__, "device": "cpu", "tp_devices": -1}),
            dense)
        return TpMsQuery(arrays, meta, mesh, host, use_doc=cfg.use_doc,
                         fallback=fb)
    if cfg.engine in ("auto", "bits") and blockbits.eligible_any(dense):
        arrays, meta, host = blockbits.build_blockbits(dense)
    else:
        from .engine.layered import build_layered
        arrays, meta, host = build_layered(dense)
    tp = TpPmlClassifier(arrays, meta, mesh, cfg.bin_size, max_value_thr,
                         host=host)

    class _TpAdapter:
        def __init__(self, tp_):
            self.tp = tp_
            self.arrays = tp_.arrays

        def classify(self, reads, bin_width, thr):
            return self.tp.classify(reads)

    return _TpAdapter(tp)


def _blockbits_eligible(dense: DenseIndex) -> bool:
    # v4's one row gather per step against v2's multi-probe descent: auto
    # selects v4 whenever the index fits its layout
    from .engine import blockbits
    return blockbits.eligible_any(dense)


def _unorder(dense: DenseIndex, field: str):
    """Dense tables are char-grouped; the CPU engine ctor wants run-major
    inputs. Rebuild run-major order via run_heads' stable argsort inverse."""
    arr = getattr(dense, field)
    if arr is None:
        return None
    order = np.argsort(np.asarray(dense.run_heads), kind="stable")
    out = np.empty_like(np.asarray(arr))
    out[order] = np.asarray(arr)
    return out


def _unorder_samples(dense: DenseIndex, field: str):
    """Same as _unorder, but undo the (sa-1) mod n storage convention since
    the CPU-engine ctor re-applies it."""
    arr = _unorder(dense, field)
    if arr is None:
        return None
    n = dense.n
    return np.where(arr == n - 1, 0, arr + 1)


def _prefetched(gen, depth: int = 2):
    """Runs `gen` in a daemon thread, keeping up to `depth` items ready —
    host FASTA decode + digestion overlap device compute (SURVEY.md §7.8;
    the role of the reference's threaded BatchLoader)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    SENTINEL = object()

    def producer():
        try:
            for item in gen:
                q.put(item)
            q.put(SENTINEL)
        except BaseException as e:  # surface errors on the consumer side
            q.put(e)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is SENTINEL:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def run(cfg: RunConfig) -> int:
    """Streams the query file through the engine; writes the output files.
    Returns the number of reads processed."""
    cfg.validate()
    check_device(cfg.device)
    ext = ".bin" if cfg.use_promotions else ".fa"
    base = cfg.ref_file + ext if not cfg.is_general_text else cfg.ref_file
    index_path = base + (".thrbv.ms" if cfg.mode == "ms" else ".thrbv.spumoni")

    # fast serving start: when the engine-row cache
    # satisfies the mode (PML, no doc tracking), assemble the engine from
    # .bbrows.npz + its scalar manifest and skip the dense npz entirely —
    # at GRCh38 scale that load is 23 GB before the first read streams
    dense = None
    bb_fast = None
    if (cfg.device != "cpu" and not cfg.is_general_text
            and cfg.mode == "pml" and not cfg.use_doc
            and cfg.engine in ("auto", "bits") and cfg.tp_devices <= 1):
        from .engine import blockbits
        from .utils import hbm_budget
        bb_fast = blockbits.load_cached(index_path + ".bbrows.npz",
                                        index_path + ".npz",
                                        max_bytes=hbm_budget())
        if bb_fast is not None:
            log("run", "fast start: engine rows from cache "
                       "(dense index load skipped)")
    if bb_fast is None:
        dense = load_dense_index(index_path)
    idx_n = dense.n if dense is not None else bb_fast[3]
    idx_r = dense.r if dense is not None else bb_fast[4]

    def _log_footprint(eng):
        if cfg.device != "cpu":
            from .utils import device_array_footprint
            fp = device_array_footprint(eng.arrays)
            log("run", f"index resident in device memory: "
                       f"{fp['__total__'] / 1e6:.1f} MB "
                       f"(n={idx_n}, r={idx_r})")

    if cfg.is_general_text:
        engine = _make_engine(cfg, dense, index_path=index_path)
        _log_footprint(engine)
        return _run_general_text(cfg, engine)

    null_db = EmpNullDatabase.load(
        base + (".msnulldb" if cfg.mode == "ms" else ".pmlnulldb"))
    thr = binmax.max_value_threshold(null_db.percentile_value,
                                     cfg.use_promotions, cfg.use_dna_letters,
                                     cfg.mode)

    tp_n = _tp_decision(cfg, dense) if dense is not None else 1
    if tp_n > 1:
        engine = _make_tp_engine(cfg, dense, tp_n, thr)
        log("run", f"sharded index (TP): rows sharded over {tp_n} "
                   f"'model' devices, reads over the 'data' axis")
    else:
        if bb_fast is not None:
            from .engine.scan_engine import ScanEngine
            engine = ScanEngine(bb_fast[0], bb_fast[1], mode=cfg.mode,
                                use_doc=False, host=bb_fast[2])
        else:
            engine = _make_engine(cfg, dense, index_path=index_path)
        if cfg.device != "cpu":
            import jax
            if len(jax.local_devices()) > 1 and hasattr(engine, "to_mesh"):
                # one process drives ALL its LOCAL devices, in EVERY mode
                # (MS and doc tracking included, compute_ms_pml.cpp:
                # 1036-1217): the index is replicated, staged read batches
                # are 'data'-sharded, and the jitted kernels run sharded
                # via GSPMD propagation. The mesh is local-only — under
                # jax.distributed each host streams its OWN record stride
                # (different shapes per host), so no cross-host collective
                # runs inside the streaming loop; hosts only sync in the
                # end-of-run count merge (parallel/distributed.py).
                from .parallel.mesh import make_data_mesh
                engine.to_mesh(make_data_mesh(jax.local_devices()))
                log("run", f"data-parallel over "
                           f"{len(jax.local_devices())} local devices "
                           f"(reads sharded, index replicated)")
    _log_footprint(engine)

    from .parallel import distributed as dist

    out_prefix = cfg.pattern_file
    P, p = cfg.process_count, cfg.process_index
    paths = {}
    if not cfg.report_only:
        if cfg.mode == "pml":
            paths["lengths"] = out_prefix + ".pseudo_lengths"
        else:
            paths["lengths"] = out_prefix + ".lengths"
            paths["pointers"] = out_prefix + ".pointers"
        if cfg.use_doc:
            paths["docs"] = out_prefix + ".doc_numbers"
    if cfg.write_report:
        paths["report"] = out_prefix + ".report"

    # restartable streaming: the cursor records how many of THIS host's
    # records are already durably written (SURVEY.md §5 checkpoint/resume)
    cursor_path = dist.shard_path(out_prefix + ".cursor", p, P)
    skip = 0
    if cfg.resume and os.path.exists(cursor_path):
        with open(cursor_path) as f:
            skip = int(f.read().strip() or 0)
        log("run", f"resuming after {skip} completed reads (host {p})")

    from .classify.report import ks_report_header, ks_report_line
    ks_test = None
    ks_pending = None
    if cfg.write_report and cfg.ks_report:
        # classification start mirrors srand(0) (compute_ms_pml.cpp:892)
        ks_test = KSTest(null_db, cfg.bin_size, rand=GlibcRand(0))
        ks_thr = null_db.ks_stat_threshold
        # Under host sharding / resume, this host must discard the rand()
        # draws that other hosts' (or already-completed) reads consume in
        # the global single-process order: one draw per KS window.  The
        # record stream below counts those windows into this queue; the
        # write loop advances the stream before each owned read.
        from collections import deque
        ks_pending = deque()

    files = {k_: open(dist.shard_path(v, p, P),
                      ("a" if skip else "w") + ("" if k_ == "report" else "b"))
             for k_, v in paths.items()}
    if cfg.write_report and P == 1 and not skip:
        files["report"].write(ks_report_header(ks_thr) if cfg.ks_report
                              else report_header(thr))

    def _digested_len(seq: str) -> int:
        rd = seq.upper()
        if cfg.min_digest:
            rd = digest(rd, cfg.use_promotions, cfg.use_dna_letters,
                        cfg.k, cfg.w)
        return len(rd)

    def my_records():
        from .classify.kstest import n_windows
        own_idx = -1
        pending = 0
        for i, item in enumerate(iter_query_reads(cfg.pattern_file)):
            owned = i % P == p
            if owned:
                own_idx += 1
            if owned and own_idx >= skip:
                if ks_pending is not None:
                    ks_pending.append(pending)
                    pending = 0
                yield item
            elif ks_pending is not None:
                # not processed here this session, but its KS windows consume
                # rand() draws in the global order — count them for advance()
                pending += n_windows(_digested_len(item[1]), cfg.bin_size)

    num_reads = skip
    found_count = 0
    t0 = time.time()
    total_bases = 0

    def prepare(batch):
        """Host-side decode + digestion for one batch (runs in the prefetch
        thread, overlapped with device compute — the BatchLoader role,
        batch_loader.cpp:26-76)."""
        ids, reads, bases = [], [], 0
        for rid, seq in batch:
            rd = seq.upper()
            if cfg.min_digest:
                rd = digest(rd, cfg.use_promotions, cfg.use_dna_letters,
                            cfg.k, cfg.w)
            if len(rd) == 0:
                raise ValueError(
                    f"{rid} was empty after digestion; remove the read or run "
                    f"without minimizer digestion")
            ids.append(rid)
            reads.append(rd)
            bases += len(rd)
        return ids, reads, bases

    # classification + file output run on a WRITER THREAD so host-side
    # formatting/IO (and the device->host value transfer it forces) overlap
    # the next batch's device compute — the output half of the reference's
    # omp-critical writer sections (compute_ms_pml.cpp:1001-1021), off the
    # critical path.
    import queue
    import threading

    wstate = {"found": 0, "num": num_reads, "err": None}
    wq: "queue.Queue" = queue.Queue(maxsize=2)

    def _write_batch(ids, out):
        if cfg.report_only:
            # fused path: out carries O(B) verdict summaries only
            for i, rid in enumerate(ids):
                nbins = int(out["above"][i] + out["below"][i])
                status = "FOUND" if out["found"][i] else "NOT_PRESENT"
                wstate["found"] += bool(out["found"][i])
                files["report"].write(report_line(
                    rid, status, out["sum_maxes"][i] / max(nbins, 1),
                    int(out["above"][i]), int(out["below"][i])))
                wstate["num"] += 1
            files["report"].flush()
            with open(cursor_path, "w") as f:
                f.write(str(wstate["num"]))
            return
        for i, rid in enumerate(ids):
            if cfg.use_doc:
                write_values_record(files["docs"], rid, out["docs"][i])
            if cfg.mode == "ms":
                write_values_record(files["pointers"], rid,
                                    out["pointers"][i])
            write_values_record(files["lengths"], rid, out["lengths"][i])
            if cfg.write_report and cfg.ks_report:
                ks_test.rand.advance(ks_pending.popleft())
                ks_list = ks_test.run_kstest(out["lengths"][i])
                above = sum(1 for x in ks_list if x >= ks_thr)
                found = above / len(ks_list) > 0.50
                wstate["found"] += found
                files["report"].write(ks_report_line(
                    rid, "FOUND" if found else "NOT_PRESENT",
                    sum(ks_list) / len(ks_list), above,
                    len(ks_list) - above))
            elif cfg.write_report:
                res = binmax.classify(out["lengths"][i], cfg.bin_size, thr)
                wstate["found"] += res.status == "FOUND"
                files["report"].write(report_line(
                    rid, res.status, res.avg_max, res.bins_above,
                    res.bins_below))
            wstate["num"] += 1
        for f in files.values():
            f.flush()
        with open(cursor_path, "w") as f:
            f.write(str(wstate["num"]))

    def _writer():
        try:
            while True:
                item = wq.get()
                if item is None:
                    return
                _write_batch(*item)
        except BaseException as e:  # surfaced after join
            wstate["err"] = e

    # array-native fast path: vectorized chunk parsing + whole-batch
    # digestion + staged h2d run in the PREFETCH thread, so only kernel
    # launches sit on this thread (the per-read Python prep loop below is
    # far slower than the kernels)
    use_fast = cfg.device != "cpu" and hasattr(engine, "stage")
    if use_fast and P > 1:
        log("run", f"staged fast path, host-stride shard {p}/{P}")

    def staged_batches():
        from .classify.kstest import n_windows_batch
        from .io.fastx_batch import (PackedReads, iter_packed_batches,
                                     select_records)
        from .io.minimizers import digest_packed

        # host-stride sharding (P > 1): every host parses the file with the
        # same vectorized chunk parser, keeps only the records it owns
        # (global index % P == p — the same ownership rule as the per-read
        # path's my_records), and the resume cursor keeps counting OWNED
        # records only
        g = 0            # global record index at the current batch start
        owned_seen = 0   # owned records seen (cursor/skip is in these units)
        ks_carry = 0     # rand() draws owed for records not yielded here
        max_lanes = 65536 if cfg.report_only else 8192
        for pk in iter_packed_batches(cfg.pattern_file, cfg.batch_bases,
                                      upper=True):
            npk = len(pk)
            first = (p - g) % P          # first owned index in this batch
            g += npk
            nown = max(0, -(-(npk - first) // P)) if first < npk else 0
            csum = None
            if ks_pending is not None:
                # --ks-report draws one rand() per KS window in GLOBAL read
                # order; records this host does not yield (other hosts',
                # resume-skipped) still consume draws — count their windows
                # from the whole batch's DIGESTED lengths
                if cfg.min_digest:
                    pk = digest_packed(pk, cfg.use_promotions,
                                       cfg.use_dna_letters, cfg.k, cfg.w)
                nw = n_windows_batch(pk.lens, cfg.bin_size)
                csum = np.zeros(npk + 1, dtype=np.int64)
                np.cumsum(nw, out=csum[1:])
            if owned_seen + nown <= skip:   # resume: skip whole batches
                owned_seen += nown
                if csum is not None:
                    ks_carry += int(csum[npk])
                continue
            a = max(0, skip - owned_seen)   # owned records already durable
            owned_seen += nown
            sel = np.arange(first, npk, P, dtype=np.int64)[a:]
            if len(sel) == 0:
                if csum is not None:
                    ks_carry += int(csum[npk])
                continue
            if csum is not None:
                # per yielded read: draws consumed by the records between it
                # and the previously yielded one (advance before querying)
                gaps = np.empty(len(sel), dtype=np.int64)
                gaps[0] = ks_carry + csum[sel[0]]
                gaps[1:] = csum[sel[1:]] - csum[sel[:-1] + 1]
                ks_carry = int(csum[npk] - csum[sel[-1] + 1])
                for v in gaps:
                    ks_pending.append(int(v))
            if P == 1:
                if a:                       # resume: partial batch
                    pk = PackedReads(pk.ids[a:],
                                     pk.buf[pk.offs[a]:].copy(),
                                     (pk.offs[a:] - pk.offs[a]).copy())
            else:
                pk = select_records(pk, sel)
            if cfg.min_digest and ks_pending is None:
                pk = digest_packed(pk, cfg.use_promotions,
                                   cfg.use_dna_letters, cfg.k, cfg.w)
            yield pk.ids, engine.stage(pk, max_lanes), pk.total_bases

    wthread = threading.Thread(target=_writer, daemon=True)
    wthread.start()
    if use_fast:
        for ids, staged, bases in _prefetched(staged_batches()):
            total_bases += bases
            if cfg.report_only:
                out = engine.classify_staged(staged, cfg.bin_size, thr)
            else:
                out = engine.query_staged(staged)
            if wstate["err"] is not None:
                break
            wq.put((ids, out))
    else:
        for ids, reads, bases in _prefetched(
                (prepare(b) for b in batch_iter(my_records(),
                                                cfg.batch_bases))):
            total_bases += bases
            if cfg.report_only:
                out = engine.classify(reads, cfg.bin_size, thr)
            else:
                out = engine.query(reads)
            if wstate["err"] is not None:
                break
            wq.put((ids, out))
    wq.put(None)
    wthread.join()
    if wstate["err"] is not None:
        raise wstate["err"]
    found_count, num_reads = wstate["found"], wstate["num"]
    dt = time.time() - t0
    for f in files.values():
        f.close()
    os.path.exists(cursor_path) and os.remove(cursor_path)

    if P > 1:
        # merge shard outputs into the reference's single-file layout
        gf, gt = dist.global_found_counts(found_count, num_reads)
        if p == 0:
            for k_, v in paths.items():
                hdr = None
                if k_ == "report":
                    # per-shard report files are headerless; the merged file
                    # gets the header matching the classifier that produced
                    # the lines (bin-max vs --ks-report)
                    hdr = (ks_report_header(ks_thr) if cfg.ks_report
                           else report_header(thr))
                dist.merge_shards(v, P, header=hdr)
            log("run", f"merged {P} host shards; {gf}/{gt} reads FOUND")
        num_reads = gt
    log("run", f"processed {num_reads} reads ({total_bases} bases) in "
               f"{dt:.2f}s -> {num_reads / max(dt, 1e-9):.1f} reads/s")
    # streaming-loop stats for harnesses (excludes index load/upload, which
    # a long-running service pays once): bench scripts read this after run()
    LAST_RUN_STATS.update(reads=num_reads, bases=total_bases, stream_s=dt)
    return num_reads


def _run_general_text(cfg: RunConfig, engine) -> int:
    """General-text querying: reads separated by \\x01
    (compute_ms_pml.cpp:1219-1297), streamed through the same
    batching/prefetch/host-sharding path as FASTA queries — the pattern file
    is never loaded whole into memory. No classification/report: the
    reference's general-text drivers emit only the value files
    (compute_ms_pml.cpp:1222-1224,1266-1267). A per-host durable cursor makes
    killed multi-host runs restartable, like the FASTA path."""
    from .io.fasta import iter_general_reads
    from .parallel import distributed as dist

    out_prefix = cfg.pattern_file
    P, p = cfg.process_count, cfg.process_index
    paths = {}
    if cfg.mode == "pml":
        paths["lengths"] = out_prefix + ".pseudo_lengths"
    else:
        paths["lengths"] = out_prefix + ".lengths"
        paths["pointers"] = out_prefix + ".pointers"

    cursor_path = dist.shard_path(out_prefix + ".cursor", p, P)
    skip = 0
    if cfg.resume and os.path.exists(cursor_path):
        with open(cursor_path) as f:
            skip = int(f.read().strip() or 0)
        log("run", f"resuming after {skip} completed reads (host {p})")
    files = {k_: open(dist.shard_path(v, p, P), "ab" if skip else "wb")
             for k_, v in paths.items()}

    def my_records():
        stream = dist.host_shard_reads(
            iter_general_reads(cfg.pattern_file), p, P)
        for own_idx, (_, item) in enumerate(stream):
            if own_idx >= skip:
                yield item

    num_reads = skip
    for batch in _prefetched(batch_iter(my_records(), cfg.batch_bases)):
        ids = [rid for rid, _ in batch]
        reads = [rd for _, rd in batch]
        out = engine.query(reads)
        for i, rid in enumerate(ids):
            write_values_record(files["lengths"], rid, out["lengths"][i])
            if cfg.mode == "ms":
                write_values_record(files["pointers"], rid,
                                    out["pointers"][i])
            num_reads += 1
        for f in files.values():
            f.flush()
        with open(cursor_path, "w") as f:
            f.write(str(num_reads))
    for f in files.values():
        f.close()
    os.path.exists(cursor_path) and os.remove(cursor_path)

    if P > 1:
        _, num_reads = dist.global_found_counts(0, num_reads)
        if p == 0:
            for v in paths.values():
                dist.merge_shards(v, P)
    return num_reads
