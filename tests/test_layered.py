"""Engine v2 (layered 16-ary search) must match the native engine exactly."""

import numpy as np

from spumoni_tpu.native import build_raw_index, NativeQueryEngine
from spumoni_tpu.index.format import build_dense_index, build_doc_arrays
from spumoni_tpu.engine.layered import build_layered
from spumoni_tpu.engine.scan_engine import ScanEngine
from spumoni_tpu.engine.oracle import brute_force_ms

from conftest import rand_dna


def _setup(rng, n, with_doc=False):
    text = rand_dna(rng, n)
    tarr = np.frombuffer(text, np.uint8)
    raw = build_raw_index(tarr)
    ds = de = None
    if with_doc:
        ds, de = build_doc_arrays(raw, [n // 2, n - n // 2])
    dense = build_dense_index(raw, text=tarr, with_samples=True,
                              doc_start=ds, doc_end=de)
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last, start_doc=ds, end_doc=de,
                               text=tarr)
    return text, dense, native


def test_layered_pml_ms_matches_native(rng, make_reads):
    for trial in range(3):
        text, dense, native = _setup(rng, int(rng.integers(2000, 9000)))
        arrays, meta, host = build_layered(dense)
        assert meta.depth >= 2  # exercise multi-level descent
        reads = make_reads(rng, text, num=16, max_len=300)
        reads.append(b"N" * 64)  # cnt==0 path

        pml = ScanEngine(arrays, meta, mode="pml", host=host).query(reads)
        for a, b in zip(pml["lengths"], native.query_pml(reads)):
            assert np.array_equal(a, b)

        ms = ScanEngine(arrays, meta, mode="ms", host=host).query(reads)
        ptrs, lens = native.query_ms(reads)
        for a, b in zip(ms["pointers"], ptrs):
            assert np.array_equal(a, b)
        for a, rd in zip(ms["lengths"], reads[:-1]):
            assert np.array_equal(a, brute_force_ms(text, rd))


def test_layered_grouped_fields_matches_native(rng, make_reads):
    """group>1 packs G runs per physical field row (big-index layout)."""
    text, dense, native = _setup(rng, 6000)
    arrays, meta, host = build_layered(dense, group=16)
    assert meta.group == 16
    reads = make_reads(rng, text, num=12, max_len=250)
    reads.append(b"N" * 64)

    pml = ScanEngine(arrays, meta, mode="pml", host=host).query(reads)
    for a, b in zip(pml["lengths"], native.query_pml(reads)):
        assert np.array_equal(a, b)

    ms = ScanEngine(arrays, meta, mode="ms", host=host).query(reads)
    ptrs, _ = native.query_ms(reads)
    for a, b in zip(ms["pointers"], ptrs):
        assert np.array_equal(a, b)


def test_layered_int64_positions(rng, make_reads):
    """The int64 dtype path (indexes past 2^31 positions) must be exact —
    including the fused root table gathered at int64."""
    text, dense, native = _setup(rng, 6000)
    arrays, meta, host = build_layered(dense, dtype=np.int64)
    assert meta.dtype == "int64"
    reads = make_reads(rng, text, num=12, max_len=250)
    reads.append(b"N" * 64)

    pml = ScanEngine(arrays, meta, mode="pml", host=host).query(reads)
    for a, b in zip(pml["lengths"], native.query_pml(reads)):
        assert np.array_equal(a, b)

    ms = ScanEngine(arrays, meta, mode="ms", host=host).query(reads)
    ptrs, _ = native.query_ms(reads)
    for a, b in zip(ms["pointers"], ptrs):
        assert np.array_equal(a, b)


def test_layered_doc_matches_native(rng, make_reads):
    text, dense, native = _setup(rng, 5000, with_doc=True)
    arrays, meta, host = build_layered(dense)
    reads = make_reads(rng, text, num=10, max_len=200)

    eng = ScanEngine(arrays, meta, mode="pml", use_doc=True, host=host)
    out = eng.query(reads)
    ref_l, ref_d = native.query_pml(reads, with_docs=True)
    for i in range(len(reads)):
        assert np.array_equal(out["lengths"][i], ref_l[i])
        assert np.array_equal(out["docs"][i], ref_d[i])

    eng = ScanEngine(arrays, meta, mode="ms", use_doc=True)
    out = eng.query(reads)
    ptrs, lens, docs = native.query_ms(reads, with_docs=True)
    for i in range(len(reads)):
        assert np.array_equal(out["pointers"][i], ptrs[i])
        assert np.array_equal(out["docs"][i], docs[i])


def test_chunked_long_reads(rng):
    """Reads longer than the chunk size carry state across kernel calls."""
    text, dense, native = _setup(rng, 20000)
    arrays, meta, host = build_layered(dense)
    tb = text
    reads = []
    for m in (900, 1500, 2300):
        st = int(rng.integers(0, len(tb) - m))
        rd = bytearray(tb[st:st + m])
        for k in range(0, len(rd), 37):
            rd[k] = ord("ACGT"[int(rng.integers(4))])
        reads.append(bytes(rd))
    reads.append(rand_dna(rng, 1700))

    eng = ScanEngine(arrays, meta, mode="pml", host=host, chunk=256)
    out = eng.query(reads)
    for a, b in zip(out["lengths"], native.query_pml(reads)):
        assert np.array_equal(a, b)

    eng = ScanEngine(arrays, meta, mode="ms", host=host, chunk=256)
    out = eng.query(reads)
    ptrs, lens = native.query_ms(reads)
    for a, b in zip(out["pointers"], ptrs):
        assert np.array_equal(a, b)
    for a, b in zip(out["lengths"], lens):
        assert np.array_equal(a, b)
