"""Sharded (8 virtual CPU devices) data-parallel classification must agree
bit-for-bit with the single-device engine + host classifier."""

import jax
import numpy as np

from spumoni_tpu.native import build_raw_index, NativeQueryEngine
from spumoni_tpu.index.format import build_dense_index
from spumoni_tpu.engine.arrays import to_device_arrays
from spumoni_tpu.classify import binmax
from spumoni_tpu.classify.device import classify_batch
from spumoni_tpu.parallel.mesh import ShardedPmlClassifier, make_data_mesh

from conftest import rand_dna, mutated_substring


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_device_classifier_matches_host(rng):
    bw = 150
    for _ in range(20):
        m = int(rng.integers(1, 700))
        vals = rng.integers(0, 40, size=m)
        host = binmax.classify(vals, bw, 10)
        mat = np.zeros((1, 1024), dtype=np.int64)
        mat[0, :m] = vals
        found, above, below, sums = classify_batch(mat, np.array([m]), 10, bw)
        assert (host.status == "FOUND") == bool(found[0])
        assert host.bins_above == above[0]
        assert host.bins_below == below[0]
        assert host.bin_maxes.sum() == sums[0]


def test_sharded_classifier_matches_native(rng, make_reads):
    text = rand_dna(rng, 4000)
    tarr = np.frombuffer(text, np.uint8)
    raw = build_raw_index(tarr)
    dense = build_dense_index(raw)
    arrays, meta = to_device_arrays(dense)
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last)

    mesh = make_data_mesh()
    clf = ShardedPmlClassifier(arrays, meta, mesh, bin_width=150,
                               max_value_thr=5)
    reads = [mutated_substring(rng, text, 400, err=0.05) for _ in range(9)]
    reads += [rand_dna(rng, 400) for _ in range(10)]
    out = clf.classify(reads)

    ref_lengths = native.query_pml(reads)
    n_found = 0
    for i, rd in enumerate(reads):
        assert np.array_equal(out["lengths"][i], ref_lengths[i]), i
        host = binmax.classify(ref_lengths[i], 150, 5)
        assert (host.status == "FOUND") == bool(out["found"][i]), i
        assert host.bins_above == out["above"][i]
        assert host.bins_below == out["below"][i]
        n_found += host.status == "FOUND"
    assert out["total_found"] == n_found
    assert n_found >= 8  # mutated substrings should classify as FOUND


def test_sharded_classifier_layered(rng, make_reads):
    from spumoni_tpu.engine.layered import build_layered

    text = rand_dna(rng, 4000)
    tarr = np.frombuffer(text, np.uint8)
    raw = build_raw_index(tarr)
    dense = build_dense_index(raw)
    arrays, meta, host = build_layered(dense)
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last)
    mesh = make_data_mesh()
    clf = ShardedPmlClassifier(arrays, meta, mesh, bin_width=150,
                               max_value_thr=5)
    reads = [mutated_substring(rng, text, 300, err=0.05) for _ in range(8)]
    reads += [rand_dna(rng, 300) for _ in range(8)]
    out = clf.classify(reads)
    ref = native.query_pml(reads)
    for i in range(len(reads)):
        assert np.array_equal(out["lengths"][i], ref[i]), i
        host = binmax.classify(ref[i], 150, 5)
        assert (host.status == "FOUND") == bool(out["found"][i]), i


def test_fused_classify_kernel(rng, make_reads):
    import jax.numpy as jnp
    from spumoni_tpu.engine.layered import build_layered
    from spumoni_tpu.parallel.mesh import fused_classify_kernel

    text = rand_dna(rng, 6000)
    tarr = np.frombuffer(text, np.uint8)
    raw = build_raw_index(tarr)
    dense = build_dense_index(raw)
    arrays, meta, host = build_layered(dense)
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last)
    reads = [mutated_substring(rng, text, int(rng.integers(50, 700)), err=0.05)
             for _ in range(10)]
    reads += [rand_dna(rng, int(rng.integers(50, 700))) for _ in range(10)]

    B, L = 32, 1024
    rev = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int64)
    for i, rd in enumerate(reads):
        a = np.frombuffer(rd, np.uint8)
        rev[i, :len(a)] = a[::-1]
        lens[i] = len(a)
    alphabet = tuple(sorted(set(host.index_chars) | {0}))
    ctab = host.table_for_alphabet(alphabet)
    rev = host.rank_map(alphabet)[rev]

    bw, thr = 150, 5
    found, above, below, summ = fused_classify_kernel(
        arrays, jnp.asarray(rev), jnp.asarray(lens), thr, meta, "pml",
        int(arrays.fields.shape[0]), bw, ctab)
    ref = native.query_pml(reads)
    for i, rd in enumerate(reads):
        h = binmax.classify(ref[i], bw, thr)
        assert (h.status == "FOUND") == bool(found[i]), i
        assert h.bins_above == int(above[i]), (i, h.bins_above, int(above[i]))
        assert h.bins_below == int(below[i]), i
        assert h.bin_maxes.sum() == int(summ[i]), i


def test_sharded_classify_only_fused(rng, make_reads):
    from spumoni_tpu.engine.layered import build_layered

    text = rand_dna(rng, 5000)
    tarr = np.frombuffer(text, np.uint8)
    raw = build_raw_index(tarr)
    dense = build_dense_index(raw)
    arrays, meta, host = build_layered(dense)
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last)
    mesh = make_data_mesh()
    clf = ShardedPmlClassifier(arrays, meta, mesh, bin_width=150,
                               max_value_thr=5, host=host)
    reads = [mutated_substring(rng, text, 350, err=0.05) for _ in range(8)]
    reads += [rand_dna(rng, 350) for _ in range(8)]
    out = clf.classify(reads, want_values=False)
    ref = native.query_pml(reads)
    n_found = 0
    for i in range(len(reads)):
        h = binmax.classify(ref[i], 150, 5)
        assert (h.status == "FOUND") == bool(out["found"][i]), i
        assert h.bins_above == out["above"][i], i
        assert h.bins_below == out["below"][i], i
        n_found += h.status == "FOUND"
    assert out["total_found"] == n_found


def test_sharded_classifier_occ_engine(rng, make_reads):
    """The fused classify path over the mesh with occ-block (v3) arrays."""
    from spumoni_tpu.engine.occblock import build_occblock

    text = rand_dna(rng, 4000)
    tarr = np.frombuffer(text, np.uint8)
    raw = build_raw_index(tarr)
    dense = build_dense_index(raw)
    arrays, meta, host = build_occblock(dense)
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last)

    mesh = make_data_mesh()
    clf = ShardedPmlClassifier(arrays, meta, mesh, bin_width=150,
                               max_value_thr=5, host=host)
    reads = [mutated_substring(rng, text, 400, err=0.05) for _ in range(9)]
    reads += [rand_dna(rng, 400) for _ in range(10)]
    ref_lengths = native.query_pml(reads)

    for want_values in (False, True):
        out = clf.classify(reads, want_values=want_values)
        for i in range(len(reads)):
            host_cls = binmax.classify(ref_lengths[i], 150, 5)
            assert (host_cls.status == "FOUND") == bool(out["found"][i]), i
            assert host_cls.bins_above == out["above"][i]
            if want_values:
                assert np.array_equal(out["lengths"][i], ref_lengths[i]), i
