"""Host-sharded streaming, shard merge, and resume-cursor logic (file-level
simulation of a 2-host run; collective merging itself is covered by the mesh
tests and exercised for real under jax.distributed)."""

import os

import numpy as np

from spumoni_tpu.pipeline import BuildConfig, RunConfig, build, run
from spumoni_tpu.parallel import distributed as dist

from test_pipeline import (_parse_report, _parse_values_file, _write_genome,
                           _write_reads)


def _build_index(tmp_path, rng):
    genome_path = str(tmp_path / "genome.fa")
    seqs = _write_genome(genome_path, rng, contigs=(("chr1", 15000),))
    genome = "".join(seqs.values())
    reads_path = str(tmp_path / "reads.fa")
    _write_reads(reads_path, rng, genome, n_pos=5, n_neg=5, m=300)
    cfg = BuildConfig(ref_file=genome_path, output_prefix=str(tmp_path / "idx"),
                      pml_index=True, use_minimizers=False)
    build(cfg)
    return reads_path


def test_host_shard_reads():
    items = list(dist.host_shard_reads(iter("abcdefg"), 1, 3))
    assert items == [(1, "b"), (4, "e")]


def test_two_host_simulation_matches_single(tmp_path, rng):
    reads_path = _build_index(tmp_path, rng)

    def _run(**kw):
        return run(RunConfig(ref_file=str(tmp_path / "idx"),
                             pattern_file=reads_path, pml_requested=True,
                             min_digest=False, write_report=True,
                             device="cpu", **kw))

    # single-host reference outputs
    _run()
    single_vals = _parse_values_file(reads_path + ".pseudo_lengths")
    single_report = open(reads_path + ".report").read()

    # simulate two hosts: host 1 then host 0 (which merges)
    _run(process_index=1, process_count=2)
    _run(process_index=0, process_count=2)
    merged_vals = _parse_values_file(reads_path + ".pseudo_lengths")
    merged_report = open(reads_path + ".report").read()

    assert set(single_vals) == set(merged_vals)
    for rid in single_vals:
        assert np.array_equal(single_vals[rid], merged_vals[rid]), rid
    assert _parse_report_lines(single_report) == _parse_report_lines(merged_report)


def _parse_report_lines(text):
    return sorted(line for line in text.splitlines()[1:] if line.strip())


def test_two_host_ks_report_header(tmp_path, rng):
    """A P>1 --ks-report run must merge with the KS header, not the
    bin-max header (regression: pipeline always re-added the bin-max one)."""
    reads_path = _build_index(tmp_path, rng)

    def _run(**kw):
        return run(RunConfig(ref_file=str(tmp_path / "idx"),
                             pattern_file=reads_path, pml_requested=True,
                             min_digest=False, write_report=True,
                             ks_report=True, device="cpu", **kw))

    _run()
    single = open(reads_path + ".report").read()
    assert "avg ks-stat" in single.splitlines()[0]

    _run(process_index=1, process_count=2)
    _run(process_index=0, process_count=2)
    merged = open(reads_path + ".report").read()
    assert merged.splitlines()[0] == single.splitlines()[0]
    assert _parse_report_lines(single) == _parse_report_lines(merged)


def test_two_host_general_text(tmp_path, rng):
    """General-text querying goes through the same host-sharded streaming
    path; a 2-host simulated run must merge to the single-host outputs."""
    data = bytes(rng.integers(97, 123, size=20000).astype(np.uint8))
    ref_path = str(tmp_path / "corpus.txt")
    with open(ref_path, "wb") as f:
        f.write(data)
    queries = [bytes(data[i * 1000:i * 1000 + 250]) for i in range(5)]
    queries.append(bytes(rng.integers(97, 123, size=250).astype(np.uint8)))
    pattern_path = str(tmp_path / "queries.txt")
    with open(pattern_path, "wb") as f:
        f.write(b"\x01".join(queries) + b"\x01")

    build(BuildConfig(ref_file=ref_path, output_prefix=str(tmp_path / "idx"),
                      pml_index=True, is_general_text=True,
                      use_minimizers=False))

    def _run(**kw):
        return run(RunConfig(ref_file=ref_path, pattern_file=pattern_path,
                             pml_requested=True, is_general_text=True,
                             min_digest=False, device="cpu",
                             batch_bases=600, **kw))

    n = _run()
    assert n == 6
    single = _parse_values_file(pattern_path + ".pseudo_lengths")

    _run(process_index=1, process_count=2)
    _run(process_index=0, process_count=2)
    merged = _parse_values_file(pattern_path + ".pseudo_lengths")
    assert set(single) == set(merged) == {f"read_{i}" for i in range(6)}
    for rid in single:
        assert np.array_equal(single[rid], merged[rid]), rid


def test_resume_cursor(tmp_path, rng):
    reads_path = _build_index(tmp_path, rng)
    rcfg = dict(ref_file=str(tmp_path / "idx"), pattern_file=reads_path,
                pml_requested=True, min_digest=False, device="cpu")

    run(RunConfig(**rcfg))
    full = _parse_values_file(reads_path + ".pseudo_lengths")

    # pretend 4 reads were already durably processed: re-create their output
    # and a cursor, then resume
    with open(reads_path + ".pseudo_lengths") as f:
        lines = f.readlines()
    with open(reads_path + ".pseudo_lengths", "w") as f:
        f.writelines(lines[:8])  # 4 records x (header + values)
    with open(reads_path + ".cursor", "w") as f:
        f.write("4")
    n = run(RunConfig(resume=True, **rcfg))
    assert n == 10
    resumed = _parse_values_file(reads_path + ".pseudo_lengths")
    assert set(resumed) == set(full)
    for rid in full:
        assert np.array_equal(full[rid], resumed[rid]), rid
    assert not os.path.exists(reads_path + ".cursor")


def test_staged_stride_resume_cursor(tmp_path, rng):
    """Resume mid-stream on the STAGED fast path under host-stride sharding
    (P=2): the cursor counts OWNED records, and the strided staged reader
    must skip exactly that many of this host's records."""
    reads_path = _build_index(tmp_path, rng)
    rcfg = dict(ref_file=str(tmp_path / "idx"), pattern_file=reads_path,
                pml_requested=True, min_digest=False, device="gpu")

    # full 2-host simulated run through the staged path (host 0 merges)
    run(RunConfig(process_index=1, process_count=2, **rcfg))
    run(RunConfig(process_index=0, process_count=2, **rcfg))
    full = _parse_values_file(reads_path + ".pseudo_lengths")
    assert len(full) == 10

    # host 1 "crashed" after 2 of its 5 records: shard file + cursor exist;
    # it resumes, then host 0 runs and merges
    shard1 = dist.shard_path(reads_path + ".pseudo_lengths", 1, 2)
    blob = []
    for i, rid in enumerate(r for r in full if int(r[-1]) % 2 == 1):
        if i < 2:
            blob.append(f">{rid}\n" +
                        " ".join(str(v) for v in full[rid]) + " \n")
    with open(shard1, "w") as f:
        f.writelines(blob)
    with open(dist.shard_path(reads_path + ".cursor", 1, 2), "w") as f:
        f.write("2")
    run(RunConfig(process_index=1, process_count=2, resume=True, **rcfg))
    run(RunConfig(process_index=0, process_count=2, **rcfg))
    resumed = _parse_values_file(reads_path + ".pseudo_lengths")
    assert set(resumed) == set(full)
    for rid in full:
        assert np.array_equal(full[rid], resumed[rid]), rid
