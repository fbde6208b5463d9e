"""Real multi-process jax.distributed run (2 CPU processes on one machine):
builds a tiny index, classifies host-sharded reads in both processes, merges
shards, and checks the merged outputs equal a single-process run."""

import os
import subprocess
import sys

import numpy as np
import pytest

from spumoni_tpu.pipeline import BuildConfig, build

from test_pipeline import _parse_values_file, _write_genome, _write_reads

WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])

pid = int(sys.argv[2]); nproc = int(sys.argv[3]); port = sys.argv[4]
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc

from spumoni_tpu.pipeline import RunConfig, run
cfg = RunConfig(ref_file=sys.argv[5], pattern_file=sys.argv[6],
                pml_requested=True, min_digest=False, write_report=True,
                device=sys.argv[7], process_index=pid, process_count=nproc)
run(cfg)
print("WORKER_OK", pid)
"""


@pytest.mark.skipif(os.environ.get("SPUMONI_SKIP_MULTIPROC") == "1",
                    reason="multi-process test disabled")
def test_two_process_distributed_run(tmp_path, rng):
    genome_path = str(tmp_path / "genome.fa")
    seqs = _write_genome(genome_path, rng, contigs=(("chr1", 12000),))
    genome = "".join(seqs.values())
    reads_path = str(tmp_path / "reads.fa")
    _write_reads(reads_path, rng, genome, n_pos=4, n_neg=4, m=300)
    build(BuildConfig(ref_file=genome_path, output_prefix=str(tmp_path / "idx"),
                      pml_index=True, use_minimizers=False))

    # single-process reference outputs
    from spumoni_tpu.pipeline import RunConfig, run
    run(RunConfig(ref_file=str(tmp_path / "idx"), pattern_file=reads_path,
                  pml_requested=True, min_digest=False, write_report=True,
                  device="cpu"))
    single = _parse_values_file(reads_path + ".pseudo_lengths")
    single_report = sorted(open(reads_path + ".report").readlines()[1:])

    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    # device='cpu' exercises the per-read path; device='gpu' (the JAX
    # engines, on the CPU platform the workers choose) exercises the STAGED
    # fast path with host-stride sharding
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for device in ("cpu", "gpu"):
        port = str(29000 + int(rng.integers(0, 500)))
        procs = [subprocess.Popen(
            [sys.executable, str(worker_py), repo, str(pid), "2",
             port, str(tmp_path / "idx"), reads_path, device],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
            for pid in range(2)]
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
        for pid, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
            assert f"WORKER_OK {pid}" in out
            if device == "gpu":
                assert f"host-stride shard {pid}/2" in out, \
                    f"worker {pid} did not take the staged fast path"

        merged = _parse_values_file(reads_path + ".pseudo_lengths")
        assert set(merged) == set(single)
        for rid in single:
            assert np.array_equal(single[rid], merged[rid]), (device, rid)
        merged_report = sorted(open(reads_path + ".report").readlines()[1:])
        assert merged_report == single_report, device
