#!/usr/bin/env python
"""GPU smoke test of the SPUMONI main path, driven through the CLI.

Generates a pangenome deployment in the shape of BASELINE.md configs 3 and 5
(ten E. coli K-12 MG1655-length strains, 4,641,652 bp each, at 1% SNP
divergence from one base; 65,536 nanopore-like 1,024 bp reads, half taken
from the strains at 8% substitutions and half random), builds it with
`spumoni-tpu build`, runs every `run` mode on the GPU through `cli.main`, and
checks each output file byte for byte against the native CPU engine
(`--device cpu`) on the same reads. Everything runs in this one process, so
one process holds the card.

    python chip_smoke.py [--seed N] [--workdir DIR]
    python chip_smoke.py --four-cards      # on a machine with four GPUs

`--four-cards` runs only the multi-device path: the data-parallel run and
`--tp-devices 4` for `-P -c --report-only` and `-M`, each compared byte for
byte with a one-card run of the same command, made first in sequential
subprocesses that see one card (CUDA_VISIBLE_DEVICES=0).

The second-to-last line of standard output is the card's name and power
limit; the last line is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Any failure raises and exits non-zero before that line is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N_STRAINS = 10
STRAIN_LEN = 4_641_652      # E. coli K-12 MG1655
SNP_RATE = 0.01
N_READS = 65_536
READ_LEN = 1_024
READ_ERR = 0.08
ACGT = np.frombuffer(b"ACGT", np.uint8)


def make_data(workdir: str, seed: int, n_strains: int = N_STRAINS,
              strain_len: int = STRAIN_LEN, n_reads: int = N_READS) -> dict:
    """Strain FASTAs + a doc-id file list, the same strains as one
    multi-record pangenome.fa, and the reads (even = from a strain, odd =
    random)."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, size=strain_len)
    strains = []
    for _ in range(n_strains):
        s = base.copy()
        snp = rng.random(strain_len) < SNP_RATE
        s[snp] = rng.choice(ACGT, size=int(snp.sum()))
        strains.append(s)
    paths = {"list": os.path.join(workdir, "strains.txt"),
             "pangenome": os.path.join(workdir, "pangenome.fa"),
             "reads": os.path.join(workdir, "reads.fa")}
    with open(paths["list"], "w") as lst, open(paths["pangenome"], "wb") as pg:
        for i, s in enumerate(strains):
            rec = b">strain%d\n" % i + s.tobytes() + b"\n"
            p = os.path.join(workdir, f"strain{i}.fa")
            with open(p, "wb") as f:
                f.write(rec)
            pg.write(rec)
            lst.write(f"{p} {i + 1}\n")
    reads = rng.choice(ACGT, size=(n_reads, READ_LEN))
    pos = np.arange(0, n_reads, 2)
    which = rng.integers(0, n_strains, size=len(pos))
    start = rng.integers(0, strain_len - READ_LEN, size=len(pos))
    for j, (w, st) in enumerate(zip(which, start)):
        reads[pos[j]] = strains[w][st:st + READ_LEN]
    err = rng.random((len(pos), READ_LEN)) < READ_ERR
    sub = reads[pos]
    sub[err] = rng.choice(ACGT, size=int(err.sum()))
    reads[pos] = sub
    with open(paths["reads"], "wb") as f:
        for i in range(n_reads):
            kind = "pos" if i % 2 == 0 else "neg"
            f.write(b">%s_%d\n" % (kind.encode(), i) + reads[i].tobytes()
                    + b"\n")
    return paths


def cli(args: list[str], log_path: str) -> str:
    """Runs one CLI command in this process; its log goes to log_path and
    is returned."""
    from spumoni_tpu import cli as spumoni_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = spumoni_cli.main(args)
    with open(log_path, "a") as f:
        f.write(f"$ spumoni-tpu {' '.join(args)}\n{buf.getvalue()}")
    if rc != 0:
        raise RuntimeError(f"{args[0]} exited {rc}")
    return buf.getvalue()


def read_dir(workdir: str, label: str, reads: str) -> str:
    """A run directory holding a link to the reads: outputs land beside
    the pattern file, so each run gets its own."""
    d = os.path.join(workdir, "runs", label)
    os.makedirs(d, exist_ok=True)
    p = os.path.join(d, "reads.fa")
    if not os.path.exists(p):
        os.symlink(reads, p)
    return p


def compare(got_reads: str, want_reads: str, exts: list[str]) -> None:
    """Byte equality of the output files written beside two pattern files."""
    for ext in exts:
        with open(got_reads + ext, "rb") as f, open(want_reads + ext,
                                                    "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"{ext}: {got_reads} differs from "
                                     f"{want_reads}")


def assert_separates(report: str) -> str:
    """The report must call the reads taken from the strains FOUND and the
    random reads NOT_PRESENT (bench.py's check)."""
    found = {"pos": [], "neg": []}
    with open(report) as f:
        next(f)
        for line in f:
            rid, status = line.split()[:2]
            found[rid.split("_")[0]].append(status == "FOUND")
    pos, neg = float(np.mean(found["pos"])), float(np.mean(found["neg"]))
    if not (pos > 0.95 and neg < 0.05):
        raise AssertionError(f"{report}: FOUND on {pos:.3f} of positives "
                             f"and {neg:.3f} of negatives")
    return f"FOUND pos={pos:.3f} neg={neg:.3f}"


def timed(label: str, fn, n_reads: int | None = None):
    t0 = time.perf_counter()
    extra = fn() or ""
    dt = time.perf_counter() - t0
    rate = f", {n_reads / dt:.1f} reads/s" if n_reads else ""
    print(f"[smoke] {label}: {dt:.2f} s{rate}"
          + (f"; {extra}" if extra else ""), flush=True)
    return dt


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def device_info(expect: str = "gpu") -> dict:
    import jax

    devs = jax.devices()
    print(f"[smoke] jax.devices(): {devs}", flush=True)
    if devs[0].platform != expect:
        raise RuntimeError(f"JAX found no {expect.upper()} (platform "
                           f"{devs[0].platform!r})")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def build(paths: dict, workdir: str, log: str) -> dict:
    idx = os.path.join(workdir, "idx")
    idxm = os.path.join(workdir, "idxm")
    timed("(b) build -i list -P -M -d -n", lambda: cli(
        ["build", "-i", paths["list"], "-o", idx, "-P", "-M", "-d", "-n"],
        log) and None)
    timed("(b) build -r pangenome.fa -m -P", lambda: cli(
        ["build", "-r", paths["pangenome"], "-m", "-P", "-o", idxm],
        log) and None)
    return {"idx": idx, "idxm": idxm}


#: (label, index key, run flags, output extensions)
PHASES = [
    ("(c) run -P -c --report-only", "idx",
     ["-P", "-n", "-c", "--report-only"], [".report"]),
    ("(d) run -P", "idx", ["-P", "-n"], [".pseudo_lengths"]),
    ("(e) run -M", "idx", ["-M", "-n"], [".lengths", ".pointers"]),
    ("(f) run -P -d", "idx", ["-P", "-n", "-d"],
     [".pseudo_lengths", ".doc_numbers"]),
    ("(g) run -m -P -c", "idxm", ["-m", "-P", "-c"],
     [".pseudo_lengths", ".report"]),
]


def run_default(workdir: str, seed: int, sizes: dict | None = None,
                expect: str = "gpu") -> dict:
    """Phases (a)-(h); returns the device record."""
    sizes = sizes or {}
    n_reads = sizes.get("n_reads", N_READS)
    dev = device_info(expect)                                    # (a)
    if expect == "gpu":
        print(f"[smoke] (a) {card_line()}", flush=True)
    log = os.path.join(workdir, "smoke.log")
    paths = {}
    timed("generate data", lambda: paths.update(
        make_data(workdir, seed, **sizes)) and None)
    idx = build(paths, workdir, log)
    threads = str(os.cpu_count() or 1)
    for label, key, flags, exts in PHASES:
        g = read_dir(workdir, label[1], paths["reads"])
        c = read_dir(workdir, label[1] + "_cpu", paths["reads"])
        timed(label, lambda: cli(["run", "-r", idx[key], "-p", g] + flags
                                 + ["--device", "gpu"], log) and None,
              n_reads)
        timed(label + " --device cpu", lambda: cli(
            ["run", "-r", idx[key], "-p", c] + flags
            + ["--device", "cpu", "-t", threads], log) and None, n_reads)
        compare(g, c, exts)
        note = (f"; {assert_separates(g + '.report')}"
                if ".report" in exts else "")
        print(f"[smoke] {label}: {', '.join(exts)} byte-identical to the "
              f"native engine{note}", flush=True)
    g = read_dir(workdir, "h", paths["reads"])                   # (h)
    out = {}
    timed("(h) run -P -c --report-only again", lambda: out.update(
        log=cli(["run", "-r", idx["idx"], "-p", g, "-P", "-n", "-c",
                 "--report-only", "--device", "gpu"], log)) and None,
        n_reads)
    if "fast start" not in out["log"]:
        raise AssertionError("(h) did not take the fast start from "
                             ".bbrows.npz")
    compare(g, read_dir(workdir, "c_cpu", paths["reads"]), [".report"])
    print("[smoke] (h) fast start from .bbrows.npz; .report byte-identical "
          "to the native engine", flush=True)
    return dev


def _one_card_env() -> dict:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    env["XLA_FLAGS"] = " ".join(flags)
    return env


def run_four_cards(workdir: str, seed: int, sizes: dict | None = None,
                   expect: str = "gpu") -> dict:
    """Data-parallel and --tp-devices 4 runs against one-card runs of the
    same commands. The build and the one-card runs are subprocesses made
    before this process first touches a card."""
    sizes = sizes or {}
    n_reads = sizes.get("n_reads", N_READS)
    paths = make_data(workdir, seed, **sizes)
    idx = os.path.join(workdir, "idx")
    base = [sys.executable, "-m", "spumoni_tpu.cli"]
    env = _one_card_env()

    def sub(args):
        subprocess.run(base + args, cwd=REPO, env=env, check=True,
                       stdout=subprocess.DEVNULL)

    timed("build -i list -P -M -d -n", lambda: sub(
        ["build", "-i", paths["list"], "-o", idx, "-P", "-M", "-d", "-n"]))
    cmds = {"c": (["-P", "-n", "-c", "--report-only"], [".report"]),
            "e": (["-M", "-n"], [".lengths", ".pointers"])}
    for k, (flags, _) in cmds.items():
        g = read_dir(workdir, k + "_one", paths["reads"])
        timed(f"({k}) one card", lambda: sub(
            ["run", "-r", idx, "-p", g] + flags + ["--device", "gpu"]),
            n_reads)
    dev = device_info(expect)
    if dev["count"] != 4:
        raise RuntimeError(f"--four-cards needs 4 devices, "
                           f"JAX sees {dev['count']}")
    log = os.path.join(workdir, "smoke.log")
    for k, (flags, exts) in cmds.items():
        one = read_dir(workdir, k + "_one", paths["reads"])
        for label, extra in (("data-parallel", []),
                             ("--tp-devices 4", ["--tp-devices", "4"])):
            g = read_dir(workdir, f"{k}_{label[:2]}", paths["reads"])
            out = {}
            timed(f"({k}) {label}", lambda: out.update(log=cli(
                ["run", "-r", idx, "-p", g] + flags + extra
                + ["--device", "gpu"], log)) and None, n_reads)
            want = ("sharded index (TP)" if extra
                    else "data-parallel over 4")
            if want not in out["log"]:
                raise AssertionError(f"({k}) {label}: log lacks {want!r}")
            compare(g, one, exts)
            print(f"[smoke] ({k}) {label}: {', '.join(exts)} byte-identical "
                  f"to one card", flush=True)
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(REPO, ".smoke"),
                    help="scratch directory, emptied first")
    ap.add_argument("--four-cards", action="store_true",
                    help="only the multi-device path, on four GPUs")
    args = ap.parse_args(argv)
    import spumoni_tpu  # noqa: F401  (the program must be beside this file)

    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    t0 = time.perf_counter()
    run = run_four_cards if args.four_cards else run_default
    dev = run(args.workdir, args.seed)
    print(f"[smoke] total {time.perf_counter() - t0:.1f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
