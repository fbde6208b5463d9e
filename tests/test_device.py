"""Device selection, device-memory budget, compile-cache placement, the
per-character constant tables and the native library's cache key."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spumoni_tpu import native, pipeline, utils
from spumoni_tpu.engine.layered import LayeredHost
from spumoni_tpu.engine.occblock import MAX_SIGMA, OccHost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def platforms():
    """Sets jax_platforms for one test and restores the suite's choice."""
    old = jax.config.jax_platforms

    def _set(value):
        jax.config.update("jax_platforms", value)

    yield _set
    jax.config.update("jax_platforms", old)


@pytest.mark.parametrize("backend,chosen,ok", [
    ("gpu", "", True),       # a GPU: the normal device
    ("cpu", "cpu", True),    # the caller restricted JAX to the CPU itself
    ("cpu", "", False),      # no accelerator found: never a silent fallback
    ("cpu", "cpu,cuda", False),
    ("tpu", "", False),
])
def test_gpu_device_needs_gpu_backend(monkeypatch, platforms, backend,
                                      chosen, ok):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    platforms(chosen)
    if ok:
        pipeline.check_device("gpu")
    else:
        with pytest.raises(pipeline.DeviceUnavailable, match="needs a GPU"):
            pipeline.check_device("gpu")
    pipeline.check_device("cpu")  # the native engine needs no device


def test_unknown_device_rejected():
    with pytest.raises(ValueError, match="unknown device"):
        pipeline.check_device("tpu")


def test_cli_run_without_gpu_exits_nonzero(tmp_path, monkeypatch, platforms):
    from spumoni_tpu import cli

    reads = tmp_path / "r.fa"
    reads.write_text(">r\nACGT\n")
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    platforms("")
    with pytest.raises(SystemExit) as ei:
        cli.main(["run", "-r", str(tmp_path / "idx"), "-p", str(reads),
                  "-P", "-n", "--device", "gpu"])
    assert "needs a GPU" in str(ei.value.code)


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_placement(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / "cc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "import spumoni_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        check=True, timeout=120).stdout.strip()
    assert out == want


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,env,want", [
    ({"bytes_limit": 60_000_000_000}, None, 45e9),
    ({"bytes_limit": 60_000_000_000}, "3", 3e9),
    (None, None, None),                      # CPU: no limit reported
    ({"bytes_in_use": 5}, None, None),
])
def test_hbm_budget_from_memory_stats(monkeypatch, stats, env, want):
    monkeypatch.setattr(jax, "local_devices", lambda: [_Dev(stats)])
    if env is None:
        monkeypatch.delenv("SPN_HBM_BUDGET_GB", raising=False)
    else:
        monkeypatch.setenv("SPN_HBM_BUDGET_GB", env)
    got = utils.hbm_budget()
    assert got == pytest.approx(want) if want is not None else got is None


def _pml_dense(rng, n=6000):
    from spumoni_tpu.index.format import build_dense_index

    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    return build_dense_index(native.build_raw_index(text))


@pytest.mark.parametrize("limit,want_tp", [
    (None, 1),          # no limit reported: no auto-TP, no size assumed
    (10**12, 1),        # the index fits one device
    (4_000, 2),         # 3 kB budget < the ~4.8 kB estimate: shard it
])
def test_auto_tp_follows_memory_stats(monkeypatch, rng, limit, want_tp):
    stats = None if limit is None else {"bytes_limit": limit}
    monkeypatch.setattr(jax, "local_devices", lambda: [_Dev(stats)])
    monkeypatch.delenv("SPN_HBM_BUDGET_GB", raising=False)
    cfg = pipeline.RunConfig(pml_requested=True, write_report=True,
                             report_only=True, device="gpu")
    assert pipeline._tp_decision(cfg, _pml_dense(rng)) == want_tp


def _occ_host(rng, wide: bool):
    """OccHost over a random alphabet with (optionally) 40-bit F values."""
    chars = np.sort(rng.choice(np.arange(2, 256), size=int(rng.integers(
        2, 9)), replace=False))
    cnt = np.zeros(256, np.int64)
    cnt[chars] = rng.integers(1, 2**33 if wide else 2**20, size=len(chars))
    F = np.concatenate([[0], np.cumsum(cnt)[:-1]]) + (2**39 if wide else 0)
    rmap = np.full(256, MAX_SIGMA, np.uint8)
    rmap[chars] = np.arange(len(chars), dtype=np.uint8)
    runbase = np.zeros(16, np.int64)
    runbase[:len(chars)] = rng.integers(0, 2**30, size=len(chars))
    host = OccHost(F_all=F, cnt_all=cnt, rmap=rmap, F_sigma=F[chars],
                   Fnext_sigma=F[chars] + cnt[chars],
                   index_chars=tuple(int(c) for c in chars),
                   runbase_sigma=runbase)
    return host, chars, F, cnt, rmap, runbase


@pytest.mark.parametrize("wide", [False, True])
def test_occ_char_table_gather_matches_integer_table(rng, wide):
    host, chars, F, cnt, rmap, runbase = _occ_host(rng, wide)
    # query alphabet: some index chars, some absent bytes, and pad byte 0
    absent = rng.choice(np.setdiff1d(np.arange(1, 256), chars), size=3,
                        replace=False)
    alphabet = tuple(sorted({0} | set(int(c) for c in chars[::2])
                            | set(int(c) for c in absent)))
    ctab = host.table_for_alphabet(alphabet)
    assert ctab.dtype == jnp.int64 and ctab.shape[0] % 16 == 0
    qbytes = rng.choice(np.asarray(alphabet), size=512)
    qc = host.rank_map(alphabet)[qbytes]
    got = np.asarray(jax.jit(lambda t, q: t[q.astype(jnp.int32)])(
        ctab, jnp.asarray(qc)))
    rk = rmap[qbytes].astype(np.int64)
    known = rk != MAX_SIGMA
    want = np.stack([
        rk, (cnt[qbytes] == 0).astype(np.int64), F[qbytes],
        np.where(known, F[qbytes] + cnt[qbytes], 0),
        np.where(known, runbase[np.minimum(rk, 15)], 0)], axis=1)
    np.testing.assert_array_equal(got, want)
    if wide:
        assert got[:, 2].max() >= 2**39   # 40-bit values survive the lookup


def test_layered_char_table_gather_matches_integer_table(rng):
    charmeta = rng.integers(0, 2**40, size=(256, 16))
    root = rng.integers(0, 2**40, size=(256, 64))
    host = LayeredHost(charmeta_np=charmeta, root_np=root,
                       index_chars=(65, 67, 71, 84))
    alphabet = tuple(sorted({0, 65, 67, 71, 78, 84, 200}))
    ctab = host.table_for_alphabet(alphabet)
    qbytes = rng.choice(np.asarray(alphabet), size=300)
    got = np.asarray(ctab[jnp.asarray(host.rank_map(alphabet)[qbytes])])
    np.testing.assert_array_equal(got[:, :16], charmeta[qbytes])
    np.testing.assert_array_equal(got[:, 16:], root[qbytes])


def test_native_cache_key_follows_target(monkeypatch):
    src = b"int f() { return 1; }"
    assert native._so_path(src, b"x86_64\0a") != native._so_path(
        src, b"x86_64\0b")
    assert native._so_path(src, b"t") == native._so_path(src, b"t")
    assert native._so_path(src, b"t") != native._so_path(src + b" ", b"t")
    here = native._target()
    monkeypatch.setattr(native.platform, "machine", lambda: "other-arch")
    assert native._target() != here
