"""Test configuration: the suite runs on JAX's CPU platform with 8 virtual
devices, so the JAX engines, sharding and collective logic are exercised
without a GPU (SURVEY.md §4.3). Choosing the CPU platform here is what lets
`device='gpu'` runs use the JAX engines on the host (pipeline.check_device)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import spumoni_tpu  # noqa: E402,F401  (enables x64)

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def rand_dna(rng, m) -> bytes:
    return rng.choice(ACGT, size=m).astype(np.uint8).tobytes()


def mutated_substring(rng, text: bytes, m: int, err: float = 0.08) -> bytes:
    n = len(text)
    st = int(rng.integers(0, max(1, n - m)))
    rd = bytearray(text[st:st + min(m, n - st)])
    for k in range(len(rd)):
        if rng.random() < err:
            rd[k] = int(rng.choice(ACGT))
    if not rd:
        rd = bytearray(rand_dna(rng, 1))
    return bytes(rd)


@pytest.fixture
def make_reads():
    def _make(rng, text, num=10, max_len=200):
        reads = []
        for _ in range(num):
            m = int(rng.integers(1, max_len))
            if rng.random() < 0.6:
                reads.append(mutated_substring(rng, text, m))
            else:
                reads.append(rand_dna(rng, m))
        return reads
    return _make
