"""Gather-cost grid at 2.1 Gbp scale: ns/lane for 67M row gathers as a
function of (rows, row bytes) at constant total table size — the physics
that sets the v4-MS scan floor (msrows shape choice) and the jump-table
reconstruction cost. Also times a 1-D element gather (recon's shape).

    python scripts/exp_gather_grid_r5.py     # on the GPU; ~10 GB of tables
"""
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time
import numpy as np
import spumoni_tpu  # noqa
import jax, jax.numpy as jnp

rng = np.random.default_rng(0)
B, L = 65536, 1024
NG = B * L  # 67M gathers

def bench_rows(rows, words):
    tab = jnp.asarray(rng.integers(0, 2**31, size=(rows, words), dtype=np.int64).astype(np.int32))
    idx = jnp.asarray(rng.integers(0, rows, size=(B, L), dtype=np.int64).astype(np.int32))

    @jax.jit
    def f(tab, idx):
        def body(c, ix):
            r = tab[ix]           # [B, words]
            return c + jnp.sum(r, axis=1, dtype=jnp.int64), 0
        c, _ = jax.lax.scan(body, jnp.zeros((B,), jnp.int64), idx.T)
        return c
    c0 = f(tab, idx); c0.block_until_ready()
    print('sample', np.asarray(c0[:2]), flush=True)
    best = 1e9
    for _ in range(3):
        t0 = time.time(); f(tab, idx).block_until_ready()
        best = min(best, time.time() - t0)
    print(f"rows={rows/1e6:7.2f}M x {words*4:5d}B : {best:7.4f}s "
          f"({best/NG*1e9:5.2f} ns/lane)", flush=True)
    del tab, idx

# constant ~1.1 GB total (the msrows budget)
for rows, words in ((4_101_563, 68), (2_050_782, 136), (1_025_391, 260),
                    (512_696, 520), (131_072, 2048), (65_536, 4096)):
    bench_rows(rows, words)

# 1-D element gather at recon's shape: 3e8-element table, 67M gathers
tab1 = jnp.asarray(rng.integers(0, 2**31, size=3 * 10**8, dtype=np.int64).astype(np.int32))
idx1 = jnp.asarray(rng.integers(0, 3 * 10**8, size=(B, L)).astype(np.int32))

@jax.jit
def g(tab, idx):
    return tab[idx]
g(tab1, idx1).block_until_ready()
best = 1e9
for _ in range(3):
    t0 = time.time(); g(tab1, idx1).block_until_ready()
    best = min(best, time.time() - t0)
print(f"1-D 300M-elem element gather: {best:.3f}s ({best/NG*1e9:.2f} ns/lane)",
      flush=True)

# 2-D variant of the same: [2.34M, 128] rows, gather row then pick word
tab2 = tab1[:2_343_750 * 128].reshape(2_343_750, 128)

@jax.jit
def g2(tab, idx):
    r = tab[idx >> 7]                       # [B, L, 128]? NO — scan it
    return r
@jax.jit
def g2s(tab, idx):
    def body(c, ix):
        r = tab[ix >> 7]                    # [B, 128]
        onehot = (jnp.arange(128, dtype=jnp.int32)[None, :]
                  == (ix & 127)[:, None])
        return c + jnp.sum(jnp.where(onehot, r, 0), axis=1,
                           dtype=jnp.int64), 0
    c, _ = jax.lax.scan(body, jnp.zeros((B,), jnp.int64), idx.T)
    return c
g2s(tab2, idx1).block_until_ready()
best = 1e9
for _ in range(3):
    t0 = time.time(); g2s(tab2, idx1).block_until_ready()
    best = min(best, time.time() - t0)
print(f"2-D [2.34M,128] row gather + select: {best:.3f}s "
      f"({best/NG*1e9:.2f} ns/lane)", flush=True)
