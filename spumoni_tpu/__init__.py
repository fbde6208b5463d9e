"""spumoni_tpu — a JAX matching-statistics engine.

A from-scratch JAX/XLA re-design of the capabilities of oma219/spumoni
(v2.0.9): r-index-style MS/PML computation and read classification on a GPU:

  * the compressed index (RLBWT runs, thresholds, SA samples) is laid out as
    dense device-resident per-character run tables,
  * the streaming MS/PML recurrence runs as a batched lockstep kernel over
    thousands of reads (`lax.scan`; rank/select = row gathers),
  * scale-out is a `jax.sharding.Mesh` with read batches sharded data-parallel
    and the index replicated (collectives merge classification results),
  * index construction is an in-process native (C++) library instead of the
    reference's popen'd helper binaries.

64-bit index arithmetic is required for genome-scale references
(n > 2^31 once the reverse complement is included), so x64 mode is enabled at
package import.
"""

import os as _os

import jax

jax.config.update("jax_enable_x64", True)

# The lockstep scan kernels take seconds to compile but milliseconds to run,
# so compiled executables persist across processes. JAX reads
# JAX_COMPILATION_CACHE_DIR itself; otherwise the cache sits at one fixed
# path inside the checkout (the path is part of the cache key).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

__version__ = "0.1.0"
