"""The build cache of the hand-written kernels (``onet_tpu/core/cache.py``).

The JAX package keeps XLA's persistent compilation cache here. What the
port compiles at run time is its CUDA kernels: ``ops/_build.py`` builds
each ``csrc/*.cu`` with nvcc at first use into ``_build/`` and reuses the
library while its source and flags are unchanged. So
``enable_compilation_cache`` names that directory, moved to ``cache_dir``
or to ``$ONET_TPU_CACHE_DIR`` when one is given. Call it once at process
start, before the first kernel is built (the command line does).
"""

from __future__ import annotations

import os

from onet_tpu_torch.ops import _build


def enable_compilation_cache(cache_dir: str | None = None) -> str:
    """Point the kernel builds at ``cache_dir`` (else
    ``$ONET_TPU_CACHE_DIR``, else the package's ``_build/``); return the
    directory, created."""
    path = cache_dir or os.environ.get("ONET_TPU_CACHE_DIR")
    if path:
        _build.BUILD = os.path.abspath(path)
    os.makedirs(_build.BUILD, exist_ok=True)
    return _build.BUILD
