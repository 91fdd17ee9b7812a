"""The run's surroundings: the build and kernel caches at fixed paths inside
the checkout, libraries kept from loading JAX, and the look for modules
the benchmark may not load."""

from __future__ import annotations

import os
import pathlib
import sys

# whole top-level module names that no run may load: JAX and the JAX
# package that the measured port was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "ai_music_generation_tpu")


def prepare(root: pathlib.Path) -> None:
    """Before torch is imported: every cache the program or its libraries
    could write (Triton, torch extensions, the CUDA JIT cache) goes to a
    fixed directory inside the checkout, so only a checkout's first run
    builds; the program's own kernels build into its fixed
    ``ai_music_generation_tpu_torch/_build``. Libraries that could load JAX
    by themselves are told not to."""
    cache = root / ".port_bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        path = cache / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({name.split(".", 1)[0] for name in sys.modules}
                  & set(FORBIDDEN))
