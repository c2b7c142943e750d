"""The build cache: where the port's compiled libraries are kept.

The port of the reference package's ``utils/compile_cache.py``.  There it
points JAX's persistent compilation cache at a directory, so that repeat
runs skip their compiles.  Here what compiles is the port's own code, once
per source and flags: the CUDA kernels (``ops.kernels.build``) and the C++
host helper (``utils.native``), each library named by a hash of what built
it.  ``enable_compile_cache`` points both at one directory, by default the
package's ``build/``.
"""

from __future__ import annotations

from pathlib import Path


def enable_compile_cache(cache_dir: str | None = None) -> str | None:
    """Keep the CUDA kernels and the host helper built in ``cache_dir``
    (default: the package's ``build/``).  Returns the directory used, or None
    when it cannot be created (the build directory is then left as it was).
    Safe to call more than once; libraries already loaded stay loaded."""
    from ..ops.kernels import build

    path = Path(cache_dir) if cache_dir is not None else build.DEFAULT_BUILD_DIR
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    build.BUILD_DIR = path
    return str(path)
