"""The kernel build cache (counterpart of ``can_tpu/utils/compile_cache.py``;
on by default in the CLIs).

The JAX package caches compiled XLA programs on disk so that a fresh
process deserialises them instead of compiling.  The port compiles no
program: what a fresh process builds is the two CUDA kernel libraries
(``ops/_build.py``, one ``nvcc`` each), and this cache is the directory
they are built into, keyed by a hash of the source and the flags, so a
later process on the same checkout loads them instead of running
``nvcc``.

Default location: ``<checkout>/build/can_tpu_torch`` (gitignored; override
with the ``CAN_TPU_COMPILE_CACHE`` env var or the CLIs' ``--compile-cache``
flag).  ``off`` (or ``none``, ``0``, ``disabled``) builds into a temporary
directory of this process, removed at exit, so every process pays the
build.  Call it before the first kernel library loads: a call that would
move the directory once a library is loaded raises.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import torch

from can_tpu_torch.ops import _build

_OFF_VALUES = ("off", "none", "0", "disabled")


def default_cache_dir() -> str:
    return os.environ.get("CAN_TPU_COMPILE_CACHE", str(_build.DEFAULT_BUILD_ROOT))


# this process's temporary build directory under "off", once made
_off_dir: Optional[Path] = None


def _refuse_if_loaded(what: str) -> None:
    if _build.loaded_libraries():
        raise RuntimeError(
            f"the kernel build cache is {_build.BUILD_ROOT} and "
            f"{', '.join(_build.loaded_libraries())} already loaded from it: "
            f"set the cache (--compile-cache, CAN_TPU_COMPILE_CACHE) before "
            f"the first kernel loads, not to {what} after")


def enable_compilation_cache(cache_dir: Optional[str] = None, *,
                             device=None) -> Optional[str]:
    """Point the kernel build at ``cache_dir``.

    cache_dir: directory path; None -> :func:`default_cache_dir`, but only
    where kernels build: on the CPU (``device``, default: no CUDA device
    visible) the kernels' plain versions run and nothing is built, so
    auto mode returns None there, as the JAX package skips its CPU
    backend; pass an explicit directory to set it anyway.  Any of
    "off"/"none"/"0"/"disabled" -> a temporary directory of this process,
    removed at exit (returns None).  Returns the directory in effect, or
    None when off.  Raises once a kernel library is loaded from another
    directory.
    """
    global _off_dir
    if cache_dir is None:
        on_cpu = (torch.device(device).type != "cuda" if device is not None
                  else not torch.cuda.is_available())
        if on_cpu:
            return None
        cache_dir = default_cache_dir()
    if str(cache_dir).strip().lower() in _OFF_VALUES:
        if _off_dir is None or _build.BUILD_ROOT != _off_dir:
            _refuse_if_loaded("a per-process directory")
            _off_dir = Path(tempfile.mkdtemp(prefix="can_tpu_torch_build_"))
            atexit.register(shutil.rmtree, str(_off_dir), ignore_errors=True)
            _build.BUILD_ROOT = _off_dir
        return None
    path = Path(os.path.abspath(os.path.expanduser(str(cache_dir))))
    if path != _build.BUILD_ROOT:
        _refuse_if_loaded(str(path))
        _build.BUILD_ROOT = path
    path.mkdir(parents=True, exist_ok=True)
    return str(path)
