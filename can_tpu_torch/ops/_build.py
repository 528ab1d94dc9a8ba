"""Build and load the port's CUDA kernels from the sources in the repo.

Each ``csrc/*.cu`` file is compiled at first use with ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers: seconds, not
minutes) and loaded with ``ctypes``.  Libraries land in
``<checkout>/build/can_tpu_torch/<name>-<hash>/``, keyed by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
is a cache hit.  A missing ``nvcc`` or a failed build raises; there is
no fallback.

The package runs from a checkout of the repository (the directory that
holds ``pyproject.toml`` and the gitignored ``build/``); an installed copy
outside one refuses to build rather than write beside site-packages.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
CHECKOUT = Path(__file__).resolve().parents[2]
BUILD_ROOT = CHECKOUT / "build" / "can_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds", "cache_hit", "path", "ptxas"} for the last load
build_info: Dict[str, dict] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels of "
                       "can_tpu_torch are built from source at first use")


def _source_hash(src: Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; returns the CDLL.
    Thread-safe; a second call in the process returns the loaded library."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        if not (CHECKOUT / "pyproject.toml").is_file():
            raise RuntimeError(
                f"can_tpu_torch builds its CUDA kernels into <checkout>/build "
                f"and runs from a checkout of the repository; {CHECKOUT} is "
                f"not one (no pyproject.toml)")
        src = CSRC / f"{name}.cu"
        out_dir = BUILD_ROOT / f"{name}-{_source_hash(src)}"
        so = out_dir / f"lib{name}.so"
        t0 = time.perf_counter()
        hit = so.is_file()
        ptxas = ""
        if not hit:
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {src} "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            ptxas = proc.stderr
            (out_dir / "ptxas.log").write_text(ptxas)
            os.replace(tmp, so)  # atomic: a concurrent build sees all or none
        elif (out_dir / "ptxas.log").is_file():
            ptxas = (out_dir / "ptxas.log").read_text()
        lib = ctypes.CDLL(str(so))
        build_info[name] = {"seconds": time.perf_counter() - t0,
                            "cache_hit": hit, "path": str(so),
                            "ptxas": ptxas}
        _loaded[name] = lib
        return lib
