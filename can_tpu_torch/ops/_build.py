"""Build and load the port's CUDA kernels from the sources in the repo.

Each ``csrc/*.cu`` file is compiled at first use with ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers: seconds, not
minutes) and loaded with ``ctypes``.  Libraries land in
``<checkout>/build/can_tpu_torch/<name>-<hash>/``, keyed by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
is a cache hit.  ``load_kernel_libraries`` starts one ``nvcc`` per missing
library, all at once.  A missing ``nvcc`` or a failed build raises; there
is no fallback.

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
from typing import Dict, List, Sequence

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


def load_kernel_libraries(names: Sequence[str]) -> List[ctypes.CDLL]:
    """Build (if needed) and load ``csrc/<name>.cu`` for every name; the
    missing libraries compile in parallel, one ``nvcc`` each.  Returns the
    CDLLs in order.  Thread-safe; a library loaded once in the process is
    returned as it is."""
    with _lock:
        todo = [n for n in dict.fromkeys(names) if n not in _loaded]
        if todo and not (CHECKOUT / "pyproject.toml").is_file():
            raise RuntimeError(
                f"can_tpu_torch builds its CUDA kernels into <checkout>/build "
                f"and runs from a checkout of the repository; {CHECKOUT} is "
                f"not one (no pyproject.toml)")
        t0 = time.perf_counter()
        jobs = {}
        for name in todo:
            src = CSRC / f"{name}.cu"
            out_dir = BUILD_ROOT / f"{name}-{_source_hash(src)}"
            so = out_dir / f"lib{name}.so"
            job = {"src": src, "out_dir": out_dir, "so": so,
                   "hit": so.is_file(), "proc": None}
            if not job["hit"]:
                out_dir.mkdir(parents=True, exist_ok=True)
                job["tmp"] = out_dir / f"lib{name}.so.tmp{os.getpid()}"
                cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(job["tmp"]), str(src)]
                job["proc"] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True)
            jobs[name] = job
        failed = []
        for name, job in jobs.items():
            ptxas = ""
            if job["proc"] is not None:
                stdout, stderr = job["proc"].communicate()
                if job["proc"].returncode != 0:
                    failed.append(f"nvcc failed building {job['src']} (exit "
                                  f"{job['proc'].returncode}):\n{stdout}\n{stderr}")
                    continue
                ptxas = stderr
                (job["out_dir"] / "ptxas.log").write_text(ptxas)
                # atomic: a concurrent build sees all or none
                os.replace(job["tmp"], job["so"])
            elif (job["out_dir"] / "ptxas.log").is_file():
                ptxas = (job["out_dir"] / "ptxas.log").read_text()
            _loaded[name] = ctypes.CDLL(str(job["so"]))
            build_info[name] = {"seconds": time.perf_counter() - t0,
                                "cache_hit": job["hit"], "path": str(job["so"]),
                                "ptxas": ptxas}
        if failed:
            raise RuntimeError("\n".join(failed))
        return [_loaded[n] for n in names]


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; returns the CDLL."""
    return load_kernel_libraries([name])[0]
