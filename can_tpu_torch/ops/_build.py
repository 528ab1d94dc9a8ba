"""Build and load the port's CUDA kernels from the sources in the repo.

Each ``csrc/*.cu`` file is compiled at first use with ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers: seconds, not
minutes) and loaded with ``ctypes``.  Libraries land in
``BUILD_ROOT/<name>-<hash>/``, keyed by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is a cache hit.
``BUILD_ROOT`` is the kernel build cache (``utils/compile_cache.py``:
``<checkout>/build/can_tpu_torch`` unless the CLIs' ``--compile-cache`` or
``CAN_TPU_COMPILE_CACHE`` move it).  ``load_kernel_libraries`` starts one
``nvcc`` per missing library, all at once.  A missing ``nvcc`` or a failed
build raises; there is no fallback.

An AOT bundle (``serve/aot.py``) carries prebuilt libraries, each keyed by
its source hash (which covers ``NVCC_FLAGS``), arch and CUDA version
(``library_key``).  ``use_bundled_libraries`` registers them, and a
registered library loads from the bundle, never through ``nvcc``: one
that fails to load, or whose key is not this checkout's, raises rather
than rebuilding (a rebuild would hide the bundle).  ``build_info[name]
["source"]`` says where each library came from: ``built``, ``cache`` or
``bundle``.

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
DEFAULT_BUILD_ROOT = CHECKOUT / "build" / "can_tpu_torch"
# the kernel build cache; utils/compile_cache.py sets it before any load
BUILD_ROOT = DEFAULT_BUILD_ROOT
ARCH = "sm_90a"
NVCC_FLAGS = ("-gencode", f"arch=compute_90a,code={ARCH}", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> {"path", "key", "ptxas"} of a bundle's prebuilt library
_bundled: Dict[str, dict] = {}
# name -> {"seconds", "source" ("built" | "cache" | "bundle"), "path",
# "ptxas"} for the last load
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


def source_hash(name: str) -> str:
    """The build key of ``csrc/<name>.cu``: a hash of its source and
    ``NVCC_FLAGS``."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_key(name: str) -> dict:
    """What a prebuilt library of ``csrc/<name>.cu`` is valid for: its
    source hash (source and ``NVCC_FLAGS``), the arch it was built for and
    the CUDA version of the PyTorch that loads it."""
    import torch

    return {"name": name, "source_sha": source_hash(name),
            "arch": ARCH, "cuda": torch.version.cuda}


def loaded_libraries() -> List[str]:
    """The names of the kernel libraries this process has loaded."""
    with _lock:
        return sorted(_loaded)


def use_bundled_libraries(entries: Sequence[dict]) -> None:
    """Register prebuilt libraries (``{"key": library_key(...), "path",
    "ptxas"}``): each loads from its path, never through ``nvcc``."""
    with _lock:
        for e in entries:
            _bundled[e["key"]["name"]] = dict(e)


def _load_bundled(name: str) -> ctypes.CDLL:
    entry = _bundled[name]
    want = library_key(name)
    if entry["key"] != want:
        raise RuntimeError(f"the bundled {name} library ({entry['path']}) was "
                           f"built for {entry['key']}, this checkout needs "
                           f"{want}: re-bake the bundle (it is not rebuilt)")
    try:
        return ctypes.CDLL(str(entry["path"]))
    except OSError as e:
        raise RuntimeError(f"the bundled {name} library {entry['path']} failed "
                           f"to load ({e}); it is not rebuilt") from e


def load_kernel_libraries(names: Sequence[str]) -> List[ctypes.CDLL]:
    """Build (if needed) and load ``csrc/<name>.cu`` for every name; the
    missing libraries compile in parallel, one ``nvcc`` each.  Returns the
    CDLLs in order.  Thread-safe; a library loaded once in the process is
    returned as it is."""
    with _lock:
        t0 = time.perf_counter()
        todo = []
        for n in dict.fromkeys(names):
            if n in _loaded:
                continue
            if n in _bundled:
                _loaded[n] = _load_bundled(n)
                build_info[n] = {"seconds": time.perf_counter() - t0,
                                 "source": "bundle",
                                 "path": str(_bundled[n]["path"]),
                                 "ptxas": _bundled[n].get("ptxas", "")}
            else:
                todo.append(n)
        if todo and not (CHECKOUT / "pyproject.toml").is_file():
            raise RuntimeError(
                f"can_tpu_torch builds its CUDA kernels into <checkout>/build "
                f"and runs from a checkout of the repository; {CHECKOUT} is "
                f"not one (no pyproject.toml)")
        jobs = {}
        for name in todo:
            src = CSRC / f"{name}.cu"
            out_dir = BUILD_ROOT / f"{name}-{source_hash(name)}"
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
                                "source": "cache" if job["hit"] else "built",
                                "path": str(job["so"]),
                                "ptxas": ptxas}
        if failed:
            raise RuntimeError("\n".join(failed))
        return [_loaded[n] for n in names]


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; returns the CDLL."""
    return load_kernel_libraries([name])[0]
