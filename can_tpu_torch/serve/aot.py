"""AOT serving bundles: what a new replica process can carry instead of
building (counterpart of ``can_tpu/serve/aot.py``).

In the JAX package a replica's warmup compiles one XLA executable per
(bucket, launch size, dtype), and the bundle serialises those executables
so a resurrected or scaled-up replica deserialises instead of compiling.
The port compiles no program: a served launch is eager PyTorch — cuDNN
convolutions, cuBLAS products, ATen kernels, all shipped compiled inside
PyTorch — plus one hand-written kernel, the context tail
(``csrc/context_fused.cu``), built with ``nvcc`` into a shared library at
first use (``ops/_build.py``).  What stands for JAX's serialised
executable here is therefore:

* the **kernel libraries** the serving path launches, built for this card
  (sm_90a SASS), each keyed by its source hash (which covers the
  ``nvcc`` flags), arch and CUDA version; a process that loads the
  bundle takes them from it and never runs ``nvcc``, so a host without
  the CUDA toolkit can serve (``build_info[name]["source"] == "bundle"``);
* the **signature table**: every (bucket shape x launch size x image
  dtype) the bake ran on each device of the autoscale range.  A batch on
  a bundled signature is an AOT hit (``ServeEngine.aot_hits``), not a
  first-seen signature (``compile_count``), as a loaded executable is in
  JAX, and a bundle that does not cover the fleet's grid is refused.

What no bundle can carry: the CUDA context, the cuDNN and cuBLAS handles,
and cuDNN's per-shape setup (its algorithm choice and workspace for each
convolution shape) are made inside the process that launches and are not
serialisable; each replica's warmup still runs every signature once to
make them, before traffic (``chip_smoke.py``'s ``[aot]`` phase splits a
cold serving process's start into these parts).

Bundle layout::

    <dir>/
        lib/<name>-<source hash>.so     one per kernel library (CUDA bakes)
        lib/<name>-<source hash>.ptxas  its build log
        aot_manifest.json               written LAST

Manifest-last: a bake torn by a crash leaves no manifest and reads as
absent (axis ``manifest``), never as a half bundle.

Staleness is checked, never assumed (``AotBundle.check``), on JAX's axes
with the port's meaning: ``version``; ``torch_version`` and
``cuda_version`` in place of ``jax_version``; ``platform`` (``cuda`` or
``cpu``) and ``device_kind`` (the CUDA device name and compute
capability); ``kernel_sources`` (the bundled kernels' source hashes);
``serve_dtype``; ``ds``; ``signature`` (the weight tree's names, shapes
and dtypes: a rollout to a same-signature checkpoint keeps the bundle
valid); the batch geometry (``max_batch``, ``bucket_shapes``,
``batch_sizes``).  Any mismatch raises ``AotStaleError`` naming the axis;
nothing stale ever runs.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from can_tpu_torch.data.batching import pad_batch
from can_tpu_torch.ops import _build, cuda_context
from can_tpu_torch.sched import normalize_sizes

AOT_VERSION = 1
MANIFEST_NAME = "aot_manifest.json"
LIB_DIR = "lib"
# the kernel libraries a served launch runs (the BN-moments kernels are
# training's: a BN model serves with its running statistics)
SERVE_KERNELS = (cuda_context.KERNEL,)


class AotStaleError(RuntimeError):
    """The bundle does not match the world trying to load it; ``axis``
    names the mismatched invariant (signature, serve_dtype, ...)."""

    def __init__(self, axis: str, detail: str = ""):
        super().__init__(f"AOT bundle stale on {axis}"
                         + (f": {detail}" if detail else ""))
        self.axis = axis


def signature_sha(params, batch_stats=None) -> str:
    """Stable digest of a weight tree's signature (``tree_signature``:
    names, shapes, dtypes): host and device copies of the same tree hash
    alike, so a bake from the replicas' weights and a load from the
    checkpoint's host tree agree."""
    from can_tpu_torch.serve.engine import tree_signature

    sig = (tree_signature(params), tree_signature(batch_stats or {}))
    return hashlib.sha256(repr(sig).encode()).hexdigest()[:16]


def device_platform(device) -> str:
    return torch.device(device).type


def device_kind(device) -> str:
    """The CUDA device's name and compute capability, or ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    major, minor = torch.cuda.get_device_capability(device)
    return f"{torch.cuda.get_device_name(device)} (sm_{major}{minor})"


def device_id(device) -> int:
    device = torch.device(device)
    return int(device.index or 0) if device.type == "cuda" else 0


def kernel_sources() -> Dict[str, str]:
    """The serving kernels' source hashes (source and ``nvcc`` flags)."""
    return {n: _build.source_hash(n) for n in SERVE_KERNELS}


def _default_device() -> torch.device:
    return (torch.device("cuda", 0) if torch.cuda.is_available()
            else torch.device("cpu"))


def _bundle_libraries(out_dir: str) -> list:
    """Copy the serving kernel libraries this process loaded into the
    bundle, with their keys."""
    _build.load_kernel_libraries(SERVE_KERNELS)
    os.makedirs(os.path.join(out_dir, LIB_DIR), exist_ok=True)
    libs = []
    for name in SERVE_KERNELS:
        info = _build.build_info[name]
        key = _build.library_key(name)
        stem = f"{name}-{key['source_sha']}"
        so = os.path.join(LIB_DIR, stem + ".so")
        shutil.copyfile(info["path"], os.path.join(out_dir, so))
        log = os.path.join(LIB_DIR, stem + ".ptxas")
        with open(os.path.join(out_dir, log), "w") as f:
            f.write(info.get("ptxas", ""))
        libs.append({"name": name, "file": so, "ptxas": log, "key": key,
                     "bytes": os.path.getsize(os.path.join(out_dir, so))})
    return libs


def bake_aot_bundle(out_dir: str, *, engines: Sequence, bucket_shapes,
                    max_batch: int, dtypes, ds: int, serve_dtype: str,
                    sig_sha: str, generation: int = 0,
                    telemetry=None, batch_sizes=None) -> dict:
    """Write the bundle for every (bucket, size, dtype) signature of every
    engine's device.

    ``engines``: ``ServeEngine``s, one per target device.  ``batch_sizes``
    is the scheduling core's launch-size menu (None = just ``max_batch``):
    the menu rides the bake axes, so a loaded bundle covers every size the
    batcher may dispatch.  A signature the engine has not run yet runs
    once on a zero batch (the bake proves each launch on its device); the
    serving kernel libraries (CUDA) are copied in.  Returns the
    manifest."""
    os.makedirs(out_dir, exist_ok=True)
    shapes = sorted(set(map(tuple, bucket_shapes)))
    sizes = normalize_sizes(max_batch, batch_sizes)
    t0 = time.perf_counter()
    programs = []
    platform = kind = None
    for engine in engines:
        dev = engine.device
        platform, kind = device_platform(dev), device_kind(dev)
        for bh, bw in shapes:
            for size in sizes:
                for dt in dtypes:
                    img = np.zeros((bh, bw, 3), dt)
                    dm = np.zeros((bh // ds, bw // ds, 1), np.float32)
                    batch = pad_batch([(img, dm)], (bh, bw), size, [False], ds)
                    if not engine.is_warm(batch):
                        engine.predict_batch(batch)
                    programs.append({"device_id": device_id(dev),
                                     "shape": [int(d) for d in batch.image.shape],
                                     "dtype": str(batch.image.dtype),
                                     "kernels": list(SERVE_KERNELS)})
    libraries = _bundle_libraries(out_dir) if platform == "cuda" else []
    manifest = {
        "version": AOT_VERSION,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "platform": platform,
        "device_kind": kind,
        "kernel_sources": kernel_sources(),
        "libraries": libraries,
        "serve_dtype": serve_dtype,
        "ds": int(ds),
        "max_batch": int(max_batch),
        "batch_sizes": [int(s) for s in sizes],
        "bucket_shapes": [list(s) for s in shapes],
        "image_dtypes": sorted(str(np.dtype(dt)) for dt in dtypes),
        "signature_sha": sig_sha,
        "generation": int(generation),
        "created_ts": time.time(),
        "bake_seconds": round(time.perf_counter() - t0, 3),
        "programs": programs,
    }
    # manifest LAST: a torn bake must read as absent, not as a half bundle
    tmp = os.path.join(out_dir, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(out_dir, MANIFEST_NAME))
    if telemetry is not None:
        telemetry.emit("serve.warmup", phase="aot_bake", path=out_dir,
                       programs=len(programs),
                       devices=len(set(p["device_id"] for p in programs)),
                       seconds=manifest["bake_seconds"])
    return manifest


class AotBundle:
    """A loaded (or loadable) bundle: its manifest, and per device the
    signature table (``programs_for``)."""

    def __init__(self, path: str, manifest: dict):
        self.path = path
        self.manifest = manifest
        self._tables: Dict[int, dict] = {}

    @classmethod
    def open(cls, path: str) -> "AotBundle":
        """Open a bundle directory; an absent or torn one (no manifest) or
        one of another version raises ``AotStaleError``."""
        mpath = os.path.join(path, MANIFEST_NAME)
        if not os.path.isfile(mpath):
            raise AotStaleError("manifest",
                                f"no {MANIFEST_NAME} in {path} (absent or "
                                f"torn bake)")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            raise AotStaleError("manifest", f"unreadable: {e}") from e
        if manifest.get("version") != AOT_VERSION:
            raise AotStaleError(
                "version", f"bundle v{manifest.get('version')} != "
                           f"loader v{AOT_VERSION}")
        return cls(path, manifest)

    def check(self, *, sig_sha: str, serve_dtype: str, ds: int,
              max_batch: Optional[int] = None, bucket_shapes=None,
              batch_sizes=None, device=None) -> None:
        """Raise ``AotStaleError`` unless the bundle matches the loading
        world on every axis: ``device`` (default: cuda:0, else the CPU) is
        the card the bundle would serve on."""
        m = self.manifest
        device = _default_device() if device is None else torch.device(device)
        for axis, got in (("torch_version", torch.__version__),
                          ("cuda_version", torch.version.cuda),
                          ("platform", device_platform(device)),
                          ("device_kind", device_kind(device))):
            if m.get(axis) != got:
                raise AotStaleError(axis, f"baked for {m.get(axis)!r}, "
                                          f"running {got!r}")
        sources = kernel_sources()
        if m.get("kernel_sources") != sources:
            raise AotStaleError("kernel_sources",
                                f"baked from {m.get('kernel_sources')}, this "
                                f"checkout's are {sources} — re-bake with "
                                f"--aot-bake")
        if m.get("serve_dtype") != serve_dtype:
            raise AotStaleError("serve_dtype",
                                f"baked {m.get('serve_dtype')}, "
                                f"serving {serve_dtype}")
        if int(m.get("ds", -1)) != int(ds):
            raise AotStaleError("ds", f"baked /{m.get('ds')}, serving /{ds}")
        if m.get("signature_sha") != sig_sha:
            raise AotStaleError(
                "signature",
                "the serving weight tree differs in names/shapes/dtypes "
                "from the baked one (different checkpoint variant?) — "
                "re-bake with --aot-bake")
        if max_batch is not None and int(m.get("max_batch", -1)) != int(max_batch):
            raise AotStaleError("max_batch", f"baked at {m.get('max_batch')}, "
                                             f"serving at {max_batch}")
        if bucket_shapes is not None:
            baked = {tuple(s) for s in m.get("bucket_shapes", ())}
            missing = sorted(set(map(tuple, bucket_shapes)) - baked)
            if missing:
                raise AotStaleError("bucket_shapes",
                                    f"grid {missing} not in the bundle")
        if batch_sizes is not None:
            baked_sizes = {int(s) for s in
                           m.get("batch_sizes", (m.get("max_batch"),))
                           if s is not None}
            missing_sizes = sorted({int(s) for s in batch_sizes} - baked_sizes)
            if missing_sizes:
                raise AotStaleError(
                    "batch_sizes",
                    f"menu sizes {missing_sizes} not in the bundle "
                    f"(baked {sorted(baked_sizes)}) — the sub-batch menu "
                    f"changed since the bake; re-bake with --aot-bake")

    def device_ids(self) -> set:
        return {int(p["device_id"]) for p in self.manifest["programs"]}

    def install_libraries(self) -> Dict[str, dict]:
        """Hand the bundle's kernel libraries to the loader and load them
        now: a library that fails to load raises here, before any
        traffic, and is never rebuilt.  Returns their ``build_info``."""
        libs = self.manifest.get("libraries", ())
        if not libs:
            return {}
        _build.use_bundled_libraries(
            [{"key": lib["key"], "path": os.path.join(self.path, lib["file"]),
              "ptxas": _read(os.path.join(self.path, lib["ptxas"]))}
             for lib in libs])
        names = [lib["name"] for lib in libs]
        _build.load_kernel_libraries(names)
        return {n: _build.build_info[n] for n in names}

    def programs_for(self, device) -> Dict[Tuple[tuple, str], dict]:
        """``{(image_shape, dtype_str): program record}`` for one device,
        its kernel libraries loaded from the bundle (CUDA) — empty when the
        bundle has no coverage for it (those launches count as first-seen
        signatures in ``compile_count``)."""
        did = device_id(device)
        table = self._tables.get(did)
        if table is None:
            table = {(tuple(p["shape"]), str(p["dtype"])): p
                     for p in self.manifest["programs"]
                     if int(p["device_id"]) == did}
            if table and device_platform(device) == "cuda":
                self.install_libraries()
            self._tables[did] = table
        return table


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def load_aot_bundle(path: str) -> AotBundle:
    return AotBundle.open(path)
