"""Prepared 1/8-density store and decoded-item cache (counterpart of
``can_tpu/data/prepared.py:60-337``).

**Prepared store** (``write_store`` / ``PreparedStore``): the snapped
1/8-resolution density maps baked to disk once — exactly the loader's
``resize_linear(dmap, H/8, W/8) * 64``, f32 — so an epoch loads a small
``.npy`` per item instead of the full-resolution map and its resize.
Both flip orientations are baked (``<base>.npy`` and ``<base>.flip.npy``):
the loader flips the full-resolution map before the resize, and flip does
not commute with the bilinear resample bit for bit.  A ``manifest.json``
(version, gt_downsample, per-item snapped shapes, file sizes, source
``.npy`` size and mtime, CRCs) makes a stale store detectable.  The files
are the JAX package's format byte for byte, so each package opens the
other's store (tests/test_torch_prepared.py).

**Decoded-item cache** (``ItemCache``): a bounded-bytes, thread-safe LRU
over decoded ``(image, dmap)`` items, keyed on the whole decode config
plus ``(index, flip)``, so a hit is bit-identical to a fresh decode.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import zlib
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from can_tpu_torch.data.imageio import image_shape, resize_linear

MANIFEST_NAME = "manifest.json"
STORE_DIRNAME = "prepared"  # conventional location: <gt_dmap_root>/prepared
DMAPS_DIRNAME = "dmaps"
STORE_VERSION = 1


class StaleStoreError(RuntimeError):
    """The prepared store is absent, unreadable or out of date.

    ``CrowdDataset`` catches it when probing (``prepared="auto"``) and
    falls back to decoding; an explicitly named store raises it."""


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


def _image_files(img_root: str) -> list:
    return sorted(f for f in os.listdir(img_root)
                  if os.path.isfile(os.path.join(img_root, f)))


def prepared_paths(root: str, img_name: str) -> Tuple[str, str]:
    """(unflipped, flipped) prepared-map paths of one image name."""
    base, _ = os.path.splitext(img_name)
    d = os.path.join(root, DMAPS_DIRNAME)
    return (os.path.join(d, base + ".npy"),
            os.path.join(d, base + ".flip.npy"))


def downsample_density(full: np.ndarray, rows: int, cols: int,
                       ds: int) -> np.ndarray:
    """The loader's density math: bilinear resize of the full map to
    (rows, cols), scaled by ds * ds to keep the count."""
    return resize_linear(np.ascontiguousarray(full), rows, cols) * np.float32(ds * ds)


def write_store(img_root: str, gt_dmap_root: str, out_root: Optional[str] = None,
                *, gt_downsample: int = 8, verbose: bool = False) -> str:
    """Bake the prepared store of one (images, ground_truth) pair; returns
    its root (default ``<gt_dmap_root>/prepared``).  The manifest is
    written last (atomic rename), so an interrupted bake leaves none and
    the loader falls back instead of reading half a store."""
    ds = int(gt_downsample)
    if ds <= 1:
        raise ValueError("prepared store requires gt_downsample > 1 "
                         "(there is no resize to do ahead of time otherwise)")
    root = out_root or os.path.join(gt_dmap_root, STORE_DIRNAME)
    os.makedirs(os.path.join(root, DMAPS_DIRNAME), exist_ok=True)
    items: Dict[str, dict] = {}
    for name in _image_files(img_root):
        h, w = image_shape(os.path.join(img_root, name))
        rows, cols = h // ds, w // ds
        if rows == 0 or cols == 0:
            raise ValueError(
                f"image {os.path.join(img_root, name)} is smaller than one "
                f"{ds}px density cell; remove or upscale it")
        base, _ = os.path.splitext(name)
        src = os.path.join(gt_dmap_root, base + ".npy")
        full = np.asarray(np.load(src), dtype=np.float32)
        plain_path, flip_path = prepared_paths(root, name)
        entry = {"hw": [rows * ds, cols * ds],
                 "src_bytes": os.stat(src).st_size,
                 "src_mtime_ns": os.stat(src).st_mtime_ns}
        for arr, path, bkey, ckey in (
                (full, plain_path, "bytes", "crc32"),
                (full[:, ::-1], flip_path, "bytes_flip", "crc32_flip")):
            # C order, as the JAX package writes it (the resize's fancy
            # indexing leaves a Fortran-ordered array)
            np.save(path, np.ascontiguousarray(
                downsample_density(arr, rows, cols, ds), dtype=np.float32))
            entry[bkey] = os.stat(path).st_size
            entry[ckey] = _crc32_file(path)
        items[name] = entry
        if verbose:
            print(f"[prepare] {name}: {h}x{w} -> {rows}x{cols} x2")
    manifest = {"version": STORE_VERSION, "gt_downsample": ds,
                "created_ts": time.time(),
                "semantics": "bilinear half-pixel; flip baked offline "
                             "(flip-then-resize != resize-then-flip in f32)",
                "items": items}
    tmp = os.path.join(root, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(root, MANIFEST_NAME))
    return root


class PreparedStore:
    """An opened, validated prepared store.

    ``open()`` runs the whole staleness check (manifest presence,
    version and gt_downsample; item coverage; snapped shapes against the
    live dataset; prepared-file presence and size; source ``.npy`` size
    and mtime) and raises ``StaleStoreError`` naming the reason.
    ``verify()`` also re-reads every prepared file against its CRC.
    """

    def __init__(self, root: str, manifest: dict):
        self.root = root
        self.manifest = manifest
        self.gt_downsample = int(manifest["gt_downsample"])

    @staticmethod
    def default_root(gt_dmap_root: str) -> str:
        return os.path.join(gt_dmap_root, STORE_DIRNAME)

    @classmethod
    def open(cls, root: str, *, gt_dmap_root: Optional[str] = None,
             gt_downsample: Optional[int] = None,
             img_names: Optional[Sequence[str]] = None,
             expected_hw: Optional[Dict[str, Tuple[int, int]]] = None,
             check_sources: bool = True) -> "PreparedStore":
        mpath = os.path.join(root, MANIFEST_NAME)
        if not os.path.isfile(mpath):
            raise StaleStoreError(f"no prepared store (missing {mpath}); "
                                  "bake one with write_store")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise StaleStoreError(f"unreadable manifest {mpath}: {e}") from e
        if manifest.get("version") != STORE_VERSION:
            raise StaleStoreError(
                f"store version {manifest.get('version')!r} != "
                f"{STORE_VERSION} (bake it again)")
        if (gt_downsample is not None
                and int(manifest.get("gt_downsample", -1)) != int(gt_downsample)):
            raise StaleStoreError(
                f"store baked at gt_downsample="
                f"{manifest.get('gt_downsample')}, loader wants "
                f"{gt_downsample}")
        items = manifest.get("items", {})
        for name in (img_names or ()):
            entry = items.get(name)
            if entry is None:
                raise StaleStoreError(
                    f"dataset item {name} not in store manifest "
                    "(images added since the bake?)")
            if expected_hw is not None and name in expected_hw:
                if tuple(entry["hw"]) != tuple(expected_hw[name]):
                    raise StaleStoreError(
                        f"{name}: snapped shape changed "
                        f"({tuple(entry['hw'])} baked vs "
                        f"{tuple(expected_hw[name])} now)")
            plain_path, flip_path = prepared_paths(root, name)
            for path, bkey in ((plain_path, "bytes"), (flip_path, "bytes_flip")):
                try:
                    st = os.stat(path)
                except OSError:
                    raise StaleStoreError(f"prepared map missing: {path}") from None
                if st.st_size != entry[bkey]:
                    raise StaleStoreError(
                        f"prepared map truncated/rewritten: {path}")
            if check_sources and gt_dmap_root is not None:
                base, _ = os.path.splitext(name)
                src = os.path.join(gt_dmap_root, base + ".npy")
                try:
                    st = os.stat(src)
                except OSError:
                    raise StaleStoreError(
                        f"source density map gone: {src}") from None
                if (st.st_size != entry["src_bytes"]
                        or st.st_mtime_ns != entry["src_mtime_ns"]):
                    raise StaleStoreError(
                        f"source {src} changed since the bake; bake again")
        return cls(root, manifest)

    def load(self, img_name: str, *, flip: bool = False) -> np.ndarray:
        """The prepared 1/8 density map, (h, w) float32, snapped and
        count-scaled; the loader only appends the channel axis."""
        plain_path, flip_path = prepared_paths(self.root, img_name)
        arr = np.load(flip_path if flip else plain_path)
        if arr.dtype != np.float32 or arr.ndim != 2:
            raise StaleStoreError(
                f"prepared map {img_name} has dtype {arr.dtype} / "
                f"ndim {arr.ndim}; expected 2-D float32")
        return arr

    def verify(self, img_names: Optional[Iterable[str]] = None) -> int:
        """Re-read prepared files and check their CRCs; returns the number
        of files checked."""
        names = list(img_names) if img_names is not None \
            else sorted(self.manifest.get("items", ()))
        checked = 0
        for name in names:
            entry = self.manifest["items"].get(name)
            if entry is None:
                raise StaleStoreError(f"{name} not in manifest")
            plain_path, flip_path = prepared_paths(self.root, name)
            for path, ckey in ((plain_path, "crc32"), (flip_path, "crc32_flip")):
                if _crc32_file(path) != entry[ckey]:
                    raise StaleStoreError(f"checksum mismatch: {path}")
                checked += 1
        return checked


class ItemCache:
    """Bounded-bytes, thread-safe LRU over decoded ``(image, dmap)`` items.

    The caller decides the flip before asking, so the key (decode config,
    index, flip) makes a hit bit-identical to a fresh decode.  Values are
    kept as given (the dataset marks them read-only).  An item larger
    than the whole budget is skipped, not thrashed through.  Counters are
    cumulative; ``stats()`` snapshots them.
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.oversize_skips = 0

    def get(self, key):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry[0]

    def put(self, key, value) -> bool:
        nbytes = sum(int(a.nbytes) for a in value)
        with self._lock:
            if key in self._entries:
                return False
            if nbytes > self.max_bytes:
                self.oversize_skips += 1
                return False
            while self._bytes + nbytes > self.max_bytes and self._entries:
                _, (_, old_bytes) = self._entries.popitem(last=False)
                self._bytes -= old_bytes
                self.evictions += 1
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            self.inserts += 1
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"hits": self.hits, "misses": self.misses,
                    "hit_rate": round(self.hits / total, 4) if total else None,
                    "inserts": self.inserts, "evictions": self.evictions,
                    "oversize_skips": self.oversize_skips,
                    "items": len(self._entries), "bytes": self._bytes,
                    "capacity_bytes": self.max_bytes}
