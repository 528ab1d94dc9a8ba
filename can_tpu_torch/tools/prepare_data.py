"""Offline density-map generation and prepared-store bake (counterpart of
``tools/prepare_data.py``)::

    python -m can_tpu_torch.tools.prepare_data --root data/part_A             # maps
    python -m can_tpu_torch.tools.prepare_data --root data/part_A --prepared  # + store
    python -m can_tpu_torch.tools.prepare_data --root data/part_A --prepared --no-gen
    python -m can_tpu_torch.tools.prepare_data --root data/part_A --verify-store
    python -m can_tpu_torch.tools.prepare_data --dirs data/part_A/train_data/images

Density maps: for each image of a split, its ShanghaiTech ``GT_*.mat``
heads become a geometry-adaptive Gaussian map ``.npy`` beside the
annotation (``data/density.py``; image sizes from the file headers, so
no PIL is needed).  ``--prepared`` bakes the snapped 1/8-resolution
store the loaders read (``data/prepared.py``, the JAX package's format);
``--verify-store`` re-reads a store and checks every CRC.  The steps run
in that order, each behind its flag; ``--verify-store`` alone skips
generation.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional


def _gt_dir_for(img_dir: str) -> str:
    """ShanghaiTech layout: the maps of ``.../images`` live in the sibling
    ``.../ground_truth``."""
    parent, leaf = os.path.split(os.path.normpath(img_dir))
    return os.path.join(parent, "ground_truth") if leaf == "images" else img_dir


def _store_out(prepared_out: Optional[str], img_dir: str) -> Optional[str]:
    """``--prepared-out`` resolution: per-split subdirs named ``train`` /
    ``test`` (the split dir minus ``_data``, else the parent dir's name),
    the one layout the CLIs' ``--prepared-root`` addresses."""
    if not prepared_out:
        return None
    split = os.path.basename(os.path.dirname(os.path.normpath(img_dir)))
    if split.endswith("_data"):
        split = split[: -len("_data")]
    return os.path.join(prepared_out, split)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="density maps and the prepared store")
    p.add_argument("--root", default=None,
                   help="dataset root holding {train,test}_data/images")
    p.add_argument("--dirs", nargs="*", default=None,
                   help="explicit image directories")
    p.add_argument("--k", type=int, default=3, help="nearest neighbours")
    p.add_argument("--sigma-scale", type=float, default=0.1)
    p.add_argument("--prepared", action="store_true",
                   help="bake the snapped 1/8-resolution density store (both "
                        "flip orientations and a manifest) next to each "
                        "split's ground_truth")
    p.add_argument("--prepared-out", default=None,
                   help="store root override (default <ground_truth>/prepared): "
                        "stores land in <out>/<split>, the layout the CLIs' "
                        "--prepared-root reads")
    p.add_argument("--no-gen", action="store_true",
                   help="skip density-map generation (the .npy maps exist)")
    p.add_argument("--verify-store", action="store_true",
                   help="re-read a prepared store and check every file's CRC "
                        "against its manifest")
    p.add_argument("--gt-downsample", type=int, default=8)
    p.add_argument("--quiet", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from can_tpu_torch.data.density import generate_density_maps
    from can_tpu_torch.data.prepared import PreparedStore, write_store

    args = parse_args(argv)
    dirs = list(args.dirs or [])
    if args.root:
        for split in ("train", "test"):
            d = os.path.join(args.root, f"{split}_data", "images")
            if os.path.isdir(d):
                dirs.append(d)
    if not dirs:
        raise SystemExit("no image directories given (use --root or --dirs)")

    if not args.no_gen and not (args.verify_store and not args.prepared):
        n = generate_density_maps(dirs, k=args.k, sigma_scale=args.sigma_scale,
                                  verbose=not args.quiet)
        print(f"wrote {n} density maps")
    if args.prepared:
        for img_dir in dirs:
            root = write_store(img_dir, _gt_dir_for(img_dir),
                               _store_out(args.prepared_out, img_dir),
                               gt_downsample=args.gt_downsample,
                               verbose=not args.quiet)
            print(f"baked prepared store at {root}")
    if args.verify_store:
        for img_dir in dirs:
            gt_dir = _gt_dir_for(img_dir)
            root = (_store_out(args.prepared_out, img_dir)
                    or PreparedStore.default_root(gt_dir))
            store = PreparedStore.open(root, gt_dmap_root=gt_dir,
                                       gt_downsample=args.gt_downsample)
            print(f"verified {store.verify()} prepared files under {root}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
