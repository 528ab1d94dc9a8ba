"""Training CLI, one process on one GPU (counterpart of
``can_tpu/cli/train.py``)::

    python -m can_tpu_torch.cli.train --data_root part_A --syncBN \\
        --bn-impl kernel --batch-size 8 --pad-multiple 64 --epochs 500

Trains CANNet (``--syncBN``: the BatchNorm model, its train-mode moments
through ``--bn-impl``; ``kernel`` is the CUDA kernel of ``ops/cuda_bn.py``)
from a ShanghaiTech-layout dataset, evaluates MAE/MSE every
``--eval-interval`` epochs and writes full-state checkpoints (latest 3
plus the best MAE) to ``--checkpoint-dir``; ``--init_checkpoint`` resumes.

``--platform default`` (or ``gpu``) trains on the CUDA device and exits
non-zero when there is none; ``--platform cpu`` is the explicit CPU run.
In f32 TF32 is off.  ``--pad-multiple`` defaults to ``none`` (exact
shapes): eager PyTorch compiles nothing per shape, so the JAX package's
``auto`` bucket ladder buys nothing here and is refused until the planner
slice.  DDP, cross-GPU SyncBN, prefetch, the prepared store and telemetry
come with later slices (ROADMAP Queue 1).
"""

from __future__ import annotations

import argparse
import datetime
import itertools
import os
import sys

import torch

from can_tpu_torch.device import PLATFORMS, NoCudaDeviceError, resolve_device, use_full_f32


def parse_pad_multiple(value: str):
    """``--pad-multiple``: an integer multiple, or none/exact/0 for exact
    shapes; ``auto`` is refused."""
    s = str(value).strip().lower()
    if s in ("none", "exact", "0"):
        return None
    if s == "auto":
        raise argparse.ArgumentTypeError(
            "'auto' (the bucket ladder) comes with the planner slice of "
            "can_tpu_torch (ROADMAP Queue 1); give an integer multiple of 8 "
            "or 'none'")
    try:
        return int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--pad-multiple takes an integer or 'none', got {value!r}") from None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CANNet training (PyTorch/CUDA, one GPU)")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-7)
    p.add_argument("--lrf", type=float, default=1.0,
                   help="final lr fraction for a cosine decay (1.0 = constant)")
    p.add_argument("--syncBN", action="store_true",
                   help="train the BatchNorm variant of CANNet (on one GPU "
                        "its moments are those of the local batch)")
    p.add_argument("--bn-impl", choices=("twopass", "onepass", "kernel"),
                   default="onepass",
                   help="train-mode BN moments (with --syncBN): 'onepass' "
                        "(default) one read per layer, 'twopass' mean then "
                        "centered variance, 'kernel' the CUDA moment-sums "
                        "kernel (its plain version on the CPU)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (f32 parameters, f32 BN moments)")
    p.add_argument("--u8-input", action="store_true",
                   help="ship uint8 pixels and normalise on the device")
    p.add_argument("--data_root", type=str, default="",
                   help="ShanghaiTech-layout root "
                        "(<root>/<split>_data/{images,ground_truth})")
    p.add_argument("--train-image-root", type=str, default="")
    p.add_argument("--train-gt-root", type=str, default="")
    p.add_argument("--test-image-root", type=str, default="")
    p.add_argument("--test-gt-root", type=str, default="")
    p.add_argument("--checkpoint-dir", type=str, default="./checkpoints")
    p.add_argument("--init_checkpoint", "--init-checkpoint", type=str,
                   default="", help="checkpoint dir to resume from (latest epoch)")
    p.add_argument("--init-torch-pth", type=str, default="",
                   help="warm-start the parameters from a reference-layout "
                        ".pth (strict layout check; optimizer and step fresh)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pad-multiple", type=parse_pad_multiple, default=None,
                   help="bucket H, W up to this multiple of 8; 'none' "
                        "(default) buckets by exact snapped shape")
    p.add_argument("--eval-interval", type=int, default=1,
                   help="evaluate and checkpoint every N epochs (the final "
                        "epoch always evaluates)")
    p.add_argument("--max-steps-per-epoch", type=int, default=0,
                   help="truncate epochs (smoke runs); 0 = full epoch")
    p.add_argument("--platform", type=str, default="default",
                   choices=list(PLATFORMS),
                   help="default/gpu: the CUDA device (exit non-zero without "
                        "one); cpu: run on the CPU")
    return p.parse_args(argv)


def resolve_split_roots(split: str, image_root: str, gt_root: str,
                        data_root: str):
    """Explicit per-split roots win over ``--data_root``'s ShanghaiTech
    layout; either give both roots of the split or a data root."""
    if image_root or gt_root:
        if not (image_root and gt_root):
            raise SystemExit(f"give both --{split}-image-root and "
                             f"--{split}-gt-root (or neither, with --data_root)")
        roots = (image_root, gt_root)
    elif data_root:
        base = os.path.join(data_root, f"{split}_data")
        roots = (os.path.join(base, "images"), os.path.join(base, "ground_truth"))
    else:
        raise SystemExit(f"need --data_root or --{split}-image-root/"
                         f"--{split}-gt-root")
    for d in roots:
        if not os.path.isdir(d):
            raise SystemExit(f"no such dataset directory: {d}")
    return roots


def run_config(args) -> dict:
    """The schedule-bearing flags a resume must not silently change."""
    return {"lr": args.lr, "lrf": args.lrf, "epochs": args.epochs,
            "batch_size": args.batch_size, "seed": args.seed,
            "syncBN": bool(args.syncBN), "bf16": bool(args.bf16)}


def validate(args):
    """Pure argument and file checks, before any device work; returns the
    split roots."""
    from can_tpu_torch.utils.checkpoint import (
        ConfigDriftError,
        check_resume_config,
        has_checkpoint,
        load_run_config,
    )

    if args.eval_interval < 1:
        raise SystemExit("--eval-interval must be >= 1 (the final epoch "
                         "always evaluates)")
    if args.batch_size < 1 or args.epochs < 1:
        raise SystemExit("--batch-size and --epochs must be >= 1")
    roots = (resolve_split_roots("train", args.train_image_root,
                                 args.train_gt_root, args.data_root)
             + resolve_split_roots("test", args.test_image_root,
                                   args.test_gt_root, args.data_root))
    if args.init_torch_pth:
        if args.init_checkpoint:
            raise SystemExit("--init-torch-pth (fresh warm-start) and "
                             "--init_checkpoint (full-state resume) conflict; "
                             "pick one")
        if not os.path.isfile(args.init_torch_pth):
            raise SystemExit(f"no such checkpoint file: {args.init_torch_pth}")
    if args.init_checkpoint:
        saved = load_run_config(args.init_checkpoint)
        if saved is not None and has_checkpoint(args.init_checkpoint):
            saved = {k: v for k, v in saved.items() if k != "world_size"}
            try:
                check_resume_config(saved, run_config(args))
            except ConfigDriftError as e:
                raise SystemExit(f"{e}: resume with the flags the checkpoint "
                                 f"was trained with") from None
    return roots


def train(args) -> dict:
    """The whole run; returns ``{"steps", "eval_batches", "epochs" (one
    dict per epoch), "best_mae", "checkpoint_dir"}``.  Raises SystemExit
    on bad arguments and without the asked-for device."""
    from can_tpu_torch.data import CrowdDataset, ShardedBatcher
    from can_tpu_torch.models import CANNet
    from can_tpu_torch.ops.bn_moments import make_bn_ops
    from can_tpu_torch.train import (
        create_train_state,
        evaluate,
        make_eval_step,
        make_lr_schedule,
        make_train_step,
        train_one_epoch,
    )
    from can_tpu_torch.train.steps import batch_to_device
    from can_tpu_torch.utils.checkpoint import CheckpointManager, save_run_config

    train_img, train_gt, test_img, test_gt = validate(args)
    try:
        device = resolve_device(args.platform)
    except NoCudaDeviceError as e:
        raise SystemExit(f"[train] {e}") from None
    if device.type == "cuda" and not args.bf16:
        use_full_f32()
    compute_dtype = torch.bfloat16 if args.bf16 else None
    print(f"[start] {datetime.datetime.now():%Y-%m-%d %H:%M:%S} on {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    train_ds = CrowdDataset(train_img, train_gt, phase="train",
                            u8_output=args.u8_input)
    test_ds = CrowdDataset(test_img, test_gt, phase="test",
                           u8_output=args.u8_input)
    train_batcher = ShardedBatcher(train_ds, args.batch_size, shuffle=True,
                                   seed=args.seed, pad_multiple=args.pad_multiple)
    test_batcher = ShardedBatcher(test_ds, args.batch_size, shuffle=False,
                                  seed=args.seed, pad_multiple=args.pad_multiple)
    print(f"[data] train={len(train_ds)} test={len(test_ds)} "
          f"batch={args.batch_size}")
    for tag, b in (("train", train_batcher), ("test", test_batcher)):
        print(f"[data] {tag}: buckets={b.describe_buckets()} -> "
              f"{b.distinct_shapes(0)} distinct batch shapes, "
              f"{b.batches_per_epoch(0)} batches, padding overhead "
              f"{b.padding_overhead():.1%}")

    model = CANNet(device=device, seed=args.seed, batch_norm=args.syncBN)
    if args.init_torch_pth:
        from can_tpu_torch.utils.torch_import import (
            is_batch_norm_layout,
            load_torch_checkpoint,
        )

        sd = load_torch_checkpoint(args.init_torch_pth)
        if is_batch_norm_layout(sd) != args.syncBN:
            raise SystemExit(
                f"--init-torch-pth {args.init_torch_pth} holds the "
                f"{'BN' if is_batch_norm_layout(sd) else 'plain'} model; "
                f"{'drop' if args.syncBN else 'add'} --syncBN")
        model.load_state_dict(sd, strict=True)
        print(f"[init] warm-started parameters from {args.init_torch_pth}")
    model = model.to(memory_format=torch.channels_last)
    bn_ops = make_bn_ops(args.bn_impl) if args.syncBN else None
    if args.syncBN:
        print(f"[model] BatchNorm variant, moments: {args.bn_impl}")

    steps_per_epoch = train_batcher.batches_per_epoch(0)
    schedule = make_lr_schedule(args.lr, world_size=1,
                                total_steps=args.epochs * steps_per_epoch,
                                lrf=args.lrf)
    state = create_train_state(model, schedule)
    ckpt = CheckpointManager(args.checkpoint_dir)
    start_epoch, best = 0, None
    if args.init_checkpoint:
        probe = CheckpointManager(args.init_checkpoint)
        latest = probe.latest_epoch()
        if latest is None:
            print(f"[resume] no checkpoint in {args.init_checkpoint}; cold start")
        else:
            probe.restore(state, epoch=latest)
            start_epoch, best = latest + 1, probe.best_metric()
            print(f"[resume] epoch {latest} from {args.init_checkpoint} "
                  f"(step {state.step}, best MAE {best:.3f})")
    save_run_config(args.checkpoint_dir, dict(run_config(args), world_size=1))

    train_step = make_train_step(compute_dtype=compute_dtype, bn_ops=bn_ops)
    eval_step = make_eval_step(compute_dtype=compute_dtype)
    put = lambda b: batch_to_device(b, device)  # noqa: E731
    summary = {"steps": 0, "eval_batches": 0, "epochs": [],
               "checkpoint_dir": ckpt.directory}
    for epoch in range(start_epoch, args.epochs):
        batches = train_batcher.epoch(epoch)
        if args.max_steps_per_epoch:
            batches = itertools.islice(batches, args.max_steps_per_epoch)
        lr = state.lr()
        state, stats = train_one_epoch(train_step, state, batches, put_fn=put,
                                       epoch=epoch)
        row = {"epoch": epoch, "train_loss": stats.loss, "lr": lr,
               "img_per_s": stats.img_per_s, "epoch_s": stats.seconds,
               "steps": stats.steps, "distinct_shapes": stats.distinct_shapes}
        summary["steps"] += stats.steps
        if (epoch + 1) % args.eval_interval == 0 or epoch == args.epochs - 1:
            metrics = evaluate(eval_step, state.model, test_batcher.epoch(0),
                               put_fn=put, dataset_size=test_batcher.dataset_size)
            summary["eval_batches"] += metrics["batches"]
            row.update(mae=metrics["mae"], mse=metrics["mse"])
            ckpt.save(epoch, state, mae=metrics["mae"],
                      extra={"mse": metrics["mse"]})
            if best is None or metrics["mae"] < best:
                best = metrics["mae"]
                print(f"[best] epoch {epoch}: MAE {best:.3f}")
        print("[epoch] " + " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()), flush=True)
        summary["epochs"].append(row)
    summary["best_mae"] = best
    print(f"[done] best MAE {best:.3f}" if best is not None else "[done]")
    return summary


def main(argv=None) -> int:
    from can_tpu_torch.train import NonFiniteLossError
    from can_tpu_torch.utils.checkpoint import CheckpointIOError

    args = parse_args(argv)
    try:
        train(args)
    except (NonFiniteLossError, CheckpointIOError) as e:
        print(f"[abort] {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
