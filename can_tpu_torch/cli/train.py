"""Training CLI, one process per GPU (counterpart of
``can_tpu/cli/train.py``)::

    python -m can_tpu_torch.cli.train --data_root part_A --syncBN \\
        --bn-impl kernel --batch-size 8 --pad-multiple 64 --epochs 500
    torchrun --nproc_per_node=8 -m can_tpu_torch.cli.train \\
        --data_root part_A --syncBN --bn-impl kernel --batch-size 8

Trains CANNet (``--syncBN``: the BatchNorm model, its train-mode moments
through ``--bn-impl``; ``kernel`` is the CUDA kernel of ``ops/cuda_bn.py``)
from a ShanghaiTech-layout dataset, evaluates MAE/MSE every
``--eval-interval`` epochs and writes full-state checkpoints (latest 3
plus the best MAE) to ``--checkpoint-dir``; ``--init_checkpoint`` resumes.

``--platform default`` (or ``gpu``) trains on the CUDA device and exits
non-zero when there is none; ``--platform cpu`` is the explicit CPU run.
On the card training is deterministic (``device.use_deterministic``: the
same seed and data give the same weights bit for bit, so a resume is
exact), and in f32 TF32 is off.  ``--remat auto`` (the default)
recomputes the forward in the backward for launches whose footprint
would not fit the card otherwise.  ``--pad-multiple auto`` (the default, as in the JAX
package) buckets by exact shapes when at most ``--max-buckets`` occur,
else by the planner's ladder; straggler groups launch at their exact
size and the train batcher caps each launch at the card's memory
(``cli/common.py``).  Batches load on ``--num-workers`` threads and are
put on the card ahead at the scheduling core's priced depth
(``sched.prefetch_depth_for``, ``data/prefetch.py``); density maps come from
a prepared store where one validates (``--prepared-root``).

Under a launcher (``torchrun`` / ``torch.distributed.launch --use_env``,
the JAX package's ``COORDINATOR_ADDRESS`` variables, or SLURM's ``srun``:
``parallel/runtime.py``) each process trains on its own GPU
(``cuda:LOCAL_RANK``) over NCCL, or over gloo with ``--platform cpu``:
DDP averages the gradients, ``--batch-size`` is per process (the global
batch is ``batch_size * world``), the lr scales with the world, and with
``--syncBN`` every BN layer takes the global batch's moments (one
all-reduce of its packed sums).  Rank 0 logs, evaluates into the
checkpoint directory and writes checkpoints; every rank restores from
it.  ``--sp K`` splits each image's height over K processes
(``parallel/spatial.py``): the world is dp = processes / K replicas of K
shards, the ranks of a replica load the same images and keep their rows
of them, bucket H is padded to multiples of 8*K and at least 16*K, the
step sums its gradients over the world (no DDP) and the lr scales with
dp.  Elastic training and telemetry come with later slices (ROADMAP
Queue 1).
"""

from __future__ import annotations

import argparse
import datetime
import itertools
import os
import sys

import numpy as np
import torch

from can_tpu_torch.cli.common import (
    DEFAULT_LAUNCH_COST_MPX,
    agreed_device_memory_bytes,
    build_mesh_and_batch,
    make_cached_sp_eval_step,
    make_cached_sp_train_step,
    make_remat_policy,
    max_launch_pixels,
    parse_launch_cost,
    parse_pad_multiple,
    print_data_line,
    resolve_launch_cost_px,
    resolve_num_workers,
    resolve_sp_padding,
    resolve_split_roots,
    split_prepared_spec,
)
from can_tpu_torch.device import (
    PLATFORMS,
    NoCudaDeviceError,
    use_deterministic,
    use_full_f32,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CANNet training (PyTorch/CUDA)")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=1,
                   help="images per process (per GPU) per step; the global "
                        "batch is batch-size x processes")
    p.add_argument("--sp", type=int, default=1,
                   help="spatial (image-height) shards per replica: each "
                        "image's rows split over this many processes "
                        "(processes / sp data-parallel replicas)")
    p.add_argument("--lr", type=float, default=1e-7)
    p.add_argument("--lrf", type=float, default=1.0,
                   help="final lr fraction for a cosine decay (1.0 = constant)")
    p.add_argument("--syncBN", action="store_true",
                   help="train the BatchNorm variant of CANNet, its moments "
                        "those of the global batch across processes")
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
    p.add_argument("--remat", nargs="?", const="on", default="auto",
                   choices=["auto", "on", "off"],
                   help="recompute the forward segment by segment in the "
                        "backward (torch.utils.checkpoint): the same "
                        "gradients for less activation memory.  'auto' "
                        "(default) turns it on per launch shape where the "
                        "step's footprint without it would exceed 80%% of "
                        "the card's memory (cli/common.py); bare --remat "
                        "forces it on, 'off' disables it and caps launches "
                        "by the footprint without remat")
    p.add_argument("--vgg16-npz", type=str, default="",
                   help="pretrained VGG-16 frontend .npz "
                        "(tools/convert_vgg16.py's layout)")
    p.add_argument("--s2d-stem", action="store_true",
                   help="run the first frontend conv in space-to-depth "
                        "space (the folded kernel of ops/conv.py "
                        "fold_stem_kernel): the plain stem up to summation "
                        "order")
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
    p.add_argument("--allow-config-change", action="store_true",
                   help="permit resuming (--init_checkpoint) with "
                        "schedule-bearing flags (lr/lrf/epochs/batch/seed/"
                        "syncBN/bf16) that differ from the checkpoint's run; "
                        "without it such drift is an error")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pad-multiple", type=parse_pad_multiple, default="auto",
                   help="'auto' (default): exact shapes when at most "
                        "--max-buckets occur, else the planner's bucket "
                        "ladder; 'none'/'exact': exact snapped shapes; or "
                        "an integer multiple of 8")
    p.add_argument("--max-buckets", type=int, default=24,
                   help="budget of distinct (shape x batch size) programs "
                        "for --pad-multiple auto")
    p.add_argument("--no-remnant-batches", action="store_true",
                   help="pad straggler groups to the full batch instead of "
                        "launching them at their exact size")
    p.add_argument("--plan-mode", choices=("cost", "legacy"), default="cost",
                   help="batch-plan search: 'cost' (default) plans bucket "
                        "boundaries, per-cell batch sizes and remnant menus "
                        "under one cost model; 'legacy' is the earlier "
                        "heuristic planner, kept for comparison "
                        "(tools/plan_ablation.py)")
    p.add_argument("--launch-cost-mpx", type=parse_launch_cost,
                   default=DEFAULT_LAUNCH_COST_MPX,
                   help="fixed cost of one step launch in megapixel "
                        "equivalents, for the planner's pixels-against-"
                        "launches trade (default: the card's measured "
                        "launch, cli/common.py); 'auto' measures this host")
    p.add_argument("--num-workers", type=int, default=None,
                   help="data-loading threads (default min(8, CPUs); 0 = "
                        "load in the main thread)")
    p.add_argument("--prepared-root", type=str, default="auto",
                   help="prepared 1/8-density store: 'auto' (default) "
                        "probes each split's <gt_root>/prepared and decodes "
                        "when it is absent or stale; 'off'; or a root of "
                        "per-split stores (<path>/train, <path>/test) that "
                        "must validate")
    p.add_argument("--item-cache-mb", type=float, default=0.0,
                   help="in-memory LRU over decoded items, in MB, shared by "
                        "both splits (0 = off)")
    p.add_argument("--show", action="store_true",
                   help="save a test image's density maps as PNGs under "
                        "<checkpoint-dir>/temp at every eval")
    p.add_argument("--wandb", action="store_true",
                   help="also log to wandb where it is installed")
    p.add_argument("--eval-interval", type=int, default=1,
                   help="evaluate and checkpoint every N epochs (the final "
                        "epoch always evaluates)")
    p.add_argument("--max-steps-per-epoch", type=int, default=0,
                   help="truncate epochs (smoke runs); 0 = full epoch")
    p.add_argument("--platform", type=str, default="default",
                   choices=list(PLATFORMS),
                   help="default/gpu: the CUDA device cuda:LOCAL_RANK, NCCL "
                        "between processes (exit non-zero without it); cpu: "
                        "run on the CPU, gloo between processes")
    return p.parse_args(argv)


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
    if args.sp < 1:
        raise SystemExit("--sp must be >= 1")
    if args.s2d_stem and args.sp > 1:
        raise SystemExit("--s2d-stem is dp-path only (the sp step builds its "
                         "own sharded apply)")
    if args.item_cache_mb < 0:
        raise SystemExit("--item-cache-mb must be >= 0")
    roots = (resolve_split_roots("train", args.train_image_root,
                                 args.train_gt_root, args.data_root)
             + resolve_split_roots("test", args.test_image_root,
                                   args.test_gt_root, args.data_root))
    if args.init_torch_pth:
        if args.vgg16_npz:
            raise SystemExit("--init-torch-pth already contains the trained "
                             "frontend; drop --vgg16-npz")
        if args.init_checkpoint:
            raise SystemExit("--init-torch-pth (fresh warm-start) and "
                             "--init_checkpoint (full-state resume) conflict; "
                             "pick one")
        if not os.path.isfile(args.init_torch_pth):
            raise SystemExit(f"no such checkpoint file: {args.init_torch_pth}")
    if args.vgg16_npz and not os.path.isfile(args.vgg16_npz):
        raise SystemExit(f"no such VGG-16 file: {args.vgg16_npz}")
    if args.init_checkpoint:
        saved = load_run_config(args.init_checkpoint)
        if saved is not None and has_checkpoint(args.init_checkpoint):
            saved = {k: v for k, v in saved.items() if k != "world_size"}
            try:
                drifted = check_resume_config(saved, run_config(args),
                                              allow=args.allow_config_change)
            except ConfigDriftError as e:
                raise SystemExit(f"{e}: resume with the flags the checkpoint "
                                 f"was trained with (or pass "
                                 f"--allow-config-change)") from None
            if drifted:
                print(f"[resume] config drift allowed: {', '.join(drifted)}")
    return roots


def train(args) -> dict:
    """The whole run; returns ``{"steps", "schedule_steps" (the planned
    schedule's steps over the epochs run), "eval_batches", "epochs" (one
    dict per epoch), "best_mae", "checkpoint_dir", "world_size"}``.
    Raises SystemExit on bad arguments and without the asked-for device.
    Joins the process group a launcher describes (``init_runtime``) and
    leaves it at the end, unless the caller formed it."""
    from can_tpu_torch.parallel import init_runtime, runtime_active, shutdown_runtime

    roots = validate(args)
    owned = not runtime_active()
    try:
        topo = init_runtime(platform=args.platform)
    except NoCudaDeviceError as e:
        raise SystemExit(f"[train] {e}") from None
    try:
        return _train(args, roots, topo)
    finally:
        if owned:
            shutdown_runtime()


def _train(args, roots, topo) -> dict:
    from can_tpu_torch.data import CrowdDataset, ItemCache, ShardedBatcher, StaleStoreError
    from can_tpu_torch.data.prefetch import DevicePut
    from can_tpu_torch.models import CANNet, load_vgg16_frontend
    from can_tpu_torch.ops.bn_moments import make_bn_ops
    from can_tpu_torch.parallel import (
        is_main_process,
        make_dp_eval_step,
        make_dp_train_step,
    )
    from can_tpu_torch.parallel.data_parallel import spatial_rows
    from can_tpu_torch.train import (
        create_train_state,
        evaluate,
        make_lr_schedule,
        train_one_epoch,
    )
    from can_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        ConfigDriftError,
        check_resume_config,
        has_checkpoint,
        load_run_config,
        save_run_config,
    )
    from can_tpu_torch.utils.logging import MetricLogger

    train_img, train_gt, test_img, test_gt = roots
    device = torch.device(topo["device"])
    main = is_main_process()
    if device.type == "cuda":
        use_deterministic()
        if not args.bf16:
            use_full_f32()
    compute_dtype = torch.bfloat16 if args.bf16 else None
    try:
        mesh, host_batch, dp = build_mesh_and_batch(args.batch_size, args.sp)
    except ValueError as e:
        raise SystemExit(f"[train] {e}") from None
    sp = mesh.sp
    shards = dp * sp  # cards per launch
    pad_multiple, min_pad, min_bucket_h = resolve_sp_padding(args.pad_multiple, sp)
    if main:
        print(f"[start] {datetime.datetime.now():%Y-%m-%d %H:%M:%S} on {device}"
              + (f" ({torch.cuda.get_device_name(device)})"
                 if device.type == "cuda" else ""))
        if topo["backend"] is not None:
            print(f"[runtime] {topo}")

    item_cache = (ItemCache(int(args.item_cache_mb * 1e6))
                  if args.item_cache_mb > 0 else None)
    try:
        train_ds, test_ds = [
            CrowdDataset(img, gt, phase=split, u8_output=args.u8_input,
                         prepared=split_prepared_spec(args.prepared_root, split),
                         item_cache=item_cache)
            for split, img, gt in (("train", train_img, train_gt),
                                   ("test", test_img, test_gt))]
    except StaleStoreError as e:
        raise SystemExit(f"--prepared-root {args.prepared_root}: {e}") from None
    if main:
        print("[data] prepared store: " + " ".join(
            f"{split}={'on' if d.prepared_note['active'] else 'off (' + str(d.prepared_note['reason']) + ')'}"
            for split, d in (("train", train_ds), ("test", test_ds))))
    num_workers = resolve_num_workers(args.num_workers)
    if sp > 1 and main and pad_multiple != "auto":
        print(f"[data] sp={sp}: padding H,W to multiples of {pad_multiple}")
    # every launch splits evenly across the dp replicas, each replica's
    # ranks loading the same slice (the replica index d of dp); every
    # input of the plan below is agreed across processes
    common = dict(seed=args.seed, pad_multiple=pad_multiple,
                  min_pad_multiple=min_pad, min_bucket_h=min_bucket_h,
                  max_buckets=args.max_buckets, num_workers=num_workers,
                  plan_mode=args.plan_mode,
                  process_index=mesh.d, process_count=dp,
                  batch_quantum=dp,
                  remnant_sizes=not args.no_remnant_batches,
                  launch_cost_px=resolve_launch_cost_px(args.launch_cost_mpx,
                                                        device, announce=main))
    # the memory cap per launch: cells whose full batch would not fit the
    # card run at smaller menu sizes (remnant mode only, as in JAX); it
    # counts on remat, which the policy turns on where it is needed,
    # unless --remat off.  A launch is split across the dp x sp cards.
    hbm = agreed_device_memory_bytes(device)
    cap = (None if args.no_remnant_batches
           else max_launch_pixels(bf16=args.bf16, hbm_bytes=hbm,
                                  batch_norm=args.syncBN,
                                  remat=args.remat != "off", shards=shards))
    remat_policy = make_remat_policy(args.remat, global_batch=host_batch * dp,
                                     bf16=args.bf16, hbm_bytes=hbm,
                                     batch_norm=args.syncBN, announce=main,
                                     shards=shards)
    train_batcher = ShardedBatcher(train_ds, host_batch, shuffle=True,
                                   max_launch_px=cap, **common)
    test_batcher = ShardedBatcher(test_ds, host_batch, shuffle=False,
                                  **common)
    if main:
        print(f"[data] train={len(train_ds)} test={len(test_ds)} "
              f"batch={host_batch} per process x dp={dp}"
              + (f" x sp={sp} (rows split)" if sp > 1 else "") + " "
              f"workers={num_workers} launch cap "
              + (f"{cap / 1e6:.1f} Mpx" if cap is not None else "none"))
        print_data_line("train", train_batcher, remat_policy)
        print_data_line("test", test_batcher)

    # the same seed gives the same weights on every process
    model = CANNet(device=device, seed=args.seed, batch_norm=args.syncBN,
                   s2d_stem=args.s2d_stem)
    if args.vgg16_npz:
        load_vgg16_frontend(model, args.vgg16_npz)
        if main:
            print(f"[init] loaded the pretrained VGG-16 frontend from "
                  f"{args.vgg16_npz}")
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
        if main:
            print(f"[init] warm-started parameters from {args.init_torch_pth}")
    model = model.to(memory_format=torch.channels_last)
    bn_ops = make_bn_ops(args.bn_impl) if args.syncBN else None
    if args.syncBN and main:
        print(f"[model] BatchNorm variant, moments: {args.bn_impl}"
              + (f", synced across {shards} processes" if shards > 1 else ""))

    steps_per_epoch = train_batcher.batches_per_epoch(0)
    # linear lr scaling with the world: DDP averages the gradients
    schedule = make_lr_schedule(args.lr, world_size=dp,
                                total_steps=args.epochs * steps_per_epoch,
                                lrf=args.lrf)
    state = create_train_state(model, schedule)
    ckpt = CheckpointManager(args.checkpoint_dir)
    start_epoch, best = 0, None
    if args.init_checkpoint:
        # a world size other than the checkpoint's changes the schedule
        saved = load_run_config(args.init_checkpoint)
        if (saved is not None and "world_size" in saved
                and has_checkpoint(args.init_checkpoint)):
            try:
                check_resume_config({"world_size": saved["world_size"]},
                                    {"world_size": dp},
                                    allow=args.allow_config_change)
            except ConfigDriftError as e:
                raise SystemExit(f"{e}: the checkpoint trained at another "
                                 f"world size (pass --allow-config-change to "
                                 f"resume on this one)") from None
        probe = CheckpointManager(args.init_checkpoint)
        latest = probe.latest_epoch()
        if latest is None:
            if main:
                print(f"[resume] no checkpoint in {args.init_checkpoint}; "
                      f"cold start")
        else:
            probe.restore(state, epoch=latest)
            start_epoch, best = latest + 1, probe.best_metric()
            if main:
                print(f"[resume] epoch {latest} from {args.init_checkpoint} "
                      f"(step {state.step}, best MAE {best:.3f})")
    # after the resume check: an in-place resume reads the saved world first
    save_run_config(args.checkpoint_dir, dict(run_config(args), world_size=dp))

    if sp > 1:
        train_step = make_cached_sp_train_step(model, mesh, policy=remat_policy,
                                               compute_dtype=compute_dtype,
                                               bn_ops=bn_ops)
        eval_step = make_cached_sp_eval_step(mesh, compute_dtype=compute_dtype)
    else:
        train_step = make_dp_train_step(model, mesh, policy=remat_policy,
                                        compute_dtype=compute_dtype, bn_ops=bn_ops)
        eval_step = make_dp_eval_step(mesh, compute_dtype=compute_dtype)
    put = DevicePut(device)
    # under sp each rank keeps its rows of the replica's batch on the host
    put_fn = put if sp == 1 else (lambda b: put(spatial_rows(b, mesh)))
    # priced prefetch depth (the scheduling core's): once per run, a pure
    # function of each batcher's epoch-invariant schedule
    prefetch = put.depth_for(train_batcher)
    eval_prefetch = put.depth_for(test_batcher)
    logger = (MetricLogger(use_wandb=args.wandb, run_id_file=os.path.join(
        args.checkpoint_dir, "wandb_run_id.txt")) if main else None)
    summary = {"steps": 0, "schedule_steps": 0, "eval_batches": 0,
               "epochs": [], "checkpoint_dir": ckpt.directory,
               "world_size": dp}
    try:
        for epoch in range(start_epoch, args.epochs):
            batches = train_batcher.epoch(epoch)
            summary["schedule_steps"] += train_batcher.batches_per_epoch(epoch)
            if args.max_steps_per_epoch:
                batches = itertools.islice(batches, args.max_steps_per_epoch)
            lr = state.lr()
            state, stats = train_one_epoch(train_step, state, batches,
                                           put_fn=put_fn, epoch=epoch,
                                           prefetch=prefetch)
            row = {"epoch": epoch, "train_loss": stats.loss, "lr": lr,
                   "img_per_s": stats.img_per_s, "epoch_s": stats.seconds,
                   "steps": stats.steps,
                   "distinct_shapes": stats.distinct_shapes}
            summary["steps"] += stats.steps
            if (epoch + 1) % args.eval_interval == 0 or epoch == args.epochs - 1:
                metrics = evaluate(eval_step, state.model, test_batcher.epoch(0),
                                   put_fn=put_fn, prefetch=eval_prefetch,
                                   dataset_size=test_batcher.dataset_size)
                summary["eval_batches"] += metrics["batches"]
                row.update(mae=metrics["mae"], mse=metrics["mse"])
                ckpt.save(epoch, state, mae=metrics["mae"],
                          extra={"mse": metrics["mse"]})
                if best is None or metrics["mae"] < best:
                    best = metrics["mae"]
                    if main:
                        print(f"[best] epoch {epoch}: MAE {best:.3f}")
                if args.show and main:
                    _save_sample_viz(args, state.model, test_ds, epoch, logger,
                                     compute_dtype)
            if main:
                logger.log(row, step=epoch)
            summary["epochs"].append(row)
    finally:
        train_batcher.close()
        test_batcher.close()
        if logger is not None:
            logger.finish()
    if item_cache is not None and main:
        print(f"[data] item cache: {item_cache.stats()}")
    summary["best_mae"] = best
    if main:
        print(f"[done] best MAE {best:.3f}" if best is not None else "[done]")
    return summary


def _save_sample_viz(args, model, test_ds, epoch, logger, compute_dtype) -> None:
    """One seeded test image's ground-truth and estimated density maps as
    PNGs under ``<checkpoint-dir>/temp``, handed to the logger."""
    from can_tpu_torch.data import normalize_host
    from can_tpu_torch.utils.viz import save_density_visualization

    idx = int(np.random.default_rng((args.seed, epoch)).integers(len(test_ds)))
    img, gt = test_ds[idx]
    img = normalize_host(img)  # no-op for the f32 path
    device = next(model.parameters()).device
    with torch.inference_mode():
        et = model(torch.from_numpy(np.ascontiguousarray(img))[None].to(device),
                   compute_dtype=compute_dtype)
    paths = save_density_visualization(
        img, gt, et[0].float().cpu().numpy(),
        os.path.join(args.checkpoint_dir, "temp"), tag=f"epoch{epoch}")
    logger.log_images(paths, caption=f"epoch {epoch}", step=epoch)


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
