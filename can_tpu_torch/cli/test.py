"""Evaluation CLI: dataset MAE/MSE of a checkpoint, and one image's
density maps as PNGs (counterpart of ``can_tpu/cli/test.py``)::

    python -m can_tpu_torch.cli.test --data_root part_A \\
        --checkpoint-dir ./checkpoints --syncBN --show-index 0

The weights come from the port's checkpoint directory (the best MAE by
default, else the latest, or ``--epoch``), a reference-layout
``--torch-pth`` or a ``save_params_npz`` ``--params-npz``.  The split is
batched by the same planner as training (``--pad-multiple`` defaults to
``exact``: no padding, so the numbers are the reference's per-image
math), loaded on ``--num-workers`` threads and put on the card two
batches ahead.  ``--platform default`` (or ``gpu``) runs on the CUDA
device and exits non-zero when there is none; ``--platform cpu`` is the
explicit CPU run.  Under a launcher (``torchrun --nproc_per_node=N -m
can_tpu_torch.cli.test ...``; ``parallel/runtime.py``) each process
evaluates its slice of every launch (launch sizes are multiples of the
process count) and the sums are global: the same MAE/MSE as one
process; ``--show-index`` writes its PNGs on rank 0 only.  ``--sp K``
splits each image's height over K processes (``parallel/spatial.py``):
bucket H is padded to multiples of 8*K (exact shapes cannot shard), the
per-image counts are summed over a replica's shards before ``|et -
gt|``, and ``--show-index`` runs the H-sharded forward on the first
replica's K ranks, the image's H padded to ``max(ceil(h / 8K) * 8K,
16K)`` and the map cropped back.  The train CLI's nine telemetry flags
apply here too (``cli/train.py``): ``--telemetry-dir`` writes the eval
loop's ``compile`` / ``step_window`` / ``stall`` / ``memory`` /
``perf.summary`` events and one ``epoch`` event with the MAE and MSE,
``--trace-steps A:B --profile-dir D`` traces eval batches A..B-1.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from can_tpu_torch.cli.common import (
    DEFAULT_LAUNCH_COST_MPX,
    parse_launch_cost,
    parse_pad_multiple,
    print_data_line,
    resolve_launch_cost_px,
    resolve_num_workers,
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
    p = argparse.ArgumentParser(description="CANNet evaluation (PyTorch/CUDA)")
    p.add_argument("--data_root", type=str, default="",
                   help="ShanghaiTech-layout root "
                        "(<root>/<split>_data/{images,ground_truth})")
    p.add_argument("--image-root", type=str, default="",
                   help="explicit image dir; pair with --gt-root")
    p.add_argument("--gt-root", type=str, default="")
    p.add_argument("--split", type=str, default="test", choices=["train", "test"])
    # None until validate_params_source: the --torch-pth conflict keys on
    # whether the flag was given, not on its default's value
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="the train CLI's checkpoint dir (default ./checkpoints)")
    p.add_argument("--epoch", type=int, default=None,
                   help="checkpoint epoch (default: best by MAE, else latest)")
    p.add_argument("--torch-pth", type=str, default="",
                   help="evaluate a reference-layout torch checkpoint")
    p.add_argument("--params-npz", type=str, default="",
                   help="evaluate a can_tpu save_params_npz .npz")
    p.add_argument("--batch-size", type=int, default=1,
                   help="images per process per launch")
    p.add_argument("--sp", type=int, default=1,
                   help="spatial (image-height) shards per replica: each "
                        "image's rows split over this many processes")
    p.add_argument("--pad-multiple", type=parse_pad_multiple, default="exact",
                   help="'exact' (default): no padding, the reference's "
                        "boundary math; 'auto': the planner's buckets; or "
                        "an integer multiple of 8")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--show-index", type=int, default=None,
                   help="also save this item's image and density maps as PNGs")
    p.add_argument("--out-dir", type=str, default="./eval_out")
    p.add_argument("--platform", type=str, default="default",
                   choices=list(PLATFORMS),
                   help="default/gpu: the CUDA device cuda:LOCAL_RANK (exit "
                        "non-zero without it); cpu: run on the CPU")
    p.add_argument("--syncBN", action="store_true",
                   help="the checkpoint is the BatchNorm model")
    p.add_argument("--u8-input", action="store_true",
                   help="ship uint8 pixels, normalise on the device")
    p.add_argument("--num-workers", type=int, default=None,
                   help="data-loading threads (default min(8, CPUs); 0 = "
                        "load in the main thread)")
    p.add_argument("--prepared-root", type=str, default="auto",
                   help="prepared 1/8-density store: 'auto' (default) "
                        "probes <gt_root>/prepared; 'off'; or a root of "
                        "per-split stores (<path>/<split>) that must validate")
    p.add_argument("--item-cache-mb", type=float, default=0.0,
                   help="in-memory LRU over decoded items, in MB (0 = off)")
    p.add_argument("--max-buckets", type=int, default=24,
                   help="budget of distinct (shape x size) programs for "
                        "--pad-multiple auto")
    p.add_argument("--no-remnant-batches", action="store_true",
                   help="pad straggler groups to the full batch instead of "
                        "launching them at their exact size")
    p.add_argument("--launch-cost-mpx", type=parse_launch_cost,
                   default=DEFAULT_LAUNCH_COST_MPX,
                   help="per-launch cost for the planner, in megapixel "
                        "equivalents, or 'auto' to measure this host")
    from can_tpu_torch.cli.train import add_compile_cache_arg, add_telemetry_args

    add_compile_cache_arg(p)
    add_telemetry_args(p)
    return p.parse_args(argv)


def validate_params_source(args) -> None:
    """Reject conflicting or missing weight sources, then default
    ``--checkpoint-dir``.  Shared by the eval and serve CLIs; pure
    argument checks, before any device work."""
    if args.torch_pth and args.params_npz:
        raise SystemExit("give --torch-pth OR --params-npz, not both")
    imported = bool(args.torch_pth or args.params_npz)
    if imported and args.syncBN:
        raise SystemExit("--torch-pth/--params-npz hold the reference "
                         "model (no BatchNorm); drop --syncBN")
    # an imported file is a whole model: checkpoint selection would be
    # ignored silently, so it is refused like the conflicts above
    if imported and args.epoch is not None:
        raise SystemExit("--epoch selects a checkpoint epoch; it does not "
                         "apply to --torch-pth/--params-npz")
    if imported and args.checkpoint_dir is not None:
        raise SystemExit("--checkpoint-dir is ignored with "
                         "--torch-pth/--params-npz; drop one of them")
    for path in (args.torch_pth, args.params_npz):
        if path and not os.path.isfile(path):
            raise SystemExit(f"no such checkpoint file: {path}")
    if args.checkpoint_dir is None:
        args.checkpoint_dir = "./checkpoints"


def load_params(args):
    """The reference-layout f32 state dict the args name: the checkpoint
    directory's best-MAE epoch (else the latest, or ``--epoch``), or an
    imported ``.pth``/``.npz``.  Returns ``(state_dict, epoch or None)``."""
    from can_tpu_torch.utils.checkpoint import CheckpointManager, has_checkpoint
    from can_tpu_torch.utils.torch_import import (
        check_state_dict,
        is_batch_norm_layout,
        load_params_npz,
        load_torch_checkpoint,
    )

    if args.torch_pth:
        print(f"[load] reference torch checkpoint {args.torch_pth}")
        return load_torch_checkpoint(args.torch_pth), None
    if args.params_npz:
        print(f"[load] imported params {args.params_npz}")
        return load_params_npz(args.params_npz), None
    if not has_checkpoint(args.checkpoint_dir):
        raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")
    ckpt = CheckpointManager(args.checkpoint_dir)
    epoch = args.epoch
    if epoch is None:
        epoch = ckpt.best_epoch()
    if epoch is None:  # no metrics recorded: the latest
        epoch = ckpt.latest_epoch()
    try:
        sd = check_state_dict(ckpt.model_state_dict(epoch))
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from None
    if is_batch_norm_layout(sd) != bool(args.syncBN):
        raise SystemExit(
            f"checkpoint {epoch} under {args.checkpoint_dir} holds the "
            f"{'BN' if is_batch_norm_layout(sd) else 'plain'} model; "
            f"{'add' if is_batch_norm_layout(sd) else 'drop'} --syncBN")
    print(f"[load] epoch {epoch} from {args.checkpoint_dir}")
    return sd, epoch


def build_model(state_dict, device):
    """CANNet (plain or BN, as the state dict says) on ``device`` in eval
    use, channels_last."""
    from can_tpu_torch.models import CANNet
    from can_tpu_torch.utils.torch_import import is_batch_norm_layout

    model = CANNet(device=device, seed=None,
                   batch_norm=is_batch_norm_layout(state_dict))
    model.load_state_dict(state_dict, strict=True)
    return model.to(memory_format=torch.channels_last).eval()


def evaluate_checkpoint(args, *, prefetch: Optional[int] = None) -> dict:
    """The whole run; returns ``{"mae", "mse", "num_images", "batches",
    "eval_s" (the eval epoch's wall time), "epoch", "density" (the
    ``--show-index`` item's estimated map, (h, w, 1), or None),
    "viz_paths"}``.  ``prefetch``: batches put on the device ahead
    (default: the priced ``sched.prefetch_depth_for`` on the card, 0 on
    the CPU).
    Raises SystemExit on bad arguments and without the asked-for
    device.  Joins the process group a launcher describes and leaves it
    at the end, unless the caller formed it."""
    from can_tpu_torch.cli.train import (
        apply_compile_cache,
        validate_incident_args,
        validate_trace_args,
    )
    from can_tpu_torch.parallel import (
        init_runtime,
        is_main_process,
        runtime_active,
        shutdown_runtime,
    )

    roots = resolve_split_roots(args.split, args.image_root, args.gt_root,
                                args.data_root, flag_stem="")
    validate_params_source(args)
    if args.sp < 1:
        raise SystemExit("--sp must be >= 1")
    if args.batch_size < 1:
        raise SystemExit("--batch-size must be >= 1")
    if args.item_cache_mb < 0:
        raise SystemExit("--item-cache-mb must be >= 0")
    trace_window = validate_trace_args(args)
    validate_incident_args(args)
    owned = not runtime_active()
    try:
        topo = init_runtime(platform=args.platform)
    except NoCudaDeviceError as e:
        raise SystemExit(f"[eval] {e}") from None
    try:
        apply_compile_cache(args, announce=is_main_process())
        if topo["process_count"] % args.sp:
            raise SystemExit(f"[eval] --sp {args.sp} does not divide the "
                             f"process count {topo['process_count']}")
        return _evaluate(args, roots, torch.device(topo["device"]), prefetch,
                         trace_window)
    finally:
        if owned:
            shutdown_runtime()


def _evaluate(args, roots, device, prefetch, trace_window=None) -> dict:
    from can_tpu_torch.cli.train import build_telemetry, wants_instrumentation
    from can_tpu_torch.obs import shutdown_telemetry
    from can_tpu_torch.parallel import process_index

    telemetry, heartbeat, exporter = build_telemetry(
        args, host_id=process_index(), trace_window=trace_window,
        device=device)
    try:
        # the loops are instrumented only when something consumes them
        loop_tel = (telemetry if wants_instrumentation(args, trace_window)
                    else None)
        return _evaluate_on(args, roots, device, prefetch, telemetry, loop_tel)
    finally:
        # the one teardown order shared with the SIGTERM path
        shutdown_telemetry(telemetry, heartbeat=heartbeat, exporter=exporter)


def _evaluate_on(args, roots, device, prefetch, telemetry, loop_tel) -> dict:
    from can_tpu_torch.cli.common import (
        build_mesh_and_batch,
        make_cached_sp_eval_step,
        resolve_sp_padding,
    )
    from can_tpu_torch.data import CrowdDataset, ItemCache, ShardedBatcher, StaleStoreError
    from can_tpu_torch.data import normalize_host
    from can_tpu_torch.data.prefetch import DevicePut
    from can_tpu_torch.parallel import is_main_process, make_dp_eval_step
    from can_tpu_torch.parallel.data_parallel import spatial_rows
    from can_tpu_torch.parallel.spatial import make_spatial_apply
    from can_tpu_torch.train import evaluate
    from can_tpu_torch.utils.viz import save_density_visualization

    img_root, gt_root = roots
    main = is_main_process()
    if device.type == "cuda":
        use_deterministic()  # the train CLI's settings: the same eval numbers
        if not args.bf16:
            use_full_f32()
    compute_dtype = torch.bfloat16 if args.bf16 else None

    state_dict, epoch = load_params(args)
    model = build_model(state_dict, device)
    item_cache = (ItemCache(int(args.item_cache_mb * 1e6))
                  if args.item_cache_mb > 0 else None)
    try:
        ds = CrowdDataset(img_root, gt_root, phase="test", u8_output=args.u8_input,
                          prepared=split_prepared_spec(args.prepared_root,
                                                       args.split),
                          item_cache=item_cache)
    except StaleStoreError as e:
        raise SystemExit(f"--prepared-root {args.prepared_root}: {e}") from None
    note = ds.prepared_note
    telemetry.emit("data.prepared", split=args.split, **note)
    if main:
        print(f"[data] prepared store: "
              f"{'on' if note['active'] else 'off (' + str(note['reason']) + ')'}")
    # each replica's slice of every launch (its sp ranks load the same
    # one and keep their rows); launch sizes split evenly
    mesh, host_batch, dp = build_mesh_and_batch(args.batch_size, args.sp)
    sp = mesh.sp
    pad_multiple, min_pad, min_bucket_h = resolve_sp_padding(args.pad_multiple, sp)
    if sp > 1 and main and pad_multiple != args.pad_multiple:
        # sp changes the reported numbers' boundary math: say so
        print(f"[data] sp={sp}: bucket H padded to multiples of {8 * sp} "
              f"(exact shapes can't shard)")
    batcher = ShardedBatcher(
        ds, host_batch, shuffle=False, seed=args.seed,
        process_index=mesh.d, process_count=dp, batch_quantum=dp,
        pad_multiple=pad_multiple, min_pad_multiple=min_pad,
        min_bucket_h=min_bucket_h, max_buckets=args.max_buckets,
        num_workers=resolve_num_workers(args.num_workers),
        remnant_sizes=not args.no_remnant_batches,
        launch_cost_px=resolve_launch_cost_px(args.launch_cost_mpx, device,
                                              announce=main))
    if main:
        print_data_line(args.split, batcher)
        fill = ((1 + batcher.schedule_overhead(0))
                / (1 + batcher.padding_overhead()) - 1)
        if fill > 0.5 and args.no_remnant_batches:
            print(f"[data] hint: fill slots add {fill:.0%} compute — drop "
                  f"--no-remnant-batches or use a smaller --batch-size")
    try:
        put = DevicePut(device)
        if sp > 1:
            eval_step = make_cached_sp_eval_step(mesh, compute_dtype=compute_dtype)
            put_fn = lambda b: put(spatial_rows(b, mesh))  # noqa: E731
        else:
            eval_step = make_dp_eval_step(mesh, compute_dtype=compute_dtype)
            put_fn = put
        t0 = time.perf_counter()
        metrics = evaluate(eval_step, model, batcher.epoch(0), put_fn=put_fn,
                           dataset_size=batcher.dataset_size,
                           prefetch=(put.depth_for(batcher) if prefetch is None
                                     else prefetch),
                           telemetry=loop_tel)
        eval_s = time.perf_counter() - t0
    finally:
        batcher.close()
    telemetry.emit("epoch", step=0, phase="eval", mae=metrics["mae"],
                   mse=metrics["mse"], num_images=metrics["num_images"])
    if item_cache is not None:
        telemetry.emit("data.cache", step=0, **item_cache.stats())
    if item_cache is not None and main:
        print(f"[data] item cache: {item_cache.stats()}")
    if main:
        print(f"[result] images={metrics['num_images']} "
              f"MAE={metrics['mae']:.3f} MSE={metrics['mse']:.3f}", flush=True)
    out = dict(metrics, eval_s=eval_s, epoch=epoch, density=None, viz_paths=[])
    # under sp the first replica's ranks run the sharded forward together
    if args.show_index is not None and (main or (sp > 1 and mesh.d == 0)):
        img, gt = ds[args.show_index]
        img = normalize_host(img)  # no-op for the f32 path
        if sp > 1:
            # the image may not fit one card (why --sp was asked for): pad
            # H to the sp constraints, crop the density map back
            h0, w0 = img.shape[:2]
            need = 8 * sp
            ph = max(-(-h0 // need) * need, 16 * sp)
            pimg = np.zeros((ph, w0, 3), np.float32)
            pimg[:h0] = img
            # one image: a dp=1 x sp view of the first replica's ranks
            viz_mesh = dataclasses.replace(mesh, dp=1, d=0, data_group=None)
            fwd = make_spatial_apply(viz_mesh, (ph, w0),
                                     compute_dtype=compute_dtype)
            et = fwd(model, torch.from_numpy(pimg)[None])[:, : h0 // 8]
        else:
            with torch.inference_mode():
                et = model(torch.from_numpy(np.ascontiguousarray(img))[None]
                           .to(device), compute_dtype=compute_dtype)
        if main:
            out["density"] = et[0].float().cpu().numpy()
            out["viz_paths"] = save_density_visualization(
                img, gt, out["density"], args.out_dir,
                tag=f"{args.split}_{args.show_index}")
            print(f"[viz] wrote {out['viz_paths']}")
    return out


def main(argv=None) -> int:
    evaluate_checkpoint(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
