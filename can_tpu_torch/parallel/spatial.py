"""Spatial parallelism: image-height sharding with halo exchange
(counterpart of ``can_tpu/parallel/spatial.py``).

One image's rows are split over the ``sp`` ranks of a data-parallel
replica (``parallel/mesh.py``: ``rank = d * sp + s``, one GPU each), so an
image too large for one card trains and evaluates on several:

* every 3x3 (possibly dilated) conv first exchanges ``dilation`` boundary
  rows with the neighbouring shards (``halo_exchange_rows``); the shards
  at the global top and bottom receive zeros, which is the conv's SAME
  zero padding, and the conv then pads only the columns;
* the adaptive average pool contracts each shard against its column
  slice of the (out x H) pooling matrix, and the partials are summed over
  the spatial group;
* the context tail (``ops/cuda_context.py``: the CUDA kernel on the card)
  runs on the shard's own feature rows with rows ``[row0, row0 + H_l)``
  of the whole map's row-interpolation matrix: no communication;
* max pooling stays local (shard heights are multiples of the /8
  downsampling, so no 2x2 window straddles a boundary);
* train-mode BatchNorm takes the moments of the whole dp x sp world
  (SyncBN through ``ops/bn_moments.py``: the BN-moments kernel on each
  rank's rows, then one all-reduce of the packed sums).

The same ``CANNet.forward`` runs sharded through its ``LocalOps`` seam
(``make_spatial_ops``).

Gradients.  Each collective is a ``torch.autograd.Function`` whose
backward is its transpose: the halo exchange sends the cotangents of the
received rows back and adds them into the sender's boundary rows; the
pooled sum's backward all-reduces the cotangent (what JAX's ``psum``
transposes to under ``check_vma=False``).  The train step
(``make_sp_train_step``) differentiates the local SSE divided by ``dp``
and then SUMS the gradients over the whole world in one all-reduce after
``backward()``, as JAX's step psums them: the ``sp`` shards of a replica
jointly compute that replica's gradient, and DDP, which averages over
its group, would divide by ``dp * sp``.  There is no DDP on this path:
its bucket all-reduces would run inside the backward while the halo
sends and receives run on the spatial group, where an edge rank issues
fewer of them than an interior one.

Halo transport, chosen from the spatial group's backend when the ops are
built (``HaloTransport``), never as a fallback after a failure:

* NCCL: ``dist.batch_isend_irecv`` on the device tensors;
* gloo with CPU tensors: ``isend`` / ``irecv`` as they are;
* gloo with CUDA tensors (two ranks on one card, which NCCL refuses):
  gloo sends and receives CPU tensors only, so the rows go through
  pinned host buffers.

Both run on H100s: two gloo ranks sharing one card
(``python3 chip_smoke.py``'s ``[sp]``) and one NCCL rank per card on a
4-GPU machine (``python3 chip_smoke.py --sp-nccl``).

``STATS`` counts the halo exchanges, their bytes sent and the pooled
all-reduces of this process, forward and backward, since the last
``reset_stats()``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from can_tpu_torch.models.cannet import LocalOps
from can_tpu_torch.ops.bn_moments import _AllReduceSum
from can_tpu_torch.ops.conv import conv2d
from can_tpu_torch.ops.pooling import adaptive_pool_matrix
from can_tpu_torch.parallel.mesh import Mesh
from can_tpu_torch.parallel.runtime import process_group
from can_tpu_torch.train.loss import density_counts, masked_mse_sum
from can_tpu_torch.train.steps import backward, global_norm, normalize_on_device

DS = 8  # the frontend's downsampling
STATS = {"halo_exchanges": 0, "halo_bytes": 0, "pool_allreduces": 0}
_stats_lock = threading.Lock()


def reset_stats() -> None:
    with _stats_lock:
        for k in STATS:
            STATS[k] = 0


def _count(key: str, n: int = 1) -> None:
    with _stats_lock:
        STATS[key] += n


class HaloTransport:
    """Moves boundary rows between the neighbouring shards of one
    spatial group: ``exchange(down, up) -> (from_above, from_below)``
    sends ``down`` to shard ``s + 1`` and ``up`` to shard ``s - 1`` and
    returns what shards ``s - 1`` and ``s + 1`` sent (zeros at the global
    edges, in the shape and dtype of ``down`` / ``up``).  The path is
    fixed here, from the group's backend and the tensors' device."""

    def __init__(self, mesh: Mesh, device):
        if mesh.sp < 2 or mesh.spatial_group is None:
            raise ValueError(f"a halo needs a spatial group of >= 2 ranks, "
                             f"got sp={mesh.sp}")
        self.mesh = mesh
        self.device = torch.device(device)
        self.backend = dist.get_backend(mesh.spatial_group)
        if self.backend == "nccl":
            if self.device.type != "cuda":
                raise ValueError("an NCCL spatial group exchanges CUDA tensors, "
                                 f"got {self.device}")
            self.path = "nccl"
        elif self.backend == "gloo":
            self.path = "gloo-host" if self.device.type == "cuda" else "gloo"
        else:
            raise ValueError(f"no halo transport over a {self.backend!r} group")
        s, sp = mesh.s, mesh.sp
        self.above = mesh.rank_of(mesh.d, s - 1) if s > 0 else None
        self.below = mesh.rank_of(mesh.d, s + 1) if s < sp - 1 else None

    def exchange(self, down: torch.Tensor, up: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        group = self.mesh.spatial_group
        from_above = torch.zeros_like(up)
        from_below = torch.zeros_like(down)
        sends = [(t, peer) for t, peer in ((down, self.below), (up, self.above))
                 if peer is not None]
        recvs = [(t, peer) for t, peer in ((from_above, self.above),
                                           (from_below, self.below))
                 if peer is not None]
        _count("halo_exchanges")
        _count("halo_bytes", sum(t.numel() * t.element_size() for t, _ in sends))
        if self.path == "nccl":
            ops = ([dist.P2POp(dist.isend, t, peer, group) for t, peer in sends]
                   + [dist.P2POp(dist.irecv, t, peer, group) for t, peer in recvs])
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            return from_above, from_below
        staged = self.path == "gloo-host"

        def pinned(t):
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

        # staged: a synchronous device-to-host copy (the rows are final);
        # the buffers live until the waits below
        out = [(pinned(t).copy_(t) if staged else t, peer) for t, peer in sends]
        works = [dist.isend(t, dst=peer, group=group) for t, peer in out]
        bufs = [(t, pinned(t) if staged else t, peer) for t, peer in recvs]
        works += [dist.irecv(b, src=peer, group=group) for _, b, peer in bufs]
        for work in works:
            work.wait()
        if staged:
            for t, b, _ in bufs:
                t.copy_(b, non_blocking=True)
        return from_above, from_below


class _HaloExchange(torch.autograd.Function):
    """(N, H_l, W, C) -> (N, H_l + 2 halo, W, C) with the neighbours'
    boundary rows; backward sends the received rows' cotangents back and
    adds what comes in to this shard's own boundary rows."""

    @staticmethod
    def forward(ctx, x, halo, transport):
        ctx.halo, ctx.transport = halo, transport
        above, below = transport.exchange(x[:, -halo:].contiguous(),
                                          x[:, :halo].contiguous())
        return torch.cat([above, x, below], dim=1)

    @staticmethod
    def backward(ctx, g):
        h = ctx.halo
        g_above, g_below = g[:, :h], g[:, -h:]
        # our received rows came from s - 1's last rows and s + 1's first:
        # their cotangents go back the way the rows came
        from_above, from_below = ctx.transport.exchange(
            g_below.contiguous(), g_above.contiguous())
        grad = g[:, h:-h].clone()
        grad[:, :h] += from_above
        grad[:, -h:] += from_below
        return grad, None, None


def halo_exchange_rows(x: torch.Tensor, halo: int, mesh: Mesh,
                       transport: Optional[HaloTransport] = None) -> torch.Tensor:
    """Concatenate ``halo`` rows from each H-neighbour onto a (N, H_l, W,
    C) block; the global-edge shards receive zeros (= SAME zero
    padding).  ``transport`` defaults to one for ``x``'s device."""
    if halo <= 0:
        return x
    if halo > x.shape[1]:
        raise ValueError(f"halo {halo} exceeds the shard's {x.shape[1]} rows")
    return _HaloExchange.apply(x, halo,
                               transport or HaloTransport(mesh, x.device))


def _spatial_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over the spatial group; the backward all-reduces the
    cotangent (``ops.bn_moments._AllReduceSum``)."""
    _count("pool_allreduces")
    return _PoolSum.apply(x, mesh.spatial_group)


class _PoolSum(_AllReduceSum):
    """``_AllReduceSum`` that counts its backward's all-reduce too."""

    @staticmethod
    def backward(ctx, grad):
        _count("pool_allreduces")
        return _AllReduceSum.apply(grad, ctx.group), None


def make_spatial_ops(mesh: Mesh, feat_hw: Tuple[int, int], *, device,
                     bn_axes=None, bn_shards: int = 1) -> LocalOps:
    """``LocalOps`` whose spatial primitives communicate over this rank's
    spatial group (``make_spatial_ops`` of can_tpu/parallel/spatial.py).

    feat_hw: the WHOLE feature map's (H/8, W) after the frontend — the
    pooling matrices' extent and the context tail's map; this rank holds
    its rows ``[s * H/8/sp, (s + 1) * H/8/sp)``.  bn_axes / bn_shards: the
    group the train-mode BN moments are summed over and its size (the
    world and ``dp * sp`` in the train step: SyncBN over the global
    batch).  device: where the activations live, which with the group's
    backend fixes the halo transport.
    """
    transport = HaloTransport(mesh, device)
    hg = feat_hw[0]
    if hg % mesh.sp:
        raise ValueError(f"feature height {hg} does not split over sp={mesh.sp}")
    row0 = mesh.s * (hg // mesh.sp)

    def conv2d_sp(x, w, b=None, *, dilation: int = 1, padding=None):
        kh = w.shape[2]
        halo = dilation * (kh // 2) if padding is None else padding
        if kh == 1 or halo == 0:
            return conv2d(x, w, b, dilation=dilation, padding=padding)
        xp = halo_exchange_rows(x, halo, mesh, transport)
        # rows are materialised (VALID); the columns keep SAME padding
        return conv2d(xp, w, b, dilation=dilation,
                      padding=(0, dilation * (w.shape[3] // 2)))

    def adaptive_pool_sp(x, output_size):
        if isinstance(output_size, int):
            output_size = (output_size, output_size)
        sh, sw = output_size
        hl = x.shape[-3]
        if hl * mesh.sp != hg:
            raise ValueError(f"a shard of {hl} rows in a map of {hg} over "
                             f"sp={mesh.sp}")
        ph = adaptive_pool_matrix(hg, sh, x.device)[:, mesh.s * hl:(mesh.s + 1) * hl]
        pw = adaptive_pool_matrix(x.shape[-2], sw, x.device)
        # the partials are summed in f32 and rounded once: the unsharded
        # pool's rounding (JAX rounds each partial to the compute dtype)
        part = torch.einsum("nhwc,ph,qw->npqc", x.float(), ph, pw)
        return _spatial_sum(part, mesh).to(x.dtype)

    return LocalOps(conv2d=conv2d_sp, adaptive_pool=adaptive_pool_sp,
                    global_hw=tuple(feat_hw),
                    context_row0=row0, bn_axes=bn_axes, bn_shards=bn_shards)


def _check_spatial_shapes(h: int, sp: int, ds: int = DS) -> None:
    if h % (ds * sp) != 0:
        raise ValueError(
            f"image height {h} must be divisible by downsample*sp = {ds * sp} "
            f"so max-pool windows never straddle shard boundaries "
            f"(pad with data/batching.py pad_multiple={ds * sp})")
    if sp > 1 and h // (ds * sp) < 2:
        # the dilated backend convs exchange a 2-row halo at 1/8 resolution;
        # a shard must own at least that many feature rows
        raise ValueError(
            f"image height {h} over sp={sp} leaves {h // (ds * sp)} feature "
            f"row(s) per shard; need >= 2 (the dilated-conv halo). Use fewer "
            f"spatial shards or taller images")


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _ops_for(mesh: Mesh, feat_hw: Tuple[int, int]) -> Callable:
    """``device -> LocalOps`` for the eval-mode forwards, each built at its
    first use: the device (the model's) is known only at the call."""
    cache: Dict[torch.device, LocalOps] = {}

    def get(device):
        if device not in cache:
            cache[device] = make_spatial_ops(mesh, feat_hw, device=device)
        return cache[device]

    return get


def _gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``t`` of every rank of ``group`` concatenated along ``dim`` in rank
    order (``t`` itself without a group).  Gathered on the device under
    NCCL, on the host under gloo."""
    if group is None:
        return t
    gdev = t.device if dist.get_backend(group) == "nccl" else torch.device("cpu")
    parts = [torch.empty(t.shape, dtype=t.dtype, device=gdev)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.to(gdev).contiguous(), group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def make_spatial_apply(mesh: Mesh, image_hw: Tuple[int, int], *,
                       compute_dtype=None) -> Callable:
    """H-sharded forward: ``apply(model, image) -> density map``
    (``make_spatial_apply`` of can_tpu/parallel/spatial.py).

    ``image`` is the whole (N, H, W, 3) batch, the same on every rank of
    the mesh (host or device); each rank runs its block — images
    ``[d * N/dp, (d + 1) * N/dp)``, rows ``[s * H/sp, (s + 1) * H/sp)`` —
    and the density blocks are gathered over the world, so every rank
    returns the whole (N, H/8, W/8, 1) map on the model's device (the
    blocks gathered over the spatial group, then the data group).  A BN
    model normalises with its running statistics (eval-mode BN is
    pointwise per channel: no collective).  Collective: every rank of the
    mesh calls it — a dp=1 view of one replica's spatial group
    (``dataclasses.replace(mesh, dp=1, d=0, data_group=None)``) runs on
    that replica's ranks alone.
    """
    sp, dp = mesh.sp, mesh.dp
    h, w = image_hw
    _check_spatial_shapes(h, sp)
    ops_for = _ops_for(mesh, (h // DS, w // DS))

    def apply(model, image):
        device = _model_device(model)
        n = image.shape[0]
        if n % dp or tuple(image.shape[1:3]) != (h, w):
            raise ValueError(f"apply takes (N, {h}, {w}, 3) with N a multiple "
                             f"of dp={dp}, got {tuple(image.shape)}")
        nl, hl = n // dp, h // sp
        block = torch.as_tensor(image)[mesh.d * nl:(mesh.d + 1) * nl,
                                       mesh.s * hl:(mesh.s + 1) * hl]
        with torch.inference_mode():
            out = model(block.to(device), compute_dtype=compute_dtype,
                        ops=ops_for(device))
            out = _gather(out, mesh.spatial_group, dim=1)  # the rows
            return _gather(out, mesh.data_group, dim=0)    # the images

    return apply


def make_sp_train_step(model: torch.nn.Module, mesh: Mesh,
                       image_hw: Tuple[int, int], *, compute_dtype=None,
                       bn_ops=None, remat: bool = False,
                       health_metrics: bool = False) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` with data AND
    spatial parallelism (``make_sp_train_step`` of
    can_tpu/parallel/spatial.py:175).

    batch: this rank's block of the global batch
    (``parallel.make_global_batch(..., spatial=True)``): its replica's
    images, its rows ``[s * H/sp, (s + 1) * H/sp)`` of image, and the same
    rows at /8 of dmap and pixel_mask.  The step differentiates the local
    SSE divided by ``dp`` (not ``dp * sp``: the shards of a replica
    jointly compute its gradient), sums the gradients over the world in
    one all-reduce of the flattened gradients, and steps the optimizer;
    the lr scales with ``dp`` (``make_lr_schedule(world_size=dp)``).  A
    BN model takes the moments of the global batch (SyncBN over the
    world, ``bn_shards = dp * sp``) through ``bn_ops``.  ``remat``
    recomputes the sharded forward segment by segment in the backward,
    halos and all-reduces included.

    metrics (device scalars): this rank's share, so that the train loop's
    per-window sum over the processes gives JAX's global values:
    ``loss`` the local SSE (summed over the world: the global SSE) and
    ``num_valid`` the replica's valid images on its ``s = 0`` rank and 0
    on the others (summed: the global count, as JAX's psum over data);
    with ``health_metrics`` also ``grad_norm`` and ``update_norm`` of the
    summed gradients, the same on every rank.
    """
    sp, dp = mesh.sp, mesh.dp
    h, w = image_hw
    _check_spatial_shapes(h, sp)
    world = process_group()
    ops = make_spatial_ops(mesh, (h // DS, w // DS), device=_model_device(model),
                           bn_axes=world, bn_shards=dp * sp)

    def train_step(state, batch):
        if state.model is not model:
            raise ValueError("make_sp_train_step was built for another model")
        if tuple(batch["image"].shape[1:3]) != (h // sp, w):
            raise ValueError(f"the step for {h}x{w} at sp={sp} takes "
                             f"{h // sp}-row blocks, got "
                             f"{tuple(batch['image'].shape)}")
        image = normalize_on_device(batch["image"], batch["pixel_mask"])
        pred = model(image, train=True, pixel_mask=batch["pixel_mask"],
                     sample_mask=batch["sample_mask"], bn_ops=bn_ops,
                     compute_dtype=compute_dtype, remat=remat, ops=ops)
        sse = masked_mse_sum(pred, batch)
        backward(state, sse / dp)
        params = [p for p in model.parameters() if p.grad is not None]
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=world)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        grad_norm = global_norm(grads) if health_metrics else None
        lr = state.apply_update()
        n_valid = torch.sum(batch["sample_mask"])
        metrics = {"loss": sse.detach(),
                   "num_valid": n_valid if mesh.s == 0 else torch.zeros_like(n_valid)}
        if health_metrics:
            bufs = [state.optimizer.state[p]["momentum_buffer"] for p in params]
            metrics["grad_norm"] = grad_norm
            metrics["update_norm"] = lr * global_norm(bufs)
        return state, metrics

    return train_step


def make_sp_eval_step(mesh: Mesh, image_hw: Tuple[int, int], *,
                      compute_dtype=None) -> Callable:
    """``eval_step(model, batch) -> metrics`` on this rank's block
    (``make_sp_eval_step`` of can_tpu/parallel/spatial.py:321): the
    per-image counts' partial sums are summed over the spatial group
    BEFORE ``|et - gt|`` (the absolute value does not commute with the
    shard sum), then ``abs_err_sum``, ``sq_err_sum`` and ``num_valid`` over
    the data group: global sums on every rank.  Eval-mode BN needs no
    collective."""
    sp = mesh.sp
    h, w = image_hw
    _check_spatial_shapes(h, sp)
    ops_for = _ops_for(mesh, (h // DS, w // DS))

    def eval_step(model, batch):
        with torch.inference_mode():
            image = normalize_on_device(batch["image"], batch["pixel_mask"])
            pred = model(image, compute_dtype=compute_dtype,
                         ops=ops_for(_model_device(model)))
            et, gt = density_counts(pred, batch)
            counts = torch.cat([et, gt])
            dist.all_reduce(counts, group=mesh.spatial_group)
            et, gt = counts.chunk(2)
            err = (et - gt) * batch["sample_mask"]
            sums = torch.stack([torch.sum(torch.abs(err)), torch.sum(err * err),
                                torch.sum(batch["sample_mask"])])
            if mesh.data_group is not None:
                dist.all_reduce(sums, group=mesh.data_group)
        return dict(zip(("abs_err_sum", "sq_err_sum", "num_valid"), sums.unbind()))

    return eval_step
