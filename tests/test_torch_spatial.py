"""Spatial parallelism of can_tpu_torch (``parallel/spatial.py``) against
the JAX package's ``can_tpu/parallel/spatial.py`` on the CPU.

The port runs as gloo processes (this file as a script, one per rank,
``file://`` rendezvous under ``tmp_path``; ``test_torch_parallel.spawn``),
one rank per (d, s) of the (dp, sp) mesh; JAX runs on the 8 virtual CPU
devices ``tests/conftest.py`` sets up, and its float64 SyncBN step in a
subprocess (x64 is process-wide JAX config), as ``tests/bn_sp_x64_worker.py``
runs it.  Both sides start from the same He-scaled weights (numpy-seeded,
carried across with ``state_dict_from_jax_params``) and the same seeded
numpy batches.  Tolerances:

* the halo exchange: exact, rows and gradient;
* the sp forward against ``make_spatial_apply`` at (dp, sp) in {(1, 2),
  (2, 2), (1, 4)}: rtol 2e-4 / atol 1e-5 (tests/test_spatial.py:62-70);
* the height checks: JAX's messages, word for word;
* one plain f32 step at dp=2 x sp=2 against ``make_sp_train_step``: the
  loss at rtol 1e-4 and each parameter's update as tests/test_spatial.py
  holds JAX's own sharded step (max abs difference <= 2e-3 of the
  update's scale);
* the BN model's SyncBN step at dp=2 x sp=2 in float64 against JAX's in
  x64: each parameter's update within 1e-4 relative (the rule of
  ``parity_utils.worst_param_delta_rel``: max abs difference over the
  update's max; pre-BN conv biases, whose true gradient is 0, left out),
  the loss at 1e-6 relative, the running statistics within 1e-6 of
  their largest value.  The context tail runs in float64 on both sides
  (JAX's sp path has no fused tail; the port's seam gets a float64 plain
  version of the same function, as the kernel's contract is f32);
* sp remat against sp without it: bitwise;
* the sp eval against ``make_sp_eval_step``: rtol 2e-4 (abs) / 4e-4
  (squared), tests/test_spatial.py:182-185; the BN eval forward as the
  forward;
* the bf16 pooled sums at sp=2: each shard's partial is rounded to bf16
  before the f32 group sum, which is rounded once more — on partials
  where that double rounding differs from rounding the whole sum once,
  the port equals the hand-computed rounding exactly; on a seeded shard
  pair the port's pool is within one bf16 ulp of JAX's
  ``adaptive_pool_sp`` under ``shard_map``;
* the CLIs at ``--sp 2`` over 2 gloo processes against one process
  without sp, on the same buckets: MAE and MSE at rtol 2e-4 (the eval
  sums' tolerance above) and the ``--show-index`` map at the forward's;
  the sp refusals; ``resolve_sp_padding`` and the batcher's sp buckets
  equal to JAX's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from can_tpu_torch.data import make_synthetic_dataset
from can_tpu_torch.data.batching import Batch, pad_batch
from can_tpu_torch.models import CANNet
from can_tpu_torch.ops import bn_moments as bm
from can_tpu_torch.ops import cuda_context as cc
from can_tpu_torch.parallel import runtime as rt

ROOT = Path(__file__).resolve().parents[1]

KEYS = ("image", "dmap", "pixel_mask", "sample_mask")
HW = (64, 48)  # the smallest height sp=4 takes (2 feature rows per shard)
BN_HW = (48, 64)  # tests/test_torch_bn.py's x64 bucket
LR = 1e-5
BN_LR = 1e-3
TIMEOUT_S = 300


def spawn(tmp_path, mode, nproc, *args):
    """This file as ``nproc`` rank processes (``test_torch_parallel.spawn``;
    imported here, so the rank processes never import JAX)."""
    from test_torch_parallel import spawn as spawn_script

    return spawn_script(tmp_path, mode, nproc, *args, script=__file__,
                        timeout=TIMEOUT_S)


# -- inputs ------------------------------------------------------------------
def _image(b=2, seed=0, hw=HW):
    return np.random.default_rng(seed).normal(size=(b, *hw, 3)).astype(np.float32)


def _batch(seed, sizes, valid, bucket=HW) -> dict:
    rng = np.random.default_rng(seed)
    items = [(rng.standard_normal((h, w, 3)).astype(np.float32),
              rng.uniform(0, 0.1, (h // 8, w // 8, 1)).astype(np.float32))
             for h, w in sizes]
    b = pad_batch(items, bucket, len(sizes), valid, 8)
    return {k: getattr(b, k) for k in KEYS}


def _train_batch():
    return _batch(31, [(64, 48), (48, 40)], [True, True])


def _eval_batch():
    return _batch(32, [(64, 48), (56, 48), (64, 40), (64, 48)],
                  [True, True, True, False])


def _bn_batch():
    # rank (d, 1)'s rows of image 1 are partly padding: unequal valid
    # pixel counts per shard
    return _batch(33, [(48, 64), (40, 56)], [True, True], bucket=BN_HW)


def _bn_stats(stats):
    """Running stats moved off their init, so eval-mode BN must read them."""
    import jax

    return jax.tree.map(lambda a: (a + 0.1 * np.arange(a.size, dtype=np.float32)
                                   .reshape(a.shape) / a.size).astype(np.float32),
                        stats)


def _save(path, **arrays) -> str:
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})
    return str(path)


# -- the port's side (rank processes) ----------------------------------------
def _load_model(data, prefix, *, batch_norm=False, dtype=torch.float32,
                context_fused=None):
    sd = {k[len(prefix):]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith(prefix)}
    model = CANNet(seed=None, batch_norm=batch_norm, context_fused=context_fused)
    model.load_state_dict(sd)
    return model.to(dtype)


def _context_in_dtype(fv, aves, weights, hw, row0=None):
    """The context tail's function computed in fv's dtype (float64 here),
    on the shard's rows of the whole map's interpolation matrix:
    ``cuda_context.context_tail_reference`` without its f32 casts."""
    from can_tpu_torch.ops.resize import upsample_matrix

    h, w = hw
    rows = slice(row0 or 0, (row0 or 0) + fv.shape[1])
    num = torch.zeros_like(fv)
    den = torch.zeros_like(fv)
    for ave, wk in zip(aves, weights):
        uh = upsample_matrix(ave.shape[1], h).to(fv.dtype)[rows]
        uw = upsample_matrix(ave.shape[2], w).to(fv.dtype)
        sm = torch.einsum("bpqc,hp,wq->bhwc", ave, uh, uw)
        gate = torch.sigmoid(torch.matmul(sm - fv, wk))
        num = num + gate * sm
        den = den + gate
    return num / (den + cc.EPS)


def _block(batch: dict, mesh, dtype=None) -> dict:
    from can_tpu_torch.parallel import make_global_batch

    n = batch["image"].shape[0] // mesh.dp
    local = Batch(**{k: v[mesh.d * n:(mesh.d + 1) * n] for k, v in batch.items()})
    out = make_global_batch(local, mesh, device="cpu", spatial=True)
    return {k: v.to(dtype) for k, v in out.items()} if dtype else out


def _sd(model) -> dict:
    return {k: v.detach().clone().numpy() for k, v in model.state_dict().items()}


def _halo_check(mesh) -> dict:
    """Rows 8 per shard of a global (1, 8 sp, 2, 1) ramp, a 2-row halo, and
    the gradient of sum(y * weights) with weights a ramp of y's shape."""
    from can_tpu_torch.parallel import halo_exchange_rows

    sp, s = mesh.sp, mesh.s
    x = torch.arange(8 * sp * 2, dtype=torch.float64).reshape(1, 8 * sp, 2, 1)
    xl = x[:, s * 8:(s + 1) * 8].clone().requires_grad_()
    y = halo_exchange_rows(xl, 2, mesh)
    wts = torch.arange(y.numel(), dtype=torch.float64).reshape(y.shape) + 100 * s
    (y * wts).sum().backward()
    return {"y": y.detach().numpy().tolist(), "grad": xl.grad.numpy().tolist()}


def _sp_worker(rank, nproc, inputs, out, dp, sp) -> dict:
    from can_tpu_torch.cli.common import make_cached_sp_eval_step
    from can_tpu_torch.parallel import make_mesh, make_sp_train_step, make_spatial_apply
    from can_tpu_torch.train import create_train_state, make_lr_schedule

    dp, sp = int(dp), int(sp)
    data = np.load(inputs)
    mesh = make_mesh(dp=dp, sp=sp)
    res = {"mesh": [mesh.d, mesh.s], "halo": _halo_check(mesh)}
    arrays = {}
    model = _load_model(data, "sd/")
    image = torch.from_numpy(data["image"])
    arrays["fwd"] = make_spatial_apply(mesh, HW)(model, image).numpy()
    if "bn_sd/" + "frontend.0.weight" in data.files:
        bn = _load_model(data, "bn_sd/", batch_norm=True).eval()
        arrays["bn_fwd"] = make_spatial_apply(mesh, HW)(bn, image).numpy()
    tb = {k: data[f"train/{k}"] for k in KEYS}
    runs = {}
    for remat in ((False, True) if data["remat"] else (False,)):
        m = _load_model(data, "sd/")
        state = create_train_state(m, make_lr_schedule(LR, world_size=dp))
        step = make_sp_train_step(m, mesh, HW, remat=remat)
        state, metrics = step(state, _block(tb, mesh))
        loss = rt.reduce_value(np.float64(metrics["loss"]), average=False)
        nvalid = rt.reduce_value(np.float64(metrics["num_valid"]), average=False)
        runs[remat] = (_sd(m), float(loss), float(nvalid))
    arrays.update({f"step/{k}": v for k, v in runs[False][0].items()})
    res["loss"], res["num_valid"] = runs[False][1], runs[False][2]
    if True in runs:
        res["remat_bitwise"] = all(np.array_equal(runs[True][0][k], runs[False][0][k])
                                   for k in runs[False][0])
        res["remat_loss_equal"] = runs[True][1] == runs[False][1]
    eb = {k: data[f"eval/{k}"] for k in KEYS}
    ev = make_cached_sp_eval_step(mesh)(model, _block(eb, mesh))
    res["eval"] = {k: float(v) for k, v in ev.items()}
    if "bn64_sd/frontend.0.weight" in data.files:
        m = _load_model(data, "bn64_sd/", batch_norm=True, dtype=torch.float64,
                        context_fused=_context_in_dtype)
        state = create_train_state(m, make_lr_schedule(BN_LR, world_size=dp))
        step = make_sp_train_step(m, mesh, BN_HW, bn_ops=bm.make_bn_ops(data["bn_impl"].item()))
        bb = {k: data[f"bn/{k}"].astype(np.float64) for k in KEYS}
        state, metrics = step(state, _block(bb, mesh, torch.float64))
        res["bn_loss"] = float(rt.reduce_value(np.float64(metrics["loss"]),
                                               average=False))
        arrays.update({f"bn_step/{k}": v for k, v in _sd(m).items()})
    res["arrays"] = _save(f"{out}-rank{rank}.npz", **arrays)
    return res


# -- the JAX side --------------------------------------------------------------
def _jax_mesh(dp, sp):
    import jax

    from can_tpu.parallel import make_mesh as jax_make_mesh

    return jax_make_mesh(jax.devices()[:dp * sp], dp=dp, sp=sp)


def _jax_sp_step(params, batch, dp, sp, *, lr, hw, stats=None):
    """JAX's ``make_sp_train_step`` from ``params`` on ``batch``: returns
    (new params, new stats or None, loss)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from can_tpu.parallel.spatial import make_sp_train_step as jax_sp_step
    from can_tpu.train import create_train_state, make_lr_schedule, make_optimizer

    mesh = _jax_mesh(dp, sp)
    opt = make_optimizer(make_lr_schedule(lr, world_size=dp))
    spec = {k: P("data", "spatial", None, None) for k in KEYS[:3]}
    spec["sample_mask"] = P("data")
    gbatch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec[k]))
              for k, v in batch.items()}
    state = create_train_state(jax.tree.map(jnp.asarray, params), opt, stats)
    state, m = jax_sp_step(opt, mesh, hw, donate=False)(state, gbatch)
    new_stats = (None if stats is None
                 else jax.tree.map(np.asarray, state.batch_stats))
    return jax.tree.map(np.asarray, state.params), new_stats, float(m["loss"])


def _jax_x64_main(inputs: str, out: str) -> None:
    """JAX's float64 SyncBN step at dp=2 x sp=2 (a subprocess)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from can_tpu.models import init_batch_stats

    data = np.load(inputs, allow_pickle=True)
    params = data["bn_params"].item()
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    stats = jax.tree.map(lambda a: np.asarray(a, np.float64), init_batch_stats(params))
    batch = {k: data[f"bn/{k}"].astype(np.float64) for k in KEYS}
    new, new_stats, loss = _jax_sp_step(params, batch, 2, 2, lr=BN_LR, hw=BN_HW,
                                        stats=stats)
    np.savez(out, params=np.asarray(new, dtype=object),
             stats=np.asarray(new_stats, dtype=object))
    print(json.dumps({"loss": loss}))


# -- the runs ------------------------------------------------------------------
CONFIGS = ((1, 2), (2, 2), (1, 4))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's x64 step (a subprocess) alongside the port's three meshes, then
    JAX's f32 references in this process."""
    import jax

    from can_tpu.models import init_batch_stats
    from can_tpu_torch.utils.torch_import import state_dict_from_jax_params
    from test_torch_bn import jax_bn_params
    from test_torch_model import jax_params

    tmp = tmp_path_factory.mktemp("spatial")
    params = jax_params("he")
    bn_params = jax_bn_params()
    bn_stats = _bn_stats(jax.tree.map(np.asarray, init_batch_stats(bn_params)))
    base = {"image": _image(), "remat": False, "bn_impl": "kernel",
            **{f"sd/{k}": v for k, v in state_dict_from_jax_params(params).items()},
            **{f"train/{k}": v for k, v in _train_batch().items()},
            **{f"eval/{k}": v for k, v in _eval_batch().items()}}
    bn_sd = {f"bn_sd/{k}": v for k, v in
             state_dict_from_jax_params(bn_params, bn_stats).items()}
    bn64 = {f"bn64_sd/{k}": v for k, v in state_dict_from_jax_params(
        bn_params, jax.tree.map(np.asarray, init_batch_stats(bn_params))).items()}
    bn_batch = {f"bn/{k}": v for k, v in _bn_batch().items()}
    inputs = {
        (1, 2): _save(tmp / "in12.npz", **dict(base, remat=True, **bn_sd)),
        (2, 2): _save(tmp / "in22.npz", **dict(base, **bn64, **bn_batch)),
        (1, 4): _save(tmp / "in14.npz", **base),
    }
    x64_in = tmp / "x64in.npz"
    np.savez(x64_in, bn_params=np.asarray(bn_params, dtype=object), **bn_batch)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    jproc = subprocess.Popen(
        [sys.executable, __file__, "jax-x64", str(x64_in), str(tmp / "x64out.npz")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = {cfg: spawn(tmp, "sp", cfg[0] * cfg[1], inputs[cfg],
                           tmp / f"out{cfg[0]}{cfg[1]}", *cfg) for cfg in CONFIGS}
        want = _jax_references(params, bn_params, bn_stats)
        out, err = jproc.communicate(timeout=TIMEOUT_S)
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.communicate()
    assert jproc.returncode == 0, out[-3000:] + err[-3000:]
    x64 = np.load(tmp / "x64out.npz", allow_pickle=True)
    want["x64"] = {"params": x64["params"].item(), "stats": x64["stats"].item(),
                   "loss": json.loads(out.strip().splitlines()[-1])["loss"]}
    return {"port": port, "want": want, "params": params, "bn_params": bn_params}


def _jax_references(params, bn_params, bn_stats) -> dict:
    import jax
    import jax.numpy as jnp

    from can_tpu.data.batching import Batch as JaxBatch
    from can_tpu.parallel import make_global_batch as jax_global_batch
    from can_tpu.parallel.spatial import make_sp_eval_step, make_spatial_apply

    want = {}
    x = jnp.asarray(_image())
    for cfg in CONFIGS:
        want[("fwd", cfg)] = np.asarray(make_spatial_apply(_jax_mesh(*cfg), HW)(params, x))
    want["bn_fwd"] = np.asarray(make_spatial_apply(_jax_mesh(1, 2), HW)(
        bn_params, x, jax.tree.map(jnp.asarray, bn_stats)))
    want["step"] = _jax_sp_step(params, _train_batch(), 2, 2, lr=LR, hw=HW)
    mesh = _jax_mesh(2, 2)
    ev = make_sp_eval_step(mesh, HW)(
        params, jax_global_batch(JaxBatch(**_eval_batch()), mesh, spatial=True), None)
    want["eval"] = {k: float(v) for k, v in jax.device_get(ev).items()}
    return want


# -- the checks --------------------------------------------------------------
@pytest.mark.parametrize("cfg", CONFIGS, ids=["dp1-sp2", "dp2-sp2", "dp1-sp4"])
def test_halo_exchange_equals_zero_padding_with_its_gradient(runs, cfg):
    """Each shard's block with its halo is the zero-padded global ramp's
    rows; the gradient of every shard's weighted sum lands on the global
    rows each halo row came from (the global edges' zeros get none)."""
    dp, sp = cfg
    outs = runs["port"][cfg]
    x = np.arange(8 * sp * 2, dtype=np.float64).reshape(1, 8 * sp, 2, 1)
    full = np.pad(x, ((0, 0), (2, 2), (0, 0), (0, 0)))
    gfull = np.zeros_like(full)
    for s in range(sp):
        wts = np.arange(12 * 2, dtype=np.float64).reshape(1, 12, 2, 1) + 100 * s
        gfull[:, s * 8:s * 8 + 12] += wts
    for rank, out in enumerate(outs):
        d, s = out["mesh"]
        assert (d, s) == divmod(rank, sp)  # rank = d * sp + s
        np.testing.assert_array_equal(np.asarray(out["halo"]["y"]),
                                      full[:, s * 8:s * 8 + 12])
        np.testing.assert_array_equal(np.asarray(out["halo"]["grad"]),
                                      gfull[:, 2 + s * 8:2 + (s + 1) * 8])


@pytest.mark.parametrize("cfg", CONFIGS, ids=["dp1-sp2", "dp2-sp2", "dp1-sp4"])
def test_sp_forward_matches_make_spatial_apply(runs, cfg):
    want = runs["want"][("fwd", cfg)]
    assert np.abs(want).max() > 1e-2
    for out in runs["port"][cfg]:
        got = np.load(out["arrays"])["fwd"]
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_bn_eval_forward_matches_make_spatial_apply(runs):
    want = runs["want"]["bn_fwd"]
    for out in runs["port"][(1, 2)]:
        np.testing.assert_allclose(np.load(out["arrays"])["bn_fwd"], want,
                                   rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("h,sp", [(120, 8), (40, 2), (16, 2), (64, 8), (8, 1)])
def test_height_checks_carry_jax_messages(h, sp):
    from can_tpu.parallel.spatial import _check_spatial_shapes as jax_check
    from can_tpu_torch.parallel.mesh import Mesh
    from can_tpu_torch.parallel.spatial import _check_spatial_shapes, make_spatial_apply

    def outcome(fn):
        try:
            fn()
            return "ok"
        except ValueError as e:
            return str(e)

    got = outcome(lambda: _check_spatial_shapes(h, sp))
    assert got == outcome(lambda: jax_check(h, sp))
    # the step factories refuse before building anything
    assert outcome(lambda: make_spatial_apply(Mesh(dp=1, sp=sp), (h, 96))) == got


def test_plain_sp_step_matches_make_sp_train_step(runs):
    from can_tpu_torch.utils.torch_import import state_dict_from_jax_params

    new, _, jloss = runs["want"]["step"]
    want = state_dict_from_jax_params(new)
    old = state_dict_from_jax_params(runs["params"])
    outs = runs["port"][(2, 2)]
    for out in outs:
        np.testing.assert_allclose(out["loss"], jloss, rtol=1e-4)
        assert out["num_valid"] == 2.0
    ranks = [np.load(o["arrays"]) for o in outs]
    moved = 0
    for k in want:
        got = ranks[0][f"step/{k}"]
        for r in ranks[1:]:  # the replicas and shards agree
            np.testing.assert_array_equal(r[f"step/{k}"], got)
        p0 = old[k].numpy().astype(np.float64)
        da, db = got.astype(np.float64) - p0, want[k].numpy().astype(np.float64) - p0
        scale = max(np.abs(db).max(), 1e-12)
        assert np.abs(da - db).max() <= max(2e-3 * scale, 3e-8), k
        moved += scale > 3e-8
    assert moved == len(want)  # every tensor took a real step


def test_syncbn_sp_step_matches_jax_in_x64(runs):
    from can_tpu_torch.utils.torch_import import state_dict_from_jax_params
    from test_torch_bn import _pre_bn_bias

    x64 = runs["want"]["x64"]
    outs = runs["port"][(2, 2)]
    got_sd = np.load(outs[0]["arrays"])
    for o in outs[1:]:
        other = np.load(o["arrays"])
        for k in got_sd.files:
            if k.startswith("bn_step/"):
                np.testing.assert_array_equal(other[k], got_sd[k])
    assert abs(outs[0]["bn_loss"] - x64["loss"]) <= 1e-6 * abs(x64["loss"])
    # parity_utils.worst_param_delta_rel's rule over the state dict: per
    # tensor max|d_port - d_jax| / max|d_jax|, pre-BN conv biases left out
    want = state_dict_from_jax_params(x64["params"], x64["stats"])
    old = state_dict_from_jax_params(runs["bn_params"])
    worst, checked = 0.0, 0
    for k, v in want.items():
        got = got_sd[f"bn_step/{k}"].astype(np.float64)
        if k.endswith(("running_mean", "running_var")):
            # test_torch_bn._compare_updates' stats metric
            want_k = v.double().numpy()
            assert np.abs(got - want_k).max() <= 1e-6 * np.abs(want_k).max(), k
            continue
        if k.endswith("num_batches_tracked") or _pre_bn_bias(k, want):
            continue
        p0 = old[k].double().numpy()
        db = v.double().numpy() - p0
        worst = max(worst, float(np.abs(got - p0 - db).max()
                                 / max(np.abs(db).max(), 1e-12)))
        checked += 1
    assert checked == 16 * 3 + 2 + 8  # conv w, BN scale/bias; output; context
    assert worst <= 1e-4, worst


def test_sp_remat_is_bitwise_sp(runs):
    for out in runs["port"][(1, 2)]:
        assert out["remat_bitwise"] and out["remat_loss_equal"]


def test_sp_eval_matches_make_sp_eval_step(runs):
    want = runs["want"]["eval"]
    for out in runs["port"][(2, 2)]:
        got = out["eval"]
        assert got["num_valid"] == want["num_valid"] == 3.0
        np.testing.assert_allclose(got["abs_err_sum"], want["abs_err_sum"], rtol=2e-4)
        np.testing.assert_allclose(got["sq_err_sum"], want["sq_err_sum"], rtol=4e-4)


# -- the CLIs at --sp 2 --------------------------------------------------------
@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp_data")
    make_synthetic_dataset(str(root / "train_data"), 4, sizes=((64, 64), (48, 80)),
                           seed=0)
    make_synthetic_dataset(str(root / "test_data"), 3, sizes=((64, 64), (48, 80)),
                           seed=1)
    return root


def _train_argv(data, ck):
    return ["--data_root", str(data), "--batch-size", "2", "--epochs", "1",
            "--lr", "1e-7", "--pad-multiple", "16", "--platform", "cpu",
            "--num-workers", "0", "--prepared-root", "off", "--seed", "0",
            "--checkpoint-dir", str(ck)]


def _test_argv(data, ck, out_dir):
    return ["--data_root", str(data), "--checkpoint-dir", str(ck),
            "--pad-multiple", "16", "--platform", "cpu", "--num-workers", "0",
            "--prepared-root", "off", "--show-index", "0", "--out-dir", str(out_dir)]


def test_cli_train_and_eval_at_sp2_match_one_process(synth, tmp_path):
    from can_tpu_torch.cli import test as eval_cli
    from can_tpu_torch.cli import train as train_cli

    one = train_cli.train(train_cli.parse_args(_train_argv(synth, tmp_path / "ck1")))
    two = spawn(tmp_path, "cli", 2, synth, tmp_path / "ck2", tmp_path / "viz2")
    ev1 = eval_cli.evaluate_checkpoint(eval_cli.parse_args(
        _test_argv(synth, tmp_path / "ck1", tmp_path / "viz1")))
    row1 = one["epochs"][-1]
    assert one["steps"] == two[0]["steps"] == two[1]["steps"]
    for out in two:
        assert out["world_size"] == 1  # dp: the two ranks are one replica
        np.testing.assert_allclose([out["mae"], out["mse"]], [row1["mae"], row1["mse"]],
                                   rtol=2e-4)
        np.testing.assert_allclose([out["eval_mae"], out["eval_mse"]],
                                   [ev1["mae"], ev1["mse"]], rtol=2e-4)
    assert [Path(p).name for p in two[0]["viz_paths"]] == [Path(p).name for p in
                                                          ev1["viz_paths"]]
    assert two[1]["viz_paths"] == []  # rank 0 writes the PNGs
    np.testing.assert_allclose(np.load(two[0]["density"]), ev1["density"],
                               rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("argv,match", [
    (["--sp", "2", "--s2d-stem"], "--s2d-stem is dp-path only"),
    (["--sp", "0"], "--sp must be >= 1"),
    (["--sp", "2"], "--sp 2 does not divide the process count 1"),
])
def test_train_cli_sp_refusals(synth, tmp_path, argv, match):
    """JAX's refusal of the s2d stem under sp, and an sp the world cannot
    split, before any step runs."""
    from can_tpu_torch.cli import train as train_cli

    with pytest.raises(SystemExit, match=match):
        train_cli.train(train_cli.parse_args(_train_argv(synth, tmp_path / "ck") + argv))


def test_resolve_sp_padding_matches_jax():
    from can_tpu.cli.common import resolve_sp_padding as jax_resolve
    from can_tpu_torch.cli.common import resolve_sp_padding

    for pad in (None, "auto", 8, 16, 24, 64):
        for sp in (1, 2, 3, 4):
            assert resolve_sp_padding(pad, sp) == jax_resolve(pad, sp), (pad, sp)


@pytest.mark.parametrize("pad", [None, 16, "auto"])
@pytest.mark.parametrize("remnant", [False, True])
def test_sharded_batcher_sp_buckets_match_jax(pad, remnant):
    """``min_pad_multiple`` and ``min_bucket_h`` (the sp constraints of
    ``resolve_sp_padding``, sp=2): the same buckets and schedule as JAX's
    batcher, every bucket H a multiple of 16 and at least 32."""
    from can_tpu.cli.common import resolve_sp_padding
    from can_tpu.data.batching import ShardedBatcher as JaxShardedBatcher
    from can_tpu_torch.data import ShardedBatcher
    from test_torch_parallel import _ItemDs

    rng = np.random.default_rng(5)
    shapes = [(int(rng.integers(2, 12)) * 8, int(rng.integers(3, 9)) * 8)
              for _ in range(41)]
    pad_multiple, min_pad, min_h = resolve_sp_padding(pad, 2)
    kw = dict(shuffle=True, seed=3, pad_multiple=pad_multiple, min_pad_multiple=min_pad,
              min_bucket_h=min_h, max_buckets=6, remnant_sizes=remnant,
              launch_cost_px=300.0)
    port = ShardedBatcher(_ItemDs(shapes), 2, **kw)
    ref = JaxShardedBatcher(_ItemDs(shapes), 2, plan_mode="cost", **kw)
    assert port.bucket_ladder == ref.bucket_ladder
    assert port.global_schedule(1) == ref.global_schedule(1)
    keys = {key for key, _ in port.global_schedule(1)}
    assert all(h % 16 == 0 and h >= 32 for h, _ in keys), keys


def _cli_worker(rank, nproc, data, ck, viz) -> dict:
    from can_tpu_torch.cli import test as eval_cli
    from can_tpu_torch.cli import train as train_cli

    res = train_cli.train(train_cli.parse_args(_train_argv(data, ck) + ["--sp", "2"]))
    ev = eval_cli.evaluate_checkpoint(eval_cli.parse_args(
        _test_argv(data, ck, viz) + ["--sp", "2"]))
    out = {"steps": res["steps"], "world_size": res["world_size"],
           "mae": res["epochs"][-1]["mae"], "mse": res["epochs"][-1]["mse"],
           "eval_mae": ev["mae"], "eval_mse": ev["mse"], "viz_paths": ev["viz_paths"]}
    if ev["density"] is not None:
        out["density"] = f"{viz}-density.npy"
        np.save(out["density"], ev["density"])
    return out


POOL_SIZES = ((1, 1), (2, 2), (3, 3), (6, 6))


def _pool_worker(rank, nproc, inputs, out) -> dict:
    """The sp=2 bf16 pools of this rank's rows of each input at every
    POOL_SIZES."""
    from can_tpu_torch.parallel import make_mesh, make_spatial_ops

    mesh = make_mesh(dp=1, sp=2)
    data = np.load(inputs)
    pooled = {}
    for name in data.files:
        x = torch.from_numpy(data[name]).to(torch.bfloat16)
        hl = x.shape[1] // mesh.sp
        ops = make_spatial_ops(mesh, tuple(x.shape[1:3]), device="cpu")
        local = x[:, mesh.s * hl:(mesh.s + 1) * hl]
        pooled.update({f"{name}/{i}": ops.adaptive_pool(local, size).float().numpy()
                       for i, size in enumerate(POOL_SIZES)})
    return {"arrays": _save(f"{out}-rank{rank}.npz", **pooled)}


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def pool_runs(tmp_path_factory):
    """Two bf16 feature maps split over sp=2: ``exact`` (8 rows of 4
    columns of integers: at pool sizes 1 and 2 every weight is a power of
    two, so each shard's partial is exact in f32 and f64 alike) and
    ``seeded`` (12 x 10 of scaled normals)."""
    tmp = tmp_path_factory.mktemp("pool")
    rng = np.random.default_rng(7)
    inputs = {"exact": rng.integers(-100, 101, size=(2, 8, 4, 64)).astype(np.float32),
              "seeded": _bf16(rng.normal(size=(2, 12, 10, 64)) * 3.0)}
    ranks = spawn(tmp, "pool", 2, _save(tmp / "pool.npz", **inputs), tmp / "pool")
    return inputs, [np.load(r["arrays"]) for r in ranks]


def test_sp_bf16_pool_rounds_each_partial_as_jax(pool_runs):
    """The reference rounds each shard's partial to the compute dtype
    before its psum: hand-computed, round(round(a) + round(b)), exactly.
    The integer inputs make that differ from round(a + b) in some
    entries, so the test bites."""
    from can_tpu_torch.ops.pooling import adaptive_pool_matrix

    inputs, ranks = pool_runs
    x = inputs["exact"].astype(np.float64)
    hg, w = x.shape[1:3]
    hl = hg // 2
    differs = 0
    for i in (0, 1):  # sizes 1 and 2: power-of-two weights
        sh, sw = POOL_SIZES[i]
        ph = adaptive_pool_matrix(hg, sh, "cpu").double().numpy()
        pw = adaptive_pool_matrix(w, sw, "cpu").double().numpy()
        parts = [np.einsum("nhwc,ph,qw->npqc", x[:, s * hl:(s + 1) * hl],
                           ph[:, s * hl:(s + 1) * hl], pw) for s in (0, 1)]
        want = _bf16(_bf16(parts[0]) + _bf16(parts[1]))
        differs += int(np.sum(want != _bf16(parts[0] + parts[1])))
        for r in ranks:
            np.testing.assert_array_equal(r[f"exact/{i}"], want)
    assert differs > 0


def test_sp_bf16_pool_within_one_ulp_of_jax(pool_runs):
    """The sp=2 bf16 pool against JAX's ``adaptive_pool_sp`` under
    ``shard_map`` on two of the virtual CPU devices: within one bf16 ulp
    of JAX's value (the f32 contractions may sum in another order)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from can_tpu.parallel.spatial import make_spatial_ops as jax_spatial_ops
    from can_tpu.parallel.spatial import shard_map

    inputs, ranks = pool_runs
    for name, x in inputs.items():
        ops = jax_spatial_ops("spatial", 2, x.shape[1:3])
        f = shard_map(lambda xl: tuple(ops.adaptive_pool(xl, s) for s in POOL_SIZES),
                      mesh=_jax_mesh(1, 2), in_specs=P(None, "spatial", None, None),
                      out_specs=tuple(P() for _ in POOL_SIZES), check_vma=False)
        want = [np.asarray(o.astype(jnp.float32))
                for o in f(jnp.asarray(x, dtype=jnp.bfloat16))]
        for i, ref in enumerate(want):
            ulp = np.spacing(np.abs(ref).astype(np.float32)) * 2.0 ** 16  # bf16's
            for r in ranks:
                assert np.all(np.abs(r[f"{name}/{i}"] - ref) <= ulp), (name, i)


# -- worker entry ------------------------------------------------------------
def _worker_main(argv) -> None:
    mode, rdv, nproc, rank = argv[0], argv[1], int(argv[2]), int(argv[3])
    rt.init_runtime(platform="cpu", coordinator_address=rdv, num_processes=nproc,
                    process_id=rank)
    try:
        fn = {"sp": _sp_worker, "cli": _cli_worker, "pool": _pool_worker}[mode]
        result = fn(rank, nproc, *argv[4:])
    finally:
        rt.shutdown_runtime()
    print(json.dumps(result))


if __name__ == "__main__":
    torch.set_num_threads(1)
    if sys.argv[1] == "jax-x64":
        _jax_x64_main(sys.argv[2], sys.argv[3])
    else:
        _worker_main(sys.argv[1:])
