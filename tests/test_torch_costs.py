"""The port's cost ledger (``can_tpu_torch/obs/costs.py``) and device peak
table (``can_tpu_torch/cli/common.py``) against the JAX package's on the
CPU.

* The ledger: the same seeded rows (flops, bytes, seconds, launches,
  fenced) and the same peaks fed to both packages' ledgers give the same
  ``rows()``, ``summary()``, ``launch_cost_fit()`` and ``perf.summary``
  payload — compared as JSON text, so every float is equal to the last
  bit (the arithmetic is the reference's line for line); the reference's
  own ledger cases (tests/test_perf.py) run on both packages.
* The peaks: the CPU's labelled-nominal row equals JAX's; the H100 rows
  are the data sheet's, f32 the rate outside the tensor cores.
* The counting scope: a CANNet forward and train step at 64x96 count
  flops within 2% of JAX's ``cost_analysis()`` of the same program, the
  plain and the BN model (convolutions and matmuls are nearly all of
  them; the convolution rule is XLA's, taps in the padding left out);
  the call's result is bitwise the unscoped one; a matmul reads and
  writes (mk + kn + mn) x itemsize bytes; each kernel seam counts its
  analytic formula, not its plain version's aten ops.
"""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from can_tpu import obs as jobs
from can_tpu.cli import common as jcommon
from can_tpu.obs import costs as jcosts
from can_tpu.train import batch_signature as jsig
from can_tpu_torch import obs as tobs
from can_tpu_torch.cli import common as tcommon
from can_tpu_torch.obs import costs as tcosts
from can_tpu_torch.train.steps import batch_signature as tsig

FLOPS_RTOL = 0.02  # the port's count against XLA's cost analysis

PKGS = {
    "jax": SimpleNamespace(costs=jcosts, peaks=jcommon.DevicePeaks, sig=jsig,
                           obs=jobs),
    "port": SimpleNamespace(costs=tcosts, peaks=tcommon.DevicePeaks, sig=tsig,
                            obs=tobs),
}


class ListSink:
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)

    def close(self):
        pass


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def make_ledger(pkg, **kw):
    peaks = pkg.peaks(flops_bf16=2e12, flops_f32=1e12, hbm_bytes_s=1e11,
                      source="spec:test")
    return pkg.costs.ProgramCostLedger(peaks=peaks, **kw)


def sig_of(pkg, shape, dtype=np.float32):
    return pkg.sig({"image": np.zeros(shape, dtype)})


# -- the device peak table ---------------------------------------------------
def test_cpu_peaks_equal_the_references():
    want = jcommon.local_device_peaks()  # tier-1 runs on JAX's CPU backend
    got = tcommon.local_device_peaks("cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.nominal and got.source == "nominal:cpu"


def test_cpu_peaks_never_touch_cuda(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU lookup reached torch.cuda")

    monkeypatch.setattr(torch.cuda, "get_device_name", boom)
    monkeypatch.setattr(torch.cuda, "init", boom)
    assert tcommon.local_device_peaks(torch.device("cpu")).nominal
    assert tobs.ProgramCostLedger(device="cpu").peaks.source == "nominal:cpu"


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (67e12, 989e12, 3.35e12)),
    ("NVIDIA H100 SXM5 80GB", (67e12, 989e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (51e12, 756e12, 2.0e12)),
    ("NVIDIA A100-SXM4-80GB", None),
    ("warp drive", None)])
def test_h100_rows(name, want):
    p = tcommon.device_peaks_for_kind(name)
    if want is None:
        assert p is None
        return
    assert (p.flops_f32, p.flops_bf16, p.hbm_bytes_s) == want
    assert not p.nominal and p.source.startswith("spec:h100")
    assert p.flops("bf16") == want[1] and p.flops("f32") == want[0]
    assert p.ridge("f32") == pytest.approx(want[0] / want[2])


# -- the ledger: seeded rows through both packages ----------------------------
def _drive(pkg, seed: int):
    """One seeded script of registrations and observations; returns the
    ledger and the perf.summary events it emitted."""
    rng = np.random.default_rng(seed)
    led = make_ledger(pkg, compute=("f32", "bf16")[seed % 2],
                      plan_launch_cost_px=float(rng.uniform(1e3, 1e5)))
    sink = ListSink()
    tel = pkg.obs.Telemetry([sink], clock=lambda: 0.0)
    names = ("train_step", "eval_step", "serve_predict_r0")
    for _ in range(int(rng.integers(4, 12))):
        name = names[int(rng.integers(len(names)))]
        shape = (int(rng.integers(1, 9)), 8 * int(rng.integers(4, 40)),
                 8 * int(rng.integers(4, 40)), 3)
        dtype = (np.float32, np.uint8)[int(rng.integers(2))]
        f = float(rng.uniform(1e8, 1e12)) if rng.random() > 0.2 else None
        b = float(rng.uniform(1e6, 1e10)) if rng.random() > 0.2 else None
        cost = None if rng.random() < 0.1 else (f, b)
        led.register(name, sig_of(pkg, shape, dtype), cost=cost)
        px = shape[0] * shape[1] * shape[2]
        for _ in range(int(rng.integers(0, 4))):
            n = int(rng.integers(1, 7))
            per = px / float(rng.uniform(1e7, 5e7)) + float(rng.uniform(0, 2e-3))
            led.observe(name, shape, per * n, n, dtype=(
                np.dtype(dtype).name if rng.random() < 0.5 else None),
                fenced=bool(rng.random() < 0.5))
        led.emit_summary(tel, step=int(rng.integers(0, 5)), phase="p")
    return led, [e for e in sink.events if e["kind"] == "perf.summary"]


@pytest.mark.parametrize("seed", range(8))
def test_ledger_equals_the_references_on_seeded_rows(seed):
    (jled, jev), (tled, tev) = (_drive(PKGS[p], seed) for p in ("jax", "port"))

    def same(a, b):
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)

    same(tled.rows(), jled.rows())
    same(tled.summary(), jled.summary())
    for name in (None, "train_step", "eval_step", "serve_predict_r0"):
        same(tled.launch_cost_fit(name), jled.launch_cost_fit(name))
    assert len(tev) == len(jev) > 0
    for t, j in zip(tev, jev):
        same(t, j)


# -- the reference's ledger cases, on both packages ---------------------------
def test_mfu_roofline_and_rows(pkg):
    led = make_ledger(pkg, compute="f32")  # peak 1e12 FLOP/s, ridge 10
    led.register("train_step", sig_of(pkg, (2, 100, 100, 3)), cost=(2e9, 1e8))
    led.observe("train_step", (2, 100, 100, 3), seconds=0.02, n=5)
    (row,) = led.rows()
    assert row["roofline"] == "compute" and row["intensity"] == pytest.approx(20.0)
    assert row["mfu"] == pytest.approx(0.5)  # 2e9 / (0.004 * 1e12)
    assert row["launches"] == 5 and row["pixels"] == 2 * 100 * 100
    s = led.summary()
    assert s["mfu_weighted"] == pytest.approx(0.5)
    assert s["roofline_compute_bound"] == 1 and s["peak_nominal"] == 0


def test_memory_bound_and_unknown_classes(pkg):
    led = make_ledger(pkg, compute="f32")
    led.register("s", sig_of(pkg, (1, 64, 64, 3)), cost=(1e6, 1e6))
    led.register("s", sig_of(pkg, (1, 32, 32, 3)), cost=None)
    s = led.summary()
    assert s["roofline_memory_bound"] == 1 and s["roofline_unknown"] == 1
    assert "mfu_weighted" not in s


def test_launch_cost_fit_recovers_planted_overhead(pkg):
    led = make_ledger(pkg, plan_launch_cost_px=0.05e6)
    a, b = 1.0 / 50e6, 1e-3  # 50 Mpx/s + 1 ms => 0.05 Mpx
    for batch, n in ((1, 10), (4, 10)):
        shape = (batch, 1000, 1000, 3)
        led.register("train_step", sig_of(pkg, shape), cost=(1.0, 1.0))
        led.observe("train_step", shape,
                    seconds=(a * batch * 1e6 + b) * n, n=n)
    fit = led.launch_cost_fit()
    assert fit["rate_mpx_s"] == pytest.approx(50.0, rel=1e-3)
    assert fit["launch_cost_mpx_empirical"] == pytest.approx(0.05, rel=1e-3)
    assert fit["launch_cost_drift"] == pytest.approx(1.0, rel=1e-3)


def test_summary_fit_is_per_family_not_pooled(pkg):
    led = make_ledger(pkg, plan_launch_cost_px=0.05e6)
    for name, rate in (("train_step", 50e6), ("eval_step", 150e6)):
        for batch in (1, 2, 4):
            shape = (batch, 1000, 1000, 3)
            led.register(name, sig_of(pkg, shape), cost=(1.0, 1.0))
            led.observe(name, shape, (batch * 1e6 / rate + 1e-3) * 5, n=5)
    s = led.summary()
    assert s["launch_cost_fit_name"] == "train_step"
    assert s["launch_cost_drift"] == pytest.approx(1.0, rel=1e-3)
    assert s["rate_mpx_s"] == pytest.approx(50.0, rel=1e-3)


def test_partial_cost_analysis_omits_missing_keys(pkg):
    led = make_ledger(pkg)
    sig = sig_of(pkg, (1, 8, 8, 3))
    assert led.register("s", sig, cost=(None, 1234.0)) == {"bytes_accessed": 1234.0}
    assert led.register("s2", sig, cost=(None, None)) is None


def test_fit_needs_two_distinct_sizes(pkg):
    led = make_ledger(pkg)
    led.register("s", sig_of(pkg, (1, 10, 10, 3)), cost=(1.0, 1.0))
    led.observe("s", (1, 10, 10, 3), 0.5, n=2)
    assert led.launch_cost_fit() is None


def test_observe_disambiguates_dtype(pkg):
    led = make_ledger(pkg)
    led.register("p", sig_of(pkg, (1, 8, 8, 3)), cost=(1.0, 1.0))
    led.register("p", sig_of(pkg, (1, 8, 8, 3), np.uint8), cost=(2.0, 2.0))
    led.observe("p", (1, 8, 8, 3), 0.1, dtype="uint8")
    rows = {r["dtype"]: r for r in led.rows()}
    assert rows["uint8"]["launches"] == 1 and rows["float32"]["launches"] == 0


def test_unfenced_timings_need_min_launches(pkg):
    led = make_ledger(pkg, compute="f32")
    led.register("train_step", sig_of(pkg, (1, 100, 100, 3)), cost=(1e9, 1e7))
    led.observe("train_step", (1, 100, 100, 3), 1e-6, n=1, fenced=False)
    (row,) = led.rows()
    assert not row["timing_reliable"] and row["mfu"] is None
    assert row["mean_s"] is not None
    led.observe("train_step", (1, 100, 100, 3), 0.01,
                n=pkg.costs.MIN_UNFENCED_LAUNCHES - 1, fenced=False)
    (row,) = led.rows()
    assert row["timing_reliable"] and row["mfu"] is not None
    assert pkg.costs.MIN_UNFENCED_LAUNCHES == 4


def test_extract_image_signature_fallback(pkg):
    sig = pkg.sig({"x": np.zeros((4, 4), np.float32),
                   "big": np.zeros((8, 8, 8), np.float32)})
    assert pkg.costs.extract_image_signature(sig) == ((8, 8, 8), "float32")


# -- the counting scope --------------------------------------------------------
def test_matmul_bytes_and_flops():
    m, k, n = 48, 80, 24
    a, b = torch.randn(m, k), torch.randn(k, n)
    with tcosts.count_costs() as sc:
        c = a @ b
        c.t()  # a view: moves nothing
    assert sc.flops == 2 * m * k * n
    assert sc.bytes_accessed == (m * k + k * n + m * n) * 4
    assert tcosts.current_scope() is None


def test_bn_seams_count_their_formulas(monkeypatch):
    """moment_sums' forward on a CPU tensor (its plain version) and
    MomentSums.backward (its plain twin here, the kernel on the card)
    count the kernels' analytic flops and bytes, not the aten ops they
    run inside."""
    from can_tpu_torch.ops import cuda_bn

    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal((2, 5, 7, 16)).astype(np.float32))
    m = torch.from_numpy((rng.random((2, 5, 7, 1)) > 0.3).astype(np.float32))
    with tcosts.count_costs() as sc:
        got = cuda_bn.moment_sums(y, m)
    want = cuda_bn.masked_moment_sums(y, m)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (sc.flops, sc.bytes_accessed) == cuda_bn.moment_sums_cost(y, m)
    assert sc.flops == 4 * y.numel()
    # the autograd seam: the forward kernel stood in for by the plain sums
    monkeypatch.setattr(cuda_bn, "moment_sums_cuda", cuda_bn.masked_moment_sums)
    yg = y.clone().requires_grad_()
    with tcosts.count_costs() as sc:
        with tcosts.seam_cost(*cuda_bn.moment_sums_cost(y, m)):
            s1, s2, _ = cuda_bn.MomentSums.apply(yg, m)
        (s1.sum() + s2.sum()).backward()
    assert sc.flops == 4 * y.numel() + 3 * y.numel()
    np.testing.assert_array_equal(
        yg.grad.numpy(), (m * (1 + 2 * y)).numpy())


def test_context_seam_counts_its_formula():
    from can_tpu_torch.ops import cuda_context as cc

    rng = np.random.default_rng(1)
    b, h, w, c = 1, 6, 9, 64
    fv = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32))
    aves = [torch.from_numpy(rng.standard_normal((b, s, s, c)).astype(np.float32))
            for s in cc.SCALES]
    wts = [torch.from_numpy(0.1 * rng.standard_normal((c, c)).astype(np.float32))
           for _ in cc.SCALES]
    avew, uh, wmat = cc.pack_inputs(fv, aves, wts, (h, w))
    with tcosts.count_costs() as sc:
        out = cc.context_tail(fv, avew, uh, wmat)
    assert torch.equal(out, cc.context_tail_reference(fv, avew, uh, wmat))
    assert (sc.flops, sc.bytes_accessed) == cc.tail_cost(fv, avew, uh, wmat)


# -- CANNet against XLA's cost analysis -----------------------------------------
B, H, W = 2, 64, 96


def _xla(fn, *args):
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(ca["flops"])


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, H // 8, W // 8, 1), np.float32)
    mask[1, -2:] = 0  # bucket padding in the second image
    return {"image": rng.standard_normal((B, H, W, 3)).astype(np.float32),
            "dmap": rng.random((B, H // 8, W // 8, 1)).astype(np.float32),
            "pixel_mask": mask, "sample_mask": np.ones((B,), np.float32)}


def _params(batch_norm):
    if batch_norm:
        from test_torch_bn import jax_bn_params

        return jax_bn_params(0)
    from test_torch_model import jax_params

    return jax_params("he")


def _port_model(params, batch_norm):
    from can_tpu_torch.models import CANNet
    from can_tpu_torch.utils.torch_import import state_dict_from_jax_params

    model = CANNet(seed=None, batch_norm=batch_norm)
    model.load_state_dict(state_dict_from_jax_params(params))
    return model


def test_cannet_forward_flops_match_xla():
    from can_tpu.models import cannet_apply

    params = _params(False)
    x = _batch()["image"]
    want = _xla(cannet_apply, params, jnp.asarray(x))
    model = _port_model(params, False).eval()
    t = torch.from_numpy(x)
    with torch.no_grad():
        ref = model(t)
        with tcosts.count_costs() as sc:
            out = model(t)
    assert torch.equal(out, ref)  # the scope changes no bit
    assert sc.flops == pytest.approx(want, rel=FLOPS_RTOL), (sc.flops, want)


@pytest.mark.parametrize("batch_norm", [False, True], ids=["plain", "bn"])
def test_cannet_train_step_flops_match_xla_and_bits(batch_norm):
    """The port's step (BN moments through the kernel seam) against JAX's
    default step on the same batch: flops within 2%; the step inside the
    scope bitwise equal to the step outside it (weights, momentum,
    running stats, metrics)."""
    from can_tpu.models import cannet_apply, init_batch_stats
    from can_tpu.train import (create_train_state, make_lr_schedule,
                               make_optimizer, make_train_step)
    from can_tpu_torch.ops.bn_moments import make_bn_ops
    from can_tpu_torch.train import create_train_state as tstate
    from can_tpu_torch.train import make_lr_schedule as tlr
    from can_tpu_torch.train import make_train_step as tstep

    params, batch = _params(batch_norm), _batch(1)
    opt = make_optimizer(make_lr_schedule(1e-6))
    jstate = create_train_state(jax.tree.map(jnp.asarray, params), opt,
                                init_batch_stats(params) if batch_norm else None)
    want = _xla(make_train_step(cannet_apply, opt), jstate,
                {k: jnp.asarray(v) for k, v in batch.items()})

    def fresh():
        return tstate(_port_model(params, batch_norm), tlr(1e-6))

    step = tstep(bn_ops=make_bn_ops("kernel") if batch_norm else None,
                 health_metrics=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    plain_state, plain_m = step(fresh(), tb)
    with tcosts.count_costs() as sc:
        scoped_state, scoped_m = step(fresh(), tb)
    assert sc.flops == pytest.approx(want, rel=FLOPS_RTOL), (sc.flops, want)
    for k in plain_m:
        assert torch.equal(plain_m[k], scoped_m[k]), k
    a, b = plain_state.model.state_dict(), scoped_state.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for p, q in zip(plain_state.model.parameters(), scoped_state.model.parameters()):
        assert torch.equal(plain_state.optimizer.state[p]["momentum_buffer"],
                           scoped_state.optimizer.state[q]["momentum_buffer"])


@pytest.mark.parametrize("armed", [False, True], ids=["no_ledger", "ledger"])
def test_recompile_tracker_payload(armed):
    """With a ledger on the bus the compile event carries the first
    call's counted flops/bytes (and the ledger's row holds them); without
    one the payload keys are the reference's four."""
    sink = ListSink()
    tel = tobs.Telemetry([sink])
    if armed:
        tel.ledger = make_ledger(PKGS["port"])
    w = torch.randn(16, 8)
    step = tobs.RecompileTracker(
        lambda s, b: (s, {"loss": (b["image"] @ w).sum()}), tel,
        name="train_step")
    batch = {"image": torch.ones(4, 16)}
    step(None, batch)
    step(None, batch)  # no new signature: no new compile event
    (e,) = [e for e in sink.events if e["kind"] == "compile"]
    keys = {"name", "signature", "seconds", "n_signatures"}
    if not armed:
        assert set(e["payload"]) == keys
        return
    assert set(e["payload"]) == keys | {"flops", "bytes_accessed"}
    assert e["payload"]["flops"] == 2 * 4 * 16 * 8
    (row,) = tel.ledger.rows()
    assert row["flops"] == e["payload"]["flops"]
    assert row["bytes_accessed"] == e["payload"]["bytes_accessed"]
