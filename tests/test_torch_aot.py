"""The cold start on the CPU: ``serve/aot.py``, ``utils/compile_cache.py``
and the bundle path of ``ops/_build.py``, against the JAX package's
``can_tpu/serve/aot.py`` and ``can_tpu/utils/compile_cache.py`` where
they share semantics.

* ``AotBundle.check`` raises on each axis; on the axes both packages
  have (manifest, version, platform, device_kind, serve_dtype, ds,
  signature, max_batch, bucket_shapes, batch_sizes) JAX's
  ``AotBundle.check`` names the same axis for the same manifest; the
  port's own (torch_version, cuda_version, kernel_sources) raise too.
  The reference's own AOT tests fail on this tree, so they are no oracle
  here: JAX's checker is called on manifests written here.
* a torn bake (no manifest) reads as absent; ``signature_sha`` is equal
  for host and device copies and for two same-architecture checkpoints.
* a fleet loaded from a CPU bake serves counts bitwise equal to the
  baking fleet's warm path, every launch an AOT hit, no first-seen
  signature; a scale-up reports its real ``aot_hits``.
* ``enable_compilation_cache``'s ``auto`` / path / ``off`` results
  against JAX's (its ``jax.config.update`` recorded, not applied); the
  refusal to move the directory once a library is loaded; ``off``'s
  directory removed at exit.
* the bundle loader: a bundled library loads with no ``nvcc``, a wrong
  key or an unloadable file raises and nothing is rebuilt.
* the serve CLI's ``--aot-bake`` then ``--aot-bundle`` (the fleet on CPU
  slots), and its refusals naming the axis.
"""

import ctypes.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from can_tpu.serve import aot as jaot
from can_tpu.utils import compile_cache as jcc
from can_tpu_torch.cli import serve as serve_cli
from can_tpu_torch.cli import test as eval_cli
from can_tpu_torch.cli import train as train_cli
from can_tpu_torch.models import random_state_dict
from can_tpu_torch.ops import _build
from can_tpu_torch.serve import CountService, FleetEngine, ServeEngine, prepare_image
from can_tpu_torch.serve import aot
from can_tpu_torch.serve.quant import host_tree, quantize_tree
from can_tpu_torch.utils import compile_cache as cc

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
LADDER = ((64,), (64, 96))


@pytest.fixture(scope="module")
def sd():
    return {k: torch.from_numpy(v) for k, v in random_state_dict(0, he=True).items()}


def _service(sd, **fleet_kw):
    fleet = FleetEngine(sd, replicas=2, devices=[CPU] * 3, **fleet_kw)
    svc = CountService(fleet, max_batch=2, max_wait_ms=1.0, bucket_ladder=LADDER)
    svc.warmup([(h, w) for h in LADDER[0] for w in LADDER[1]])
    return fleet, svc


def _images():
    rng = np.random.default_rng(3)
    return [prepare_image((rng.uniform(0, 1, (h, w, 3)) * 255).astype(np.uint8))
            for h, w in ((64, 64), (60, 90), (64, 96), (50, 64))]


@pytest.fixture(scope="module")
def baked(sd, tmp_path_factory):
    """A warmed 2-replica CPU fleet, its bundle, and its counts."""
    d = tmp_path_factory.mktemp("aot") / "bundle"
    fleet, svc = _service(sd)
    manifest = fleet.bake_aot(str(d))
    with svc:
        counts = [svc.predict(img, deadline_ms=60_000).count for img in _images()]
    return {"dir": d, "manifest": manifest, "counts": counts,
            "sigs": fleet.replicas[0].engine.compile_count, "sha": fleet._sig_sha}


# -- the bundle ---------------------------------------------------------------------
def test_bake_records_the_grid_on_each_device(baked):
    m = baked["manifest"]
    assert m == json.loads((baked["dir"] / aot.MANIFEST_NAME).read_text())
    # the universe lists the CPU three times: one device, its menu x grid
    assert {p["device_id"] for p in m["programs"]} == {0}
    assert len(m["programs"]) == baked["sigs"] == 2 * len(m["batch_sizes"])
    assert (m["platform"], m["device_kind"], m["libraries"]) == ("cpu", "cpu", [])
    assert m["kernel_sources"] == {"context_fused": _build.source_hash("context_fused")}
    assert (m["torch_version"], m["cuda_version"]) == (torch.__version__, torch.version.cuda)
    assert m["signature_sha"] == baked["sha"] and m["bucket_shapes"] == [[64, 64], [64, 96]]


def test_loaded_fleet_serves_bitwise_with_aot_hits_and_no_new_signature(sd, baked):
    fleet, svc = _service(sd, aot_bundle=str(baked["dir"]))
    assert fleet.compile_count == 0
    warm_hits = sum(r.engine.aot_hits for r in fleet.replicas)
    assert warm_hits == 2 * baked["sigs"]  # every warmup launch of both replicas
    with svc:
        counts = [svc.predict(img, deadline_ms=60_000).count for img in _images()]
        assert sum(r.engine.aot_hits for r in fleet.replicas) == warm_hits + len(counts)
        # a scale-up from the bundle: its warmup is all AOT hits, reported
        up = fleet.add_replica(reason="test")
    assert counts == baked["counts"]
    assert fleet.compile_count == 0
    assert up["aot_hits"] == baked["sigs"] and up["warmup_compiles"] == 0
    eng = fleet.replicas[-1].engine
    batch = _build_batch(64, 64, 2)
    assert eng.is_warm(batch) and eng.predict_batch(batch) is not None
    assert not eng.last_batch_compiled and eng.compile_count == 0


def _build_batch(h, w, n):
    from can_tpu_torch.data import pad_batch

    img = np.zeros((h, w, 3), np.float32)
    return pad_batch([(img, np.zeros((h // 8, w // 8, 1), np.float32))], (h, w), n,
                     [True], 8)


def test_bundle_that_misses_the_grid_is_refused_at_warmup(sd, baked):
    fleet = FleetEngine(sd, replicas=2, devices=[CPU] * 2, aot_bundle=str(baked["dir"]))
    with pytest.raises(aot.AotStaleError) as e:
        fleet.warmup([(64, 64), (96, 64)], 2)
    assert e.value.axis == "bucket_shapes"
    with pytest.raises(aot.AotStaleError) as e:
        fleet.warmup([(64, 64)], 4)
    assert e.value.axis == "max_batch"
    with pytest.raises(aot.AotStaleError) as e:
        FleetEngine(sd, replicas=2, devices=[CPU] * 2, serve_dtype="bf16",
                    aot_bundle=str(baked["dir"]))
    assert e.value.axis == "serve_dtype"


def test_torn_bake_reads_as_absent(baked, tmp_path):
    torn = tmp_path / "torn"
    shutil.copytree(baked["dir"], torn)
    os.remove(torn / aot.MANIFEST_NAME)
    for load in (aot.load_aot_bundle, jaot.load_aot_bundle):
        with pytest.raises((aot.AotStaleError, jaot.AotStaleError)) as e:
            load(str(torn))
        assert e.value.axis == "manifest"


def test_signature_sha_host_and_device_copies(sd):
    q = quantize_tree(sd, "f32")
    eng = ServeEngine(q, device="cpu", quantized=True)
    assert aot.signature_sha(host_tree(q)) == aot.signature_sha(eng.params)
    sd2 = {k: torch.from_numpy(v) for k, v in random_state_dict(1, he=True).items()}
    assert aot.signature_sha(sd) == aot.signature_sha(sd2)  # rollouts keep the bundle
    assert aot.signature_sha(quantize_tree(sd, "int8")) != aot.signature_sha(q)
    assert aot.signature_sha(sd, {"x": torch.zeros(2)}) != aot.signature_sha(sd)


def _both_manifest(baked):
    """The baked manifest with JAX's platform fields beside the port's:
    both checkers pass it on this CPU."""
    m = dict(baked["manifest"])
    dev = jax.devices()[0]
    assert (dev.platform, dev.device_kind) == ("cpu", "cpu")
    m["jax_version"] = jax.__version__
    return m


SHARED = [("platform", lambda m: m.update(platform="tpu")),
          ("device_kind", lambda m: m.update(device_kind="TPU v5 lite")),
          ("serve_dtype", lambda m: m.update(serve_dtype="bf16")),
          ("ds", lambda m: m.update(ds=4)),
          ("signature", lambda m: m.update(signature_sha="deadbeef")),
          ("max_batch", lambda m: m.update(max_batch=4)),
          ("bucket_shapes", lambda m: m.update(bucket_shapes=[[64, 64]])),
          ("batch_sizes", lambda m: m.update(batch_sizes=[2]))]


@pytest.mark.parametrize("axis,edit", SHARED, ids=[a for a, _ in SHARED])
def test_check_names_the_axis_as_jax_does(baked, axis, edit):
    m = _both_manifest(baked)
    kw = dict(sig_sha=baked["sha"], serve_dtype="f32", ds=8, max_batch=2,
              bucket_shapes=[(64, 64), (64, 96)], batch_sizes=m["batch_sizes"])
    aot.AotBundle("x", m).check(**kw)   # the unedited manifest passes both
    jaot.AotBundle("x", m).check(**kw)
    edit(m)
    with pytest.raises(aot.AotStaleError) as got:
        aot.AotBundle("x", m).check(**kw)
    with pytest.raises(jaot.AotStaleError) as want:
        jaot.AotBundle("x", m).check(**kw)
    assert got.value.axis == want.value.axis == axis


@pytest.mark.parametrize("axis,edit", [
    ("torch_version", lambda m: m.update(torch_version="0.0")),
    ("cuda_version", lambda m: m.update(cuda_version="12.8")),
    ("kernel_sources", lambda m: m["kernel_sources"].update(context_fused="0" * 16))])
def test_check_names_the_ports_own_axes(baked, axis, edit):
    m = json.loads(json.dumps(baked["manifest"]))
    edit(m)
    with pytest.raises(aot.AotStaleError) as e:
        aot.AotBundle("x", m).check(sig_sha=baked["sha"], serve_dtype="f32", ds=8)
    assert e.value.axis == axis


def test_version_refused_at_open_as_jax_does(baked, tmp_path):
    d = tmp_path / "v2"
    shutil.copytree(baked["dir"], d)
    m = json.loads((d / aot.MANIFEST_NAME).read_text())
    m["version"] = 2
    (d / aot.MANIFEST_NAME).write_text(json.dumps(m))
    with pytest.raises(aot.AotStaleError) as got:
        aot.AotBundle.open(str(d))
    with pytest.raises(jaot.AotStaleError) as want:
        jaot.AotBundle.open(str(d))
    assert got.value.axis == want.value.axis == "version"
    assert (aot.AOT_VERSION, aot.MANIFEST_NAME) == (jaot.AOT_VERSION, jaot.MANIFEST_NAME)


def test_programs_for_an_uncovered_device_is_empty(baked):
    b = aot.load_aot_bundle(str(baked["dir"]))
    assert b.device_ids() == {0}
    assert b.programs_for(torch.device("cuda", 3)) == {}
    assert len(b.programs_for(CPU)) == baked["sigs"]


# -- the compile cache ----------------------------------------------------------------
@pytest.fixture
def fresh_build(monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.DEFAULT_BUILD_ROOT)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_bundled", {})
    monkeypatch.setattr(_build, "build_info", {})
    monkeypatch.setattr(cc, "_off_dir", None)


@pytest.fixture
def jax_config(monkeypatch):
    """JAX's enable_compilation_cache with its config writes recorded."""
    seen = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: seen.__setitem__(k, v))
    return seen


@pytest.mark.parametrize("spec", [None, "cache", "off", "none", "0", "disabled", "OFF"])
def test_compile_cache_results_match_jax(fresh_build, jax_config, tmp_path,
                                         monkeypatch, spec):
    monkeypatch.chdir(tmp_path)
    got = cc.enable_compilation_cache(spec, device="cpu")
    want = jcc.enable_compilation_cache(spec)
    assert got == want
    if spec == "cache":
        assert got == str(tmp_path / "cache") and os.path.isdir(got)
        assert _build.BUILD_ROOT == tmp_path / "cache"
        assert jax_config["jax_compilation_cache_dir"] == got
    elif spec is None:  # auto on the CPU: nothing builds, as JAX skips its CPU
        assert _build.BUILD_ROOT == _build.DEFAULT_BUILD_ROOT
        # auto where kernels build: the default directory
        assert (cc.enable_compilation_cache(None, device="cuda")
                == str(_build.DEFAULT_BUILD_ROOT))
    else:               # off: a temporary directory of this process
        assert got is None and _build.BUILD_ROOT != _build.DEFAULT_BUILD_ROOT
        assert _build.BUILD_ROOT.is_dir()


def test_default_dir_follows_the_env_as_jax(fresh_build, monkeypatch, tmp_path):
    monkeypatch.setenv("CAN_TPU_COMPILE_CACHE", str(tmp_path / "env"))
    assert cc.default_cache_dir() == jcc.default_cache_dir() == str(tmp_path / "env")
    assert cc.enable_compilation_cache(None, device="cuda") == str(tmp_path / "env")
    monkeypatch.delenv("CAN_TPU_COMPILE_CACHE")
    assert cc.default_cache_dir() == str(_build.DEFAULT_BUILD_ROOT)


def test_cache_refuses_to_move_once_a_library_is_loaded(fresh_build, tmp_path):
    assert cc.enable_compilation_cache(str(tmp_path / "a")) == str(tmp_path / "a")
    _build._loaded["context_fused"] = object()
    assert cc.enable_compilation_cache(str(tmp_path / "a")) == str(tmp_path / "a")
    for spec in (str(tmp_path / "b"), "off"):
        with pytest.raises(RuntimeError, match="before the first kernel loads"):
            cc.enable_compilation_cache(spec)
    assert _build.BUILD_ROOT == tmp_path / "a"
    args = train_cli.parse_args(["--compile-cache", str(tmp_path / "b")])
    with pytest.raises(SystemExit, match="--compile-cache: "):
        train_cli.apply_compile_cache(args)


def test_off_directory_is_removed_at_exit():
    code = ("from can_tpu_torch.utils.compile_cache import enable_compilation_cache as e\n"
            "from can_tpu_torch.ops import _build\n"
            "assert e('off', device='cpu') is None\n"
            "print(_build.BUILD_ROOT)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    path = Path(r.stdout.strip())
    assert path.name.startswith("can_tpu_torch_build_") and not path.exists()


@pytest.mark.parametrize("mod", [train_cli, eval_cli, serve_cli])
def test_every_cli_takes_compile_cache_with_jax_default(mod):
    import importlib

    jmod = importlib.import_module(mod.__name__.replace("can_tpu_torch", "can_tpu"))
    assert mod.parse_args([]).compile_cache == jmod.parse_args([]).compile_cache == "auto"
    assert mod.parse_args(["--compile-cache", "off"]).compile_cache == "off"


# -- the bundle loader ----------------------------------------------------------------
def test_bundled_library_loads_without_nvcc(fresh_build, monkeypatch):
    def no_nvcc():
        raise AssertionError("nvcc must not run for a bundled library")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    libm = ctypes.util.find_library("m")
    assert libm
    key = _build.library_key("context_fused")
    _build.use_bundled_libraries([{"key": key, "path": libm, "ptxas": "log"}])
    (lib,) = _build.load_kernel_libraries(["context_fused"])
    assert isinstance(lib, ctypes.CDLL)
    info = _build.build_info["context_fused"]
    assert (info["source"], info["path"], info["ptxas"]) == ("bundle", libm, "log")
    assert _build.loaded_libraries() == ["context_fused"]


@pytest.mark.parametrize("case", ["wrong key", "unloadable"])
def test_bad_bundled_library_raises_and_never_rebuilds(fresh_build, monkeypatch,
                                                       tmp_path, case):
    monkeypatch.setattr(_build, "find_nvcc", lambda: pytest.fail("rebuilt"))
    key = _build.library_key("context_fused")
    path = tmp_path / "libcontext_fused.so"
    path.write_bytes(b"not a library")
    if case == "wrong key":
        key = dict(key, source_sha="0" * 16)
    _build.use_bundled_libraries([{"key": key, "path": str(path)}])
    with pytest.raises(RuntimeError, match="re-bake" if case == "wrong key"
                       else "failed to load"):
        _build.load_kernel_libraries(["context_fused"])
    assert _build.loaded_libraries() == [] and "context_fused" not in _build.build_info


# -- the serve CLI -----------------------------------------------------------------
@pytest.fixture
def pth(sd, tmp_path):
    path = tmp_path / "he.pth"
    torch.save(sd, path)
    return path


def _cli(pth, *extra):
    return serve_cli.parse_args(["--torch-pth", str(pth), "--platform", "cpu",
                                 "--replicas", "2", "--max-batch", "2",
                                 "--bucket-shapes", "64x64,64x96", *extra])


def test_cli_bakes_then_serves_from_the_bundle(pth, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(serve_cli, "fleet_devices", lambda platform: [CPU] * 2)
    d = tmp_path / "bundle"
    svc = serve_cli.build_service(_cli(pth, "--aot-bake", str(d)))
    assert "[serve] AOT bundle: " in capsys.readouterr().out
    assert svc.startup["bake"] >= 0 and svc.engine._aot is not None
    with svc:
        want = [svc.predict(img, deadline_ms=60_000).count for img in _images()]
    svc2 = serve_cli.build_service(_cli(pth, "--aot-bundle", str(d)))
    out = capsys.readouterr().out
    assert "[AOT: " in out and svc2.engine.compile_count == 0
    with svc2:
        assert [svc2.predict(img, deadline_ms=60_000).count for img in _images()] == want
    # stale bundles: refused naming the axis, before any launch
    m = json.loads((d / aot.MANIFEST_NAME).read_text())
    m["serve_dtype"] = "bf16"
    stale = tmp_path / "stale"
    shutil.copytree(d, stale)
    (stale / aot.MANIFEST_NAME).write_text(json.dumps(m))
    for extra, axis in ((["--aot-bundle", str(stale)], "serve_dtype"),
                        (["--aot-bundle", str(d), "--max-batch", "4"], "max_batch"),
                        (["--aot-bundle", str(tmp_path / "none")], "manifest")):
        with pytest.raises(SystemExit, match=f"^--aot-bundle refused: AOT bundle stale "
                                             f"on {axis}"):
            serve_cli.build_service(_cli(pth, *extra))
