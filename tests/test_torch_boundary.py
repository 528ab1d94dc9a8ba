"""The port's boundaries: it never reaches JAX or ``can_tpu``, and it runs
on the CPU only when asked.

* every module of ``can_tpu_torch`` imports in a fresh interpreter where
  ``jax`` and ``can_tpu`` are blocked (the blocker matches whole package
  names, so ``can_tpu_torch`` itself is not caught by the shared prefix);
* a source scan of ``can_tpu_torch/`` and ``chip_smoke.py`` finds no
  import of jax, flax, optax, orbax or ``can_tpu``;
* without a CUDA device, the serve CLI without ``--platform cpu`` exits
  non-zero naming the missing card, and no ``--platform default`` entry
  point runs on the CPU when ``LOCAL_RANK`` names a card that is not there;
* the VGG-16 converter's manifest is a copy of the JAX tool's.
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import can_tpu_torch
from can_tpu_torch.device import NoCudaDeviceError, resolve_device

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "can_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "can_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        can_tpu_torch.__path__, prefix="can_tpu_torch."))


def test_port_modules_are_found():
    mods = _port_modules()
    for m in ("can_tpu_torch.ops.cuda_context", "can_tpu_torch.serve.service",
              "can_tpu_torch.cli.serve", "can_tpu_torch.models.cannet",
              # the evaluation slice: the import test and the source scan
              # below walk these too
              "can_tpu_torch.cli.test", "can_tpu_torch.cli.common",
              "can_tpu_torch.data.planner", "can_tpu_torch.data.prepared",
              "can_tpu_torch.data.prefetch", "can_tpu_torch.utils.viz",
              "can_tpu_torch.utils.logging",
              # the DDP slice and the VGG-16 converter
              "can_tpu_torch.parallel", "can_tpu_torch.parallel.runtime",
              "can_tpu_torch.parallel.mesh", "can_tpu_torch.parallel.data_parallel",
              "can_tpu_torch.tools.convert_vgg16",
              # spatial parallelism
              "can_tpu_torch.parallel.spatial",
              # the obs core
              "can_tpu_torch.obs.bus", "can_tpu_torch.obs.collector",
              "can_tpu_torch.obs.incidents", "can_tpu_torch.obs.exporter",
              "can_tpu_torch.cli.collect",
              # the device side of obs
              "can_tpu_torch.obs.costs", "can_tpu_torch.obs.trace",
              "can_tpu_torch.utils.profiling",
              # elastic training (under --sp too) and the cold start
              "can_tpu_torch.parallel.elastic", "can_tpu_torch.serve.aot",
              "can_tpu_torch.utils.compile_cache", "can_tpu_torch.ops._build"):
        assert m in mods
    assert (PKG / "csrc" / "context_fused.cu").is_file()


def test_every_module_imports_with_jax_and_can_tpu_blocked():
    script = f"""
import importlib, importlib.abc, sys
FORBIDDEN = {FORBIDDEN!r}
def bad(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)
for name in [n for n in sys.modules if bad(n)]:
    del sys.modules[name]
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if bad(name):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
for mod in {_port_modules()!r}:
    importlib.import_module(mod)
leaked = sorted(n for n in sys.modules if bad(n))
assert not leaked, leaked
try:
    import can_tpu
except ImportError:
    pass
else:
    raise AssertionError("the blocker let can_tpu through")
print("ok", len({_port_modules()!r}))
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_source_scan_finds_no_jax_or_can_tpu_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    offenders = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            offenders += [(str(f.relative_to(ROOT)), n) for n in names
                          if _forbidden(n)]
    assert not offenders, offenders


def test_resolve_device_cpu_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("tpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-card refusal needs none")
    for platform in ("default", "gpu"):
        with pytest.raises(NoCudaDeviceError, match="CUDA"):
            resolve_device(platform)


def test_no_tpu_constant_in_the_port():
    """The planner's memory cap and launch price are the card's: none of
    the JAX package's TPU constants (1100/2200 B/px, 42 Mpx/s, its
    device-kind tables and their TPU peak rates) is in the port.  The
    cost ledger's ``DevicePeaks`` exists in the port with the H100's rows
    (``cli/common.py``), so the TPU rows' own numbers are what is looked
    for."""
    files = sorted(PKG.rglob("*.py"))
    for f in files:
        src = f.read_text()
        for pat in ("1100.0", "2200.0", "42.0", "_HBM_BY_DEVICE_KIND",
                    "_PEAK_BY_DEVICE_KIND", "197e12", "459e12", "918e12",
                    "275e12", "819e9", "2765e9", "1640e9"):
            assert pat not in src, (str(f.relative_to(ROOT)), pat)


def test_serve_cli_without_a_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-card refusal needs none")
    from can_tpu_torch.models import random_state_dict

    pth = tmp_path / "w.pth"
    torch.save({k: torch.from_numpy(v) for k, v in random_state_dict(0).items()},
               pth)
    proc = subprocess.run(
        [sys.executable, "-m", "can_tpu_torch.cli.serve", "--torch-pth",
         str(pth), "--port", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "--platform cpu" in proc.stderr
    assert "listening" not in proc.stdout


def test_vgg16_manifest_is_the_jax_tools():
    """The converter carries its own copy (the port reads nothing from
    ``tools/``); the copy must not drift from the JAX tool's."""
    import json

    port = json.loads((PKG / "tools" / "vgg16_manifest.json").read_text())
    ref = json.loads((ROOT / "tools" / "vgg16_manifest.json").read_text())
    assert port == ref
    assert len(port["entries"]) >= 20


def test_local_rank_past_the_cards_never_runs_on_the_cpu(tmp_path, monkeypatch):
    """A process whose ``LOCAL_RANK`` names a card that is not there (more
    processes than GPUs) must fail, never fall back to the CPU: with one
    visible card, ``LOCAL_RANK=1`` makes every ``--platform default``
    entry point exit naming the missing card."""
    from can_tpu_torch.cli import serve as serve_cli
    from can_tpu_torch.cli import test as eval_cli
    from can_tpu_torch.cli import train as train_cli
    from can_tpu_torch.data import make_synthetic_dataset
    from can_tpu_torch.models import random_state_dict
    from can_tpu_torch.parallel import init_runtime, runtime_active

    make_synthetic_dataset(str(tmp_path / "train_data"), 2, sizes=((64, 64),), seed=0)
    make_synthetic_dataset(str(tmp_path / "test_data"), 2, sizes=((64, 64),), seed=1)
    pth = tmp_path / "w.pth"
    torch.save({k: torch.from_numpy(v) for k, v in random_state_dict(0).items()}, pth)
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "COORDINATOR_ADDRESS",
                "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(NoCudaDeviceError, match="LOCAL_RANK 1"):
        resolve_device("default")
    assert resolve_device("default", local_rank=0) == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(NoCudaDeviceError, match="LOCAL_RANK 1"):
        init_runtime(platform="default")
    assert not runtime_active()
    data = ["--data_root", str(tmp_path)]
    for run, argv in (
            (lambda a: train_cli.train(train_cli.parse_args(a)),
             data + ["--checkpoint-dir", str(tmp_path / "ck")]),
            (lambda a: eval_cli.evaluate_checkpoint(eval_cli.parse_args(a)),
             data + ["--torch-pth", str(pth)]),
            (lambda a: serve_cli.build_service(serve_cli.parse_args(a)),
             ["--torch-pth", str(pth), "--port", "0"])):
        with pytest.raises(SystemExit, match="LOCAL_RANK 1"):
            run(argv)
        assert not runtime_active()
