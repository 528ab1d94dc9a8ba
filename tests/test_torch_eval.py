"""The port's evaluation entry point against the JAX package's, and what
rides with it: export to the reference and JAX layouts, the eval CLI's
checkpoint selection and refusals, ``--show-index`` PNGs, serving from a
checkpoint directory, the logger.

Tolerances: MAE/MSE of the two eval CLIs rtol 1e-3 (the model tolerance,
ROADMAP rule 2; the JAX CLI prints 3 decimals of values of order 10 and
up, with He-scaled weights); exported arrays equal exactly; the eval CLI
against the train CLI's own last eval of the same checkpoint, and the
served count against the eval CLI's density map, rtol 1e-6 / 1e-5 (same
weights, batches and step on one device).
"""

import contextlib
import io
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from can_tpu.cli.test import main as jax_test_main
from can_tpu.utils.torch_import import convert_state_dict
from can_tpu.utils.torch_import import load_params_npz as jax_load_npz
from can_tpu.utils.torch_import import load_torch_checkpoint as jax_load_pth
from can_tpu.utils.torch_import import save_params_npz as jax_save_npz
from can_tpu_torch.cli import serve as serve_cli
from can_tpu_torch.cli import test as cli
from can_tpu_torch.cli import train as train_cli
from can_tpu_torch.data import make_synthetic_dataset
from can_tpu_torch.data.imageio import read_png
from can_tpu_torch.models import random_state_dict
from can_tpu_torch.utils.logging import MetricLogger
from can_tpu_torch.utils.torch_import import (
    export_state_dict,
    save_params_npz,
    save_torch_checkpoint,
)
from can_tpu_torch.utils.viz import jet

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_data")
    make_synthetic_dataset(str(root / "train_data"), 4, sizes=((64, 64), (64, 96)),
                           seed=0)
    make_synthetic_dataset(str(root / "test_data"), 5,
                           sizes=((64, 64), (64, 96), (61, 90)), seed=1)
    return root


@pytest.fixture(scope="module")
def he_npz(tmp_path_factory):
    """He-scaled weights written by the JAX package's save_params_npz."""
    path = tmp_path_factory.mktemp("weights") / "he.npz"
    jax_save_npz(convert_state_dict(random_state_dict(3, he=True)), str(path))
    return str(path)


def _jax_eval(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_test_main(argv) == 0
    m = re.search(r"images=(\d+) MAE=([\d.]+) MSE=([\d.]+)", buf.getvalue())
    assert m, buf.getvalue()
    return int(m.group(1)), float(m.group(2)), float(m.group(3))


@pytest.mark.parametrize("flags", [[], ["--batch-size", "2"],
                                   ["--pad-multiple", "auto", "--batch-size", "3"]])
def test_eval_cli_matches_jax_on_the_same_npz(data, he_npz, flags):
    argv = ["--data_root", str(data), "--params-npz", he_npz,
            "--platform", "cpu", "--prepared-root", "off"] + flags
    n, jmae, jmse = _jax_eval(argv)
    got = cli.evaluate_checkpoint(cli.parse_args(argv))
    assert got["num_images"] == n == 5
    assert jmae > 1.0  # He weights: the comparison bites
    np.testing.assert_allclose([got["mae"], got["mse"]], [jmae, jmse], rtol=1e-3)


@pytest.mark.parametrize("ddp_prefix", [False, True])
def test_export_round_trips_into_jax(tmp_path, ddp_prefix):
    ref = random_state_dict(5, he=True)
    sd = {k: torch.from_numpy(v) for k, v in ref.items()}
    want = convert_state_dict(ref)
    save_params_npz(sd, str(tmp_path / "p.npz"))
    save_torch_checkpoint(sd, str(tmp_path / "p.pth"), ddp_prefix=ddp_prefix)
    for got in (jax_load_npz(str(tmp_path / "p.npz")),
                jax_load_pth(str(tmp_path / "p.pth"))):
        jax.tree.map(np.testing.assert_array_equal, got, want)
    out = export_state_dict(sd, ddp_prefix=ddp_prefix)
    assert list(out) == [("module." if ddp_prefix else "") + k for k in ref]
    with pytest.raises(ValueError, match="BatchNorm"):
        export_state_dict({k: torch.from_numpy(v) for k, v in
                           random_state_dict(0, batch_norm=True).items()})


def test_show_index_writes_three_readable_pngs(data, he_npz, tmp_path):
    args = cli.parse_args(["--data_root", str(data), "--params-npz", he_npz,
                           "--platform", "cpu", "--show-index", "4",
                           "--out-dir", str(tmp_path / "viz")])
    out = cli.evaluate_checkpoint(args)
    paths = out["viz_paths"]
    assert [Path(p).name for p in paths] == ["test_4_img.png", "test_4_gt.png",
                                             "test_4_et.png"]
    h, w = out["density"].shape[:2]
    img, gt, et = (read_png(p) for p in paths)
    assert img.shape == (8 * h, 8 * w, 3) and gt.shape == et.shape == (h, w, 3)
    assert img.dtype == gt.dtype == et.dtype == np.uint8
    assert et.std() > 0  # a map, not a flat colour


@pytest.mark.parametrize("argv,match", [
    (["--sp", "2"], "Queue 1 item 4"),
    (["--torch-pth", "a.pth", "--params-npz", "b.npz"], "OR"),
    (["--params-npz", "x.npz", "--syncBN"], "drop --syncBN"),
    (["--params-npz", "x.npz", "--epoch", "3"], "--epoch"),
    (["--params-npz", "x.npz", "--checkpoint-dir", "ck"], "checkpoint-dir"),
    (["--params-npz", "missing.npz"], "no such checkpoint file"),
    (["--checkpoint-dir", "nowhere"], "no checkpoint under"),
])
def test_eval_cli_refusals(data, tmp_path, argv, match):
    for name in ("a.pth", "b.npz", "x.npz"):
        (tmp_path / name).write_bytes(b"")
    argv = [str(tmp_path / a) if a in ("a.pth", "b.npz", "x.npz", "missing.npz",
                                       "nowhere", "ck") else a for a in argv]
    with pytest.raises(SystemExit, match=match):
        cli.evaluate_checkpoint(cli.parse_args(
            ["--data_root", str(data), "--platform", "cpu"] + argv))


def test_eval_cli_without_a_card_exits_with_the_no_card_error(data, he_npz):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-card refusal needs none")
    proc = subprocess.run(
        [sys.executable, "-m", "can_tpu_torch.cli.test", "--data_root",
         str(data), "--params-npz", he_npz], cwd=ROOT, capture_output=True,
        text=True, timeout=240)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "--platform cpu" in proc.stderr
    assert "[result]" not in proc.stdout


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    """The train CLI's BN model, two epochs at the default --pad-multiple
    auto, a checkpoint per epoch."""
    ck = tmp_path_factory.mktemp("ck")
    summary = train_cli.train(train_cli.parse_args(
        ["--data_root", str(data), "--platform", "cpu", "--syncBN",
         "--bn-impl", "kernel", "--batch-size", "2", "--epochs", "2",
         "--lr", "1e-6", "--checkpoint-dir", str(ck), "--num-workers", "2"]))
    return ck, summary


def test_eval_cli_reproduces_the_train_clis_last_eval(data, trained):
    ck, summary = trained
    last = summary["epochs"][-1]
    args = cli.parse_args(["--data_root", str(data), "--platform", "cpu",
                           "--checkpoint-dir", str(ck), "--syncBN",
                           "--epoch", str(last["epoch"]), "--batch-size", "2",
                           "--pad-multiple", "auto"])
    out = cli.evaluate_checkpoint(args)
    assert out["epoch"] == last["epoch"]
    np.testing.assert_allclose([out["mae"], out["mse"]], [last["mae"], last["mse"]],
                               rtol=1e-6)
    # the default picks the best MAE
    best = min(summary["epochs"], key=lambda r: r["mae"])["epoch"]
    assert cli.load_params(cli.parse_args(
        ["--checkpoint-dir", str(ck), "--syncBN"]))[1] == best
    with pytest.raises(SystemExit, match="add --syncBN"):
        cli.load_params(cli.parse_args(["--checkpoint-dir", str(ck)]))


@pytest.mark.parametrize("dtype,rtol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_serve_from_the_checkpoint_dir_counts_like_the_eval(data, trained,
                                                             tmp_path, dtype, rtol):
    from can_tpu_torch.serve import prepare_image

    ck, _ = trained
    out = cli.evaluate_checkpoint(cli.parse_args(
        ["--data_root", str(data), "--platform", "cpu", "--checkpoint-dir",
         str(ck), "--syncBN", "--show-index", "0", "--out-dir", str(tmp_path)]
        + (["--bf16"] if dtype == "bf16" else [])))
    img = read_png(str(data / "test_data" / "images" / "IMG_0000.png"))
    h, w = (s // 8 * 8 for s in img.shape[:2])
    service = serve_cli.build_service(serve_cli.parse_args(
        ["--checkpoint-dir", str(ck), "--syncBN", "--platform", "cpu",
         "--bucket-shapes", f"{h}x{w}", "--max-batch", "1",
         "--serve-dtype", dtype]))
    with service:
        count = service.submit(prepare_image(img)).result().count
    want = float(out["density"].astype(np.float64).sum())
    assert abs(want) > 1e-3
    np.testing.assert_allclose(count, want, rtol=rtol)


def test_jet_and_the_logger(capsys):
    np.testing.assert_array_equal(jet(np.array([0.0, 0.5, 1.0])),
                                  [[0, 0, 128], [128, 255, 128], [128, 0, 0]])
    logger = MetricLogger(use_wandb=False)
    logger.log({"mae": np.float32(1.5), "steps": 3}, step=2)
    logger.log_images(["x.png"], step=2)  # stdout only: nothing to send
    logger.finish()
    assert capsys.readouterr().out.strip() == "[metrics] step 2 mae=1.5 steps=3"
