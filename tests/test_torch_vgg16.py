"""The VGG-16 frontend loader against the JAX package's.

A seeded ``.npz`` in ``tools/convert_vgg16.py``'s layout (``conv{i}_w``
HWIO, ``conv{i}_b``, i in 0..9) is loaded by both packages' loaders: the
frontends are equal exactly, the rest of the model and a BN model's
BatchNorm parameters and running statistics are untouched, the shape
checks raise the JAX loader's errors, and the train CLI starts from the
file and refuses it beside ``--init-torch-pth``, as JAX's does.
"""

import numpy as np
import pytest
import torch

import jax

from can_tpu.models import cannet_init
from can_tpu.models.cannet import load_vgg16_frontend as jax_load
from can_tpu_torch.cli import train as cli
from can_tpu_torch.data import make_synthetic_dataset
from can_tpu_torch.models import CANNet, load_vgg16_frontend
from can_tpu_torch.utils.torch_import import state_dict_from_jax_params

CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512)


def write_vgg16_npz(path, seed=0, **override):
    rng = np.random.default_rng(seed)
    arrays, cin, i = {}, 3, 0
    for v in CFG:
        if v == "M":
            continue
        arrays[f"conv{i}_w"] = (rng.standard_normal((3, 3, cin, v)) * 0.05).astype(np.float32)
        arrays[f"conv{i}_b"] = rng.standard_normal(v).astype(np.float32)
        cin, i = v, i + 1
    arrays.update(override)
    np.savez(path, **arrays)
    return arrays


@pytest.fixture(scope="module")
def jax_init():
    return {bn: jax.tree.map(np.asarray, cannet_init(jax.random.key(1), batch_norm=bn))
            for bn in (False, True)}


@pytest.mark.parametrize("batch_norm", [False, True])
def test_loaders_give_equal_frontends(tmp_path, jax_init, batch_norm):
    npz = tmp_path / "vgg16.npz"
    arrays = write_vgg16_npz(npz)
    params = jax_init[batch_norm]
    want = state_dict_from_jax_params(jax_load(params, str(npz)))
    model = CANNet(seed=None, batch_norm=batch_norm)
    model.load_state_dict(state_dict_from_jax_params(params))
    if batch_norm:  # BN params and running stats that the loader must keep
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.weight.fill_(1.5)
                    m.running_var.fill_(2.0)
                    m.num_batches_tracked.fill_(7)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_vgg16_frontend(model, str(npz)) is model
    got = model.state_dict()
    convs = [k[:-len(".weight")] for k, v in got.items()
             if k.startswith("frontend.") and k.endswith(".weight") and v.dim() == 4]
    assert len(convs) == 10
    for i, k in enumerate(convs):
        assert torch.equal(got[f"{k}.weight"], want[f"{k}.weight"])
        assert torch.equal(got[f"{k}.bias"], want[f"{k}.bias"])
        np.testing.assert_array_equal(got[f"{k}.weight"].permute(2, 3, 1, 0).numpy(),
                                      arrays[f"conv{i}_w"])
    for k, v in got.items():
        if k.rsplit(".", 1)[0] not in convs:
            assert torch.equal(v, before[k]), k  # BN, context, backend kept


def test_shape_checks_raise_the_jax_errors(tmp_path, jax_init):
    bad_w = tmp_path / "bad_w.npz"
    write_vgg16_npz(bad_w, conv3_w=np.zeros((3, 3, 64, 128), np.float32))
    bad_b = tmp_path / "bad_b.npz"
    write_vgg16_npz(bad_b, conv9_b=np.zeros(256, np.float32))
    for path in (bad_w, bad_b):
        with pytest.raises(ValueError) as ref:
            jax_load(jax_init[False], str(path))
        with pytest.raises(ValueError) as mine:
            load_vgg16_frontend(CANNet(seed=None), str(path))
        assert str(mine.value) == str(ref.value)
    missing = tmp_path / "missing.npz"
    arrays = write_vgg16_npz(tmp_path / "full.npz")
    np.savez(missing, **{k: v for k, v in arrays.items() if k != "conv5_b"})
    with pytest.raises(KeyError, match="conv5_b"):
        load_vgg16_frontend(CANNet(seed=None), str(missing))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("vgg_synth")
    make_synthetic_dataset(str(root / "train_data"), 4, sizes=((64, 64),), seed=0)
    make_synthetic_dataset(str(root / "test_data"), 2, sizes=((64, 64),), seed=1)
    return root


def test_train_cli_starts_from_the_npz(synth, tmp_path):
    npz = tmp_path / "vgg16.npz"
    arrays = write_vgg16_npz(npz, seed=3)
    ck = tmp_path / "ck"
    cli.train(cli.parse_args([
        "--data_root", str(synth), "--platform", "cpu", "--syncBN", "--batch-size",
        "2", "--epochs", "1", "--max-steps-per-epoch", "1", "--lr", "0",
        "--checkpoint-dir", str(ck), "--vgg16-npz", str(npz)]))
    sd = torch.load(ck / "0" / "state.pt", weights_only=True)["model"]
    convs = [k[:-len(".weight")] for k, v in sd.items()
             if k.startswith("frontend.") and k.endswith(".weight") and v.dim() == 4]
    for i, k in enumerate(convs):
        np.testing.assert_array_equal(sd[f"{k}.weight"].permute(2, 3, 1, 0).numpy(),
                                      arrays[f"conv{i}_w"])
        np.testing.assert_array_equal(sd[f"{k}.bias"].numpy(), arrays[f"conv{i}_b"])
    assert torch.equal(sd["frontend.1.weight"], torch.ones(64))  # BN scale kept


def test_train_cli_refuses_vgg16_with_init_torch_pth(synth, tmp_path):
    npz = tmp_path / "vgg16.npz"
    write_vgg16_npz(npz)
    pth = tmp_path / "w.pth"
    torch.save(CANNet(seed=0).state_dict(), pth)
    with pytest.raises(SystemExit, match="drop --vgg16-npz"):
        cli.train(cli.parse_args(["--data_root", str(synth), "--platform", "cpu",
                                  "--init-torch-pth", str(pth), "--vgg16-npz",
                                  str(npz), "--checkpoint-dir", str(tmp_path / "c")]))
    with pytest.raises(SystemExit, match="no such VGG-16 file"):
        cli.train(cli.parse_args(["--data_root", str(synth), "--platform", "cpu",
                                  "--vgg16-npz", str(tmp_path / "absent.npz"),
                                  "--checkpoint-dir", str(tmp_path / "c")]))
