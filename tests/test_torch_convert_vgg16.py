"""The port's VGG-16 converter (``can_tpu_torch.tools.convert_vgg16``)
against the JAX package's ``tools/convert_vgg16.py``: on a seeded
torchvision-layout state dict the two ``.npz`` files are equal bitwise,
both refuse the same drifted dicts with the same error, and the port's
file loads into the frontend as the JAX loader loads it.  Exact: no
tolerance (the conversion is a transpose)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import convert_vgg16 as jax_tool  # noqa: E402

from can_tpu.models import cannet_init  # noqa: E402
from can_tpu.models.cannet import load_vgg16_frontend as jax_load  # noqa: E402
from can_tpu_torch.models import CANNet, load_vgg16_frontend  # noqa: E402
from can_tpu_torch.tools import convert_vgg16 as tool  # noqa: E402
from can_tpu_torch.utils.torch_import import state_dict_from_jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# torchvision vgg16's 13 convs: features index, out channels
VGG16_CONVS = ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256), (14, 256),
               (17, 512), (19, 512), (21, 512), (24, 512), (26, 512), (28, 512))


def vgg16_state_dict(seed=0) -> dict:
    """A torchvision ``vgg16`` state dict's layout (features convs, then
    the classifier), seeded normals."""
    rng = np.random.default_rng(seed)
    sd, cin = {}, 3
    for k, cout in VGG16_CONVS:
        sd[f"features.{k}.weight"] = rng.standard_normal((cout, cin, 3, 3)).astype(np.float32)
        sd[f"features.{k}.bias"] = rng.standard_normal(cout).astype(np.float32)
        cin = cout
    for k, shape in ((0, (64, 128)), (3, (32, 64)), (6, (10, 32))):  # small classifier
        sd[f"classifier.{k}.weight"] = rng.standard_normal(shape).astype(np.float32)
        sd[f"classifier.{k}.bias"] = rng.standard_normal(shape[0]).astype(np.float32)
    return sd


def test_npz_equals_the_jax_tools_bitwise(tmp_path):
    sd = vgg16_state_dict()
    got, want = tool.state_dict_to_npz_arrays(sd), jax_tool.state_dict_to_npz_arrays(sd)
    assert list(got) == list(want) == [f"conv{i}_{p}" for i in range(10) for p in "wb"]
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    # the command line, from a torch.save'd file
    pth = tmp_path / "vgg16.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    out = tmp_path / "frontend.npz"
    proc = subprocess.run([sys.executable, "-m", "can_tpu_torch.tools.convert_vgg16",
                           "--pth", str(pth), "--out", str(out)], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    saved = np.load(out)
    assert sorted(saved.files) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(saved[k], want[k])


def _drop(sd, key):
    return {k: v for k, v in sd.items() if k != key}


def _reorder(sd):
    items = list(sd.items())
    items[0], items[1] = items[1], items[0]
    return dict(items)


def _reshape(sd, key, shape):
    return {k: (np.zeros(shape, np.float32) if k == key else v) for k, v in sd.items()}


def _truncate(sd, n):
    return dict(list(sd.items())[:n])


DRIFTS = {
    "missing bias": lambda sd: _drop(sd, "features.7.bias"),
    "swapped order": _reorder,
    "wrong shape": lambda sd: _reshape(sd, "features.5.weight", (128, 64, 5, 5)),
    "truncated": lambda sd: _truncate(sd, 13),
    "bn layout": lambda sd: {("features.1.weight" if k == "features.2.weight" else k): v
                             for k, v in sd.items()},
}


@pytest.mark.parametrize("drift", sorted(DRIFTS))
def test_both_refuse_the_same_drifted_dicts(drift):
    sd = DRIFTS[drift](vgg16_state_dict())
    errors = []
    for fn in (tool.state_dict_to_npz_arrays, jax_tool.state_dict_to_npz_arrays):
        with pytest.raises(ValueError) as e:
            fn(sd)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "pos " in errors[0]


def test_the_port_npz_loads_as_the_jax_loader_loads_it(tmp_path):
    path = tmp_path / "frontend.npz"
    np.savez(path, **tool.state_dict_to_npz_arrays(vgg16_state_dict(1)))
    params = jax.tree.map(np.asarray, cannet_init(jax.random.key(0)))
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jax_load(params, str(path))))
    model = CANNet(seed=None)
    model.load_state_dict(state_dict_from_jax_params(params))
    load_vgg16_frontend(model, str(path))
    got = model.state_dict()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


def test_missing_pth_and_no_download_source(tmp_path):
    with pytest.raises(SystemExit, match="no such file"):
        tool.main(["--pth", str(tmp_path / "none.pth")])
    with pytest.raises(SystemExit):
        tool.parse_args([])  # --pth is required: there is no download source
