"""``python -m can_tpu_torch.tools.prepare_data`` and what it runs,
against the JAX package's.

* ShanghaiTech-layout data written here as tests/test_data.py writes it
  (JPEG images, ``GT_IMG_*.mat`` with ``image_info``): the port's
  ``generate_density_maps`` writes ``.npy`` maps equal to JAX's within
  1e-6; the annotation fallbacks read the same points.
* ``imageio.image_size`` (headers only, no PIL) equals PIL's ``size`` on
  PNG and JPEG files written here (baseline, progressive, grayscale, with
  an EXIF block before the frame).
* ``--prepared`` then ``--verify-store`` succeed, and each package's tool
  opens and verifies the store the other's tool baked.
"""

import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import scipy.io as sio
from PIL import Image

from can_tpu.data import PreparedStore as JaxPreparedStore
from can_tpu.data import generate_density_maps as jax_generate
from can_tpu.data.density import _load_mat_points as jax_load_points
from can_tpu_torch.data import PreparedStore, generate_density_maps
from can_tpu_torch.data.density import _load_mat_points
from can_tpu_torch.data.imageio import image_size, write_png
from can_tpu_torch.tools import prepare_data

SIZES = ((100, 140), (64, 72), (96, 96))


def _write_split(root, split, n, seed):
    """n JPEG images with GT_IMG_*.mat heads, as tests/test_data.py:526."""
    img_dir = root / f"{split}_data" / "images"
    gt_dir = root / f"{split}_data" / "ground_truth"
    img_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = SIZES[i % len(SIZES)]
        Image.fromarray((rng.uniform(0, 1, (h, w, 3)) * 255).astype(np.uint8)
                        ).save(img_dir / f"IMG_{i}.jpg")
        k = int(rng.integers(1, 30))
        pts = np.stack([rng.uniform(0, w, k), rng.uniform(0, h, k)], axis=1)
        inner = np.empty((1, 1), object)
        inner[0, 0] = (pts,)
        sio.savemat(gt_dir / f"GT_IMG_{i}.mat", {"image_info": inner})


@pytest.fixture
def shtech(tmp_path):
    root = tmp_path / "part_X"
    _write_split(root, "train", 5, 0)
    _write_split(root, "test", 3, 1)
    return root


def test_density_maps_equal_jax(shtech, tmp_path):
    ref = tmp_path / "ref"
    shutil.copytree(shtech, ref)
    dirs = [str(shtech / f"{s}_data" / "images") for s in ("train", "test")]
    assert generate_density_maps(dirs, verbose=False) == 8
    assert jax_generate([str(ref / f"{s}_data" / "images") for s in ("train", "test")],
                        verbose=False) == 8
    for split in ("train", "test"):
        gt = shtech / f"{split}_data" / "ground_truth"
        for name in sorted(os.listdir(gt)):
            if name.endswith(".npy"):
                got = np.load(gt / name)
                want = np.load(ref / f"{split}_data" / "ground_truth" / name)
                assert got.dtype == want.dtype == np.float32
                assert got.shape == want.shape
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_annotation_layouts_read_like_jax(tmp_path):
    pts = np.random.default_rng(2).uniform(0, 50, (7, 2))
    struct = np.zeros((1, 1), dtype=[("location", object), ("number", object)])
    struct[0, 0]["location"] = pts
    struct[0, 0]["number"] = np.array([[7]])
    inner = np.empty((1, 1), object)
    inner[0, 0] = (pts,)
    cases = {"nested": {"image_info": inner}, "annPoints": {"annPoints": pts},
             "struct": {"image_info": struct}}
    for name, content in cases.items():
        path = tmp_path / f"{name}.mat"
        sio.savemat(path, content)
        np.testing.assert_array_equal(_load_mat_points(str(path)),
                                      jax_load_points(str(path)))
    sio.savemat(tmp_path / "none.mat", {"size": np.array([[640, 480]])})
    with pytest.raises(ValueError, match="no \\(N, 2\\) annotation"):
        _load_mat_points(str(tmp_path / "none.mat"))


@pytest.mark.parametrize("fmt", ["png", "png_gray", "jpeg", "jpeg_progressive",
                                 "jpeg_gray", "jpeg_exif"])
def test_image_size_equals_pil(tmp_path, fmt):
    rng = np.random.default_rng(len(fmt))
    arr = (rng.random((37, 53, 3)) * 255).astype(np.uint8)
    im = Image.fromarray(arr)
    path = tmp_path / f"x.{fmt.split('_')[0]}"
    if fmt == "png":
        write_png(str(path), arr)
    elif fmt == "png_gray":
        im.convert("L").save(path)
    elif fmt == "jpeg":
        im.save(path, quality=90)
    elif fmt == "jpeg_progressive":
        im.save(path, progressive=True, optimize=True)
    elif fmt == "jpeg_gray":
        im.convert("L").save(path)
    else:
        exif = Image.Exif()
        exif[0x010E] = "x" * 4000  # a long APP1 segment before the frame
        im.save(path, exif=exif)
    with Image.open(path) as ref:
        assert image_size(str(path)) == ref.size == (53, 37)


def test_image_size_refuses_other_files(tmp_path):
    from can_tpu_torch.data.imageio import ImageDecodeError

    (tmp_path / "x.gif").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ImageDecodeError, match="neither PNG nor JPEG"):
        image_size(str(tmp_path / "x.gif"))
    (tmp_path / "cut.jpg").write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF")
    with pytest.raises(ImageDecodeError, match="start-of-frame"):
        image_size(str(tmp_path / "cut.jpg"))


def _jax_tool():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_data", os.path.join(root, "tools", "prepare_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_prepared_then_verify_and_each_tool_opens_the_others_store(shtech, tmp_path,
                                                                    monkeypatch, capsys):
    port_out, jax_out = tmp_path / "port_store", tmp_path / "jax_store"
    assert prepare_data.main(["--root", str(shtech), "--prepared",
                              "--prepared-out", str(port_out), "--quiet"]) == 0
    out = capsys.readouterr().out
    assert "wrote 8 density maps" in out and out.count("baked prepared store") == 2
    assert prepare_data.main(["--root", str(shtech), "--verify-store",
                              "--prepared-out", str(port_out), "--quiet"]) == 0
    assert "verified 10 prepared files" in capsys.readouterr().out  # 5 x 2 flips
    # the JAX tool bakes from the same maps (no generation) ...
    monkeypatch.setattr(sys, "argv", ["prepare_data.py", "--root", str(shtech),
                                      "--prepared", "--no-gen", "--prepared-out",
                                      str(jax_out), "--quiet"])
    _jax_tool().main()
    capsys.readouterr()
    # ... and each package's tool verifies the other's store
    assert prepare_data.main(["--root", str(shtech), "--verify-store",
                              "--prepared-out", str(jax_out), "--quiet"]) == 0
    assert capsys.readouterr().out.count("verified") == 2
    monkeypatch.setattr(sys, "argv", ["prepare_data.py", "--root", str(shtech),
                                      "--verify-store", "--prepared-out",
                                      str(port_out), "--quiet"])
    _jax_tool().main()
    assert capsys.readouterr().out.count("verified") == 2
    for split in ("train", "test"):
        gt = str(shtech / f"{split}_data" / "ground_truth")
        mine = PreparedStore.open(str(port_out / split), gt_dmap_root=gt)
        theirs = JaxPreparedStore.open(str(jax_out / split), gt_dmap_root=gt)
        assert mine.manifest["items"].keys() == theirs.manifest["items"].keys()
        for name, entry in mine.manifest["items"].items():
            assert entry["hw"] == theirs.manifest["items"][name]["hw"]


def test_dirs_flag_and_no_dirs(shtech, tmp_path, capsys):
    img = shtech / "test_data" / "images"
    assert prepare_data.main(["--dirs", str(img), "--quiet"]) == 0
    assert "wrote 3 density maps" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no image directories"):
        prepare_data.main(["--root", str(tmp_path / "empty")])
