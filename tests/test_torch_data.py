"""The port's host-side data path against the JAX package: density maps,
the synthetic dataset, the PNG codec, ``CrowdDataset`` and the
``ShardedBatcher`` schedule.

Tolerances: density maps rtol 1e-6 (the same float64 stamping, rounded
once to f32); dataset images within one u8 level in u8 mode (cv2's
fixed-point u8 resize against the port's f32 resize rounded back) and
atol 1e-5 in f32 on [0, 1] pixel values, before normalisation (f32
arithmetic of the same bilinear taps); dataset density maps rtol 1e-5;
PNG pixels and batcher schedules exact.
"""

import io
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from can_tpu.data import CrowdDataset as JaxCrowdDataset
from can_tpu.data import ShardedBatcher as JaxShardedBatcher
from can_tpu.data.density import gaussian_density_map as jax_density
from can_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from can_tpu_torch.data import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    CrowdDataset,
    ShardedBatcher,
    gaussian_density_map,
)
from can_tpu_torch.data import make_synthetic_dataset
from can_tpu_torch.data.imageio import (
    ImageDecodeError,
    _chunks,
    image_shape,
    read_image,
    read_png,
    write_png,
)

# off the /8 grid (the dataset resizes) and on it (it does not)
SIZES = ((61, 90), (64, 96), (83, 70), (48, 64))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_data")
    make_synthetic_dataset(str(root / "port"), 9, sizes=SIZES, seed=3)
    jax_synthetic(str(root / "jax"), 9, sizes=SIZES, seed=3)
    return root


def _pixels(img):
    """Normalised f32 pixels back to [0, 1]."""
    return img * IMAGENET_STD + IMAGENET_MEAN


def _rng(i, epoch=0, seed=0):
    return np.random.default_rng((seed, epoch, i))


# -- density maps ---------------------------------------------------------
@pytest.mark.parametrize("case", ["crowd", "single", "coincident", "border"])
def test_density_map_matches_jax(case):
    rng = np.random.default_rng(11)
    h, w = 70, 90
    pts = {"crowd": np.stack([rng.uniform(0, w, 30), rng.uniform(0, h, 30)], 1),
           "single": np.array([[40.5, 30.2]]),
           "coincident": np.array([[10.0, 10.0], [10.0, 10.0], [50.0, 20.0]]),
           # on the edge, outside (skipped) and in the corner
           "border": np.array([[0.0, 0.0], [89.9, 69.9], [95.0, 10.0],
                               [-1.0, 5.0], [45.0, 35.0]])}[case]
    got = gaussian_density_map(pts, (h, w))
    assert got.dtype == np.float32 and got.shape == (h, w)
    for native in (False, True):
        np.testing.assert_allclose(got, jax_density(pts, (h, w), use_native=native),
                                   rtol=1e-6, atol=1e-12)
    assert gaussian_density_map(np.zeros((0, 2)), (4, 5)).sum() == 0


def test_synthetic_dataset_makes_the_jax_draws(synth):
    """Same density maps item by item (so the same draws, images
    included: each item's draws follow the previous item's image), and a
    lossless PNG holding the pixels the draws made."""
    port, jax_ = synth / "port", synth / "jax"
    names = sorted(p.stem for p in (port / "ground_truth").iterdir())
    assert len(names) == 9
    shapes = set()
    for n in names:
        want = np.load(jax_ / "ground_truth" / f"{n}.npy")
        got = np.load(port / "ground_truth" / f"{n}.npy")
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
        img = read_png(str(port / "images" / f"{n}.png"))
        assert img.shape == want.shape + (3,)
        np.testing.assert_array_equal(
            img, np.asarray(Image.open(port / "images" / f"{n}.png")))
        shapes.add(img.shape[:2])
    assert len(shapes) > 1


# -- PNG codec ------------------------------------------------------------
def _filters(data: bytes, h: int, row_bytes: int) -> set:
    idat = b"".join(b for k, b in _chunks(data, "png") if k == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, row_bytes + 1)
    return set(raw[:, 0].tolist())


def _test_image(h, w, ch, seed=0):
    """Half noise, half gradient: the encoders pick several filters."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = ((3 * xx + 5 * yy) % 256).astype(np.uint8)[..., None].repeat(ch, -1)
    img = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
    img[h // 2:] = grad[h // 2:]
    return img


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_decoder_reads_pil_files(tmp_path, mode):
    """PIL's adaptive filtering (types 0, 1, 2 and 4 here; 150 x 200 RGB
    spans several IDAT chunks)."""
    ch = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    img = _test_image(150, 200, ch)
    path = tmp_path / f"pil_{mode}.png"
    Image.fromarray(img[..., 0] if ch == 1 else img, mode).save(path)
    data = path.read_bytes()
    assert {0, 1, 2, 4} <= _filters(data, 150, 200 * ch)
    got = read_png(str(path))
    np.testing.assert_array_equal(got, img)
    assert image_shape(str(path)) == (150, 200)
    rgb = read_image(str(path))
    assert rgb.shape == (150, 200, 3)
    np.testing.assert_array_equal(rgb, img[..., :3] if ch >= 3 else img.repeat(3, -1))


@pytest.mark.parametrize("filter_type", range(5))
def test_png_every_filter_type_against_pil(tmp_path, filter_type):
    """PIL never picks Average (3), so each type is also written by the
    port's encoder and read by both decoders."""
    img = _test_image(37, 29, 3, seed=filter_type)
    path = tmp_path / f"f{filter_type}.png"
    write_png(str(path), img, filter_type=filter_type)
    assert _filters(path.read_bytes(), 37, 29 * 3) == {filter_type}
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(str(path)), img)


def test_png_refusals_name_the_file(tmp_path, monkeypatch):
    bad = tmp_path / "bad.png"
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, format="PNG")
    bad.write_bytes(buf.getvalue())
    with pytest.raises(ImageDecodeError, match="bad.png.*bit depth 16"):
        read_png(str(bad))
    corrupt = tmp_path / "corrupt.png"
    write_png(str(tmp_path / "ok.png"), np.zeros((4, 4, 3), np.uint8))
    data = bytearray((tmp_path / "ok.png").read_bytes())
    data[40] ^= 0xFF  # inside IDAT
    corrupt.write_bytes(bytes(data))
    with pytest.raises(ImageDecodeError, match="corrupt.png.*CRC"):
        read_png(str(corrupt))
    jpg = tmp_path / "x.jpg"
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(jpg, quality=95)
    assert read_image(str(jpg)).shape == (16, 16, 3)
    monkeypatch.setitem(sys.modules, "PIL", None)  # no JPEG decoder
    with pytest.raises(ImageDecodeError, match="x.jpg.*PIL"):
        read_image(str(jpg))


# -- the dataset ----------------------------------------------------------
def _roots(synth, which):
    d = synth / which
    return str(d / "images"), str(d / "ground_truth")


@pytest.mark.parametrize("u8", [False, True])
@pytest.mark.parametrize("phase", ["train", "test"])
def test_crowd_dataset_matches_jax(synth, u8, phase):
    """The port's PNGs through both datasets (JAX: PIL + cv2), with the
    seeded flip in the train phase."""
    roots = _roots(synth, "port")
    port = CrowdDataset(*roots, phase=phase, u8_output=u8)
    ref = JaxCrowdDataset(*roots, phase=phase, u8_output=u8, prepared="off")
    assert len(port) == len(ref) == 9
    flips = [bool(_rng(i).integers(0, 2)) for i in range(9)]
    assert any(flips) and not all(flips)
    for i in range(9):
        assert port.snapped_shape(i) == ref.snapped_shape(i)
        img, dm = port.__getitem__(i, rng=_rng(i))
        jimg, jdm = ref.__getitem__(i, rng=_rng(i))
        assert img.dtype == jimg.dtype and img.shape == jimg.shape
        assert dm.shape == jdm.shape and dm.dtype == np.float32
        if u8:
            assert np.abs(img.astype(int) - jimg.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(_pixels(img), _pixels(jimg), rtol=0,
                                       atol=1e-5)
        np.testing.assert_allclose(dm, jdm, rtol=1e-5, atol=1e-7 * np.abs(jdm).max())


def test_crowd_dataset_reads_jpeg_through_pil(synth):
    """The JAX package's synthetic JPEGs, where PIL is installed."""
    roots = _roots(synth, "jax")
    port = CrowdDataset(*roots, u8_output=True)
    ref = JaxCrowdDataset(*roots, u8_output=True, prepared="off")
    for i in (0, 5):
        img, _ = port.__getitem__(i, rng=_rng(i))
        jimg, _ = ref.__getitem__(i, rng=_rng(i))
        assert np.abs(img.astype(int) - jimg.astype(int)).max() <= 1


def test_crowd_dataset_refuses_sub_cell_images(tmp_path):
    (tmp_path / "images").mkdir()
    (tmp_path / "gt").mkdir()
    write_png(str(tmp_path / "images" / "tiny.png"), np.zeros((5, 40, 3), np.uint8))
    with pytest.raises(ValueError, match="tiny.png is smaller than one 8px"):
        CrowdDataset(str(tmp_path / "images"), str(tmp_path / "gt"))


# -- the batcher ----------------------------------------------------------
@pytest.mark.parametrize("pad", [None, 32])
@pytest.mark.parametrize("seed", [0, 7])
def test_batcher_schedule_matches_jax(synth, pad, seed):
    """Indices, bucket keys and valid flags of two epochs; the batches
    themselves (padding, masks, the flip) for the first."""
    roots = _roots(synth, "port")
    port = ShardedBatcher(CrowdDataset(*roots), 3, seed=seed, pad_multiple=pad)
    ref = JaxShardedBatcher(JaxCrowdDataset(*roots, prepared="off"), 3, seed=seed,
                            pad_multiple=pad, plan_mode="legacy")
    for epoch in (0, 1):
        sched = port.global_schedule(epoch)
        assert sched == ref.global_schedule(epoch)
        assert port.batches_per_epoch(epoch) == ref.batches_per_epoch(epoch)
        assert any(not v for _, g in sched for _, v in g)  # fill slots
    assert port.dataset_size == ref.dataset_size == 9
    for b, jb in zip(port.epoch(0), ref.epoch(0)):
        np.testing.assert_array_equal(b.sample_mask, jb.sample_mask)
        np.testing.assert_array_equal(b.pixel_mask, jb.pixel_mask)
        np.testing.assert_allclose(_pixels(b.image) * b.sample_mask[:, None, None, None],
                                   _pixels(jb.image) * jb.sample_mask[:, None, None, None],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(b.dmap, jb.dmap, rtol=1e-5, atol=1e-9)


def test_batcher_refuses_planner_options(synth):
    """The planner's options are taken now (tests/test_torch_planner.py
    holds them against JAX); what cannot work is still refused."""
    ds = CrowdDataset(*_roots(synth, "port"))
    assert ShardedBatcher(ds, 2, pad_multiple="auto").describe_buckets() \
        == "exact shapes"  # 4 shapes, within the default budget of 8
    assert ShardedBatcher(ds, 2, remnant_sizes=True).batches_per_epoch(0) > 0
    with pytest.raises(ValueError, match="batch_quantum"):
        ShardedBatcher(ds, 3, remnant_sizes=True, batch_quantum=2)
    with pytest.raises(ValueError, match="multiples of the density"):
        ShardedBatcher(ds, 2, pad_multiple=12)


# -- prefetch -------------------------------------------------------------
from can_tpu_torch.data import PrefetchPutError, prefetch_to_device  # noqa: E402
from can_tpu_torch.data.prefetch import DevicePut  # noqa: E402


@pytest.mark.parametrize("depth", [0, 1, 2, 5])
def test_prefetch_keeps_order(depth):
    out = list(prefetch_to_device(range(7), lambda x: x * 10, depth=depth))
    assert out == [x * 10 for x in range(7)]
    assert list(prefetch_to_device([], lambda x: x, depth=depth)) == []


def test_prefetch_depth_0_is_synchronous_and_propagates_as_is():
    loaded = []

    def put(x):
        loaded.append(x)
        if x == 2:
            raise KeyError("boom")
        return x

    it = prefetch_to_device(range(5), put, depth=0)
    assert next(it) == 0 and loaded == [0]  # nothing loaded ahead
    assert next(it) == 1 and loaded == [0, 1]
    with pytest.raises(KeyError):
        next(it)


def test_prefetch_put_error_names_the_batch():
    def put(x):
        if x == 3:
            raise ValueError("bad batch")
        return x

    seen = []
    with pytest.raises(PrefetchPutError) as e:
        for x in prefetch_to_device(range(6), put, depth=2):
            seen.append(x)
    assert seen == [0, 1, 2]
    assert e.value.batch_index == 3
    assert isinstance(e.value.__cause__, ValueError)


def test_prefetch_abandoned_consumer_does_not_wait_for_the_queue():
    import threading
    import time

    gate = threading.Event()

    def put(x):
        if x >= 1:
            gate.wait(5)
        return x

    it = prefetch_to_device(range(10), put, depth=3)
    assert next(it) == 0
    t0 = time.perf_counter()
    it.close()  # the queued loads are cancelled, the running one not awaited
    assert time.perf_counter() - t0 < 2.0
    gate.set()


def test_device_put_on_the_cpu_is_the_plain_conversion(synth):
    from can_tpu_torch.train.steps import batch_to_device

    batch = next(ShardedBatcher(CrowdDataset(*_roots(synth, "port")), 3,
                                seed=0).epoch(0))
    put = DevicePut("cpu")
    assert put.stream is None and put.depth == 0  # synchronous on the CPU
    got, want = put(batch), batch_to_device(batch, "cpu")
    assert set(got) == set(want) == {"image", "dmap", "pixel_mask", "sample_mask"}
    for k in want:
        assert torch.equal(got[k], want[k]) and got[k].device.type == "cpu"
    via = list(prefetch_to_device([batch, batch], put, depth=2))
    assert len(via) == 2 and torch.equal(via[1]["image"], want["image"])
