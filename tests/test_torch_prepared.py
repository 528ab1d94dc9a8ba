"""The port's prepared 1/8-density store and item cache against the JAX
package's: a store written by either package opens and loads in the
other, equal element for element (the files are one format); staleness
is caught the same ways; ``CrowdDataset`` reads through a store and
through the cache bit-identically to a fresh decode; the cache keeps its
byte budget and counts its hits.
"""

import json
import os
import shutil

import numpy as np
import pytest

from can_tpu.data import CrowdDataset as JaxCrowdDataset
from can_tpu.data import PreparedStore as JaxPreparedStore
from can_tpu.data import StaleStoreError as JaxStaleStoreError
from can_tpu.data import write_store as jax_write_store
from can_tpu_torch.data import (
    CrowdDataset,
    ItemCache,
    PreparedStore,
    StaleStoreError,
    make_synthetic_dataset,
    write_store,
)
from can_tpu_torch.data.prepared import MANIFEST_NAME, prepared_paths

# off the /8 grid and on it
SIZES = ((61, 90), (64, 96), (83, 70))


@pytest.fixture
def synth(tmp_path):
    img, gt = make_synthetic_dataset(str(tmp_path / "d"), 5, sizes=SIZES, seed=2)
    return img, gt


def _names(img_root):
    return sorted(os.listdir(img_root))


def _maps(root, names):
    return {(n, flip): np.load(prepared_paths(root, n)[flip]) for n in names
            for flip in (0, 1)}


def test_jax_store_loads_in_the_port(synth, tmp_path):
    img, gt = synth
    root = jax_write_store(img, gt, str(tmp_path / "jax_store"))
    names = _names(img)
    port = CrowdDataset(img, gt, prepared="off")
    store = PreparedStore.open(root, gt_dmap_root=gt, gt_downsample=8,
                               img_names=names,
                               expected_hw=dict(zip(names, map(port.snapped_shape,
                                                               range(len(names))))))
    for (name, flip), want in _maps(root, names).items():
        got = store.load(name, flip=bool(flip))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert store.verify() == 2 * len(names)
    # the port's dataset reads its density maps from the JAX store
    ds = CrowdDataset(img, gt, prepared=root)
    assert ds.prepared_note["active"]
    for i, name in enumerate(names):
        _, dmap = ds.__getitem__(i, rng=np.random.default_rng((0, 0, i)))
        flip = bool(np.random.default_rng((0, 0, i)).integers(0, 2))
        np.testing.assert_array_equal(dmap[..., 0], store.load(name, flip=flip))


def test_port_store_loads_in_jax(synth, tmp_path):
    img, gt = synth
    root = write_store(img, gt, str(tmp_path / "port_store"))
    names = _names(img)
    store = JaxPreparedStore.open(root, gt_dmap_root=gt, gt_downsample=8,
                                  img_names=names)
    for (name, flip), want in _maps(root, names).items():
        np.testing.assert_array_equal(store.load(name, flip=bool(flip)), want)
    assert store.verify() == 2 * len(names)
    ref = JaxCrowdDataset(img, gt, prepared=root)
    assert ref.prepared_note["active"]
    _, dmap = ref.__getitem__(1, rng=np.random.default_rng((0, 0, 1)))
    flip = bool(np.random.default_rng((0, 0, 1)).integers(0, 2))
    np.testing.assert_array_equal(dmap[..., 0], store.load(names[1], flip=flip))


def test_both_stores_have_one_format(synth, tmp_path):
    """Same manifest keys and per-item fields, same file names and sizes,
    same .npy headers; the values agree to the two resizes' f32
    rounding (the density tolerance of tests/test_torch_data.py)."""
    img, gt = synth
    a = write_store(img, gt, str(tmp_path / "port"))
    b = jax_write_store(img, gt, str(tmp_path / "jax"))
    ma, mb = (json.load(open(os.path.join(r, MANIFEST_NAME))) for r in (a, b))
    assert set(ma) == set(mb)
    assert ma["version"] == mb["version"] and ma["gt_downsample"] == mb["gt_downsample"]
    assert set(ma["items"]) == set(mb["items"])
    for name, ea in ma["items"].items():
        eb = mb["items"][name]
        assert set(ea) == set(eb)
        for k in ("hw", "src_bytes", "src_mtime_ns", "bytes", "bytes_flip"):
            assert ea[k] == eb[k], (name, k)
    assert sorted(os.listdir(os.path.join(a, "dmaps"))) == \
        sorted(os.listdir(os.path.join(b, "dmaps")))
    for f in os.listdir(os.path.join(a, "dmaps")):
        ra = open(os.path.join(a, "dmaps", f), "rb").read()
        rb = open(os.path.join(b, "dmaps", f), "rb").read()
        assert ra[:128] == rb[:128]  # magic, version, header
        np.testing.assert_allclose(np.load(os.path.join(a, "dmaps", f)),
                                   np.load(os.path.join(b, "dmaps", f)),
                                   rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("u8", [False, True])
def test_dataset_through_the_store_equals_the_decode(synth, tmp_path, u8):
    img, gt = synth
    write_store(img, gt)  # the conventional <gt>/prepared, found by "auto"
    fast = CrowdDataset(img, gt, u8_output=u8)
    slow = CrowdDataset(img, gt, u8_output=u8, prepared="off")
    assert fast.prepared_note["active"] and not slow.prepared_note["active"]
    for i in range(len(fast)):
        for seed in (0, 1, 2):  # both flips
            a = fast.__getitem__(i, rng=np.random.default_rng((seed, 0, i)))
            b = slow.__getitem__(i, rng=np.random.default_rng((seed, 0, i)))
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fault", ["version", "downsample", "item_added",
                                   "truncated", "source_changed",
                                   "shape_changed", "no_manifest"])
def test_staleness_is_caught_like_jax(synth, tmp_path, fault):
    img, gt = synth
    root = write_store(img, gt, str(tmp_path / "s"))
    mpath = os.path.join(root, MANIFEST_NAME)
    names = _names(img)
    manifest = json.load(open(mpath))
    expected = None
    if fault == "version":
        manifest["version"] = 99
    elif fault == "downsample":
        manifest["gt_downsample"] = 4
    elif fault == "item_added":
        shutil.copy(os.path.join(img, names[0]), os.path.join(img, "IMG_9999.png"))
        shutil.copy(os.path.join(gt, names[0][:-4] + ".npy"),
                    os.path.join(gt, "IMG_9999.npy"))
    elif fault == "truncated":
        with open(prepared_paths(root, names[1])[1], "ab") as f:
            f.write(b"\0")
    elif fault == "source_changed":
        src = os.path.join(gt, names[2][:-4] + ".npy")
        st = os.stat(src)
        os.utime(src, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    elif fault == "shape_changed":
        expected = {names[0]: (8, 8)}
    elif fault == "no_manifest":
        os.remove(mpath)
    if fault in ("version", "downsample"):
        json.dump(manifest, open(mpath, "w"))
    names = _names(img)
    kw = dict(gt_dmap_root=gt, gt_downsample=8, img_names=names,
              expected_hw=expected)
    with pytest.raises(StaleStoreError):
        PreparedStore.open(root, **kw)
    with pytest.raises(JaxStaleStoreError):
        JaxPreparedStore.open(root, **kw)
    if fault != "shape_changed":
        # named explicitly: it raises; probed: decode, with the reason noted
        with pytest.raises(StaleStoreError):
            CrowdDataset(img, gt, prepared=root)
        shutil.rmtree(os.path.join(gt, "prepared"), ignore_errors=True)
        shutil.copytree(root, os.path.join(gt, "prepared"))
        ds = CrowdDataset(img, gt)
        assert not ds.prepared_note["active"] and ds.prepared_note["reason"]


def test_verify_catches_a_rewritten_map(synth, tmp_path):
    img, gt = synth
    root = write_store(img, gt, str(tmp_path / "s"))
    store = PreparedStore.open(root)
    assert store.verify() == 2 * len(_names(img))
    path = prepared_paths(root, _names(img)[0])[0]
    arr = np.load(path)
    np.save(path, arr + 1.0)  # same size, other bytes
    with pytest.raises(StaleStoreError, match="checksum"):
        store.verify()


def test_item_cache_budget_lru_and_stats():
    a = np.zeros(100, np.uint8)
    cache = ItemCache(max_bytes=250)
    assert cache.put("a", (a,)) and cache.put("b", (a,))
    assert cache.get("a") is not None  # a is now the most recent
    assert cache.put("c", (a,))  # evicts b, the least recent
    assert cache.get("b") is None and cache.get("c") is not None
    assert not cache.put("c", (a,))  # already there
    assert not cache.put("big", (np.zeros(300, np.uint8),))  # over budget
    st = cache.stats()
    assert (st["hits"], st["misses"], st["inserts"], st["evictions"],
            st["oversize_skips"], st["items"], st["bytes"]) == (2, 1, 3, 1, 1, 2, 200)
    assert st["hit_rate"] == round(2 / 3, 4) and len(cache) == 2


def test_dataset_cache_hits_are_bit_identical_and_read_only(synth):
    img, gt = synth
    cache = ItemCache(max_bytes=10 ** 8)
    cached = CrowdDataset(img, gt, item_cache=cache, prepared="off")
    u8 = CrowdDataset(img, gt, item_cache=cache, prepared="off", u8_output=True)
    plain = CrowdDataset(img, gt, prepared="off")
    for _ in range(2):
        for i in range(len(plain)):
            rng = (7, 0, i)
            a = cached.__getitem__(i, rng=np.random.default_rng(rng))
            b = plain.__getitem__(i, rng=np.random.default_rng(rng))
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            assert not a[0].flags.writeable and not a[1].flags.writeable
            # the decode config is in the key: u8 never gets an f32 item
            assert u8.__getitem__(i, rng=np.random.default_rng(rng))[0].dtype == np.uint8
    st = cache.stats()
    assert st["hits"] >= len(plain) and st["inserts"] >= len(plain)
