"""can_tpu_torch.serve.quant (int8 weight-only serving) against
can_tpu.serve.quant on the CPU.

The port quantises OIHW weights per output channel (axis 0); JAX
quantises HWIO kernels and (Cin, Cout) matrices per output channel (the
last axis).  The same host numpy operations run on both sides, so the
port's ``q`` must be JAX's ``q`` transposed, BIT FOR BIT, and the scales
equal; the int8 engine's counts must match JAX's int8 ``ServeEngine`` at
the model tolerance (rtol 1e-3 / atol 1e-4), with He-scaled weights.
"""

import jax
import numpy as np
import pytest
import torch

from can_tpu.serve import ServeEngine as JaxServeEngine
from can_tpu.serve import quant as jquant
from can_tpu_torch.data import pad_batch
from can_tpu_torch.serve import (
    PARITY_LADDER,
    ServeEngine,
    dequantize_tree,
    host_tree,
    param_bytes,
    parity_report,
    prepare_image,
    quantize_tree,
    tree_signature,
)
from can_tpu_torch.serve import quant as tquant
from can_tpu_torch.utils.torch_import import (
    int8_state_dict_from_jax,
    state_dict_from_jax_params,
)
from tests.test_torch_bn import jax_bn_params
from tests.test_torch_model import jax_params

DS = 8


def random_stats(params, seed=0):
    """A BN model's batch_stats with non-trivial means and variances."""
    rng = np.random.default_rng(seed)

    def layer(p):
        c = p["b"].shape[0]
        return {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}

    return {g: [layer(p) for p in params[g]] for g in ("frontend", "backend")}


@pytest.fixture(scope="module")
def he_params():
    return jax_params("he")


@pytest.mark.parametrize("hwio", [(3, 3, 64, 128), (1, 1, 512, 512),
                                  (3, 3, 3, 64), (1, 1, 64, 1)])
def test_quantize_int8_bitwise_vs_jax(hwio):
    rng = np.random.default_rng(sum(hwio))
    w = (rng.standard_normal(hwio) * rng.uniform(1e-4, 3.0, hwio[-1])
         ).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero output channel: scale 1, q 0
    if hwio[-1] > 2:
        w[..., 2] *= 1e-30  # a channel of tiny values
    want = jquant.quantize_int8(w)
    got = tquant.quantize_int8(np.transpose(w, (3, 2, 0, 1)))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(),
                                  np.transpose(want["q"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
    assert got["scale"][0] == 1.0 and not got["q"][0].any()
    # the context matrices: (Cin, Cout) in JAX, (Cout, Cin, 1, 1) here
    m = w[0, 0]
    np.testing.assert_array_equal(
        tquant.quantize_int8(m.T[:, :, None, None])["q"].numpy()[:, :, 0, 0],
        jquant.quantize_int8(m)["q"].T)
    # dequantisation: the same f32 product on both sides
    np.testing.assert_array_equal(
        tquant.dequantize_int8(got).numpy(),
        np.transpose(np.asarray(jquant.dequantize_int8(want)), (3, 2, 0, 1)))


@pytest.mark.parametrize("kind", ["plain", "bn"])
def test_int8_tree_conversion_bitwise(he_params, kind):
    """The port's quantisation of the converted f32 state dict equals the
    converted JAX int8 tree bit for bit, and ``param_bytes`` agrees."""
    params = he_params if kind == "plain" else jax_bn_params()
    stats = random_stats(params) if kind == "bn" else None
    mine = quantize_tree(state_dict_from_jax_params(params, stats), "int8")
    jq = jax.tree.map(np.asarray, jquant.quantize_tree(params, "int8"))
    theirs = int8_state_dict_from_jax(jq, stats)
    assert list(mine) == list(theirs)
    n_q = 0
    for k, v in mine.items():
        if tquant.is_quantized_leaf(v):
            n_q += 1
            assert not k.startswith("output_layer.")
            np.testing.assert_array_equal(v["q"].numpy(), theirs[k]["q"].numpy())
            np.testing.assert_array_equal(v["scale"].numpy(),
                                          theirs[k]["scale"].numpy())
        else:
            assert v.dim() < 2 or k.startswith("output_layer."), k
            assert v.dtype == theirs[k].dtype
            np.testing.assert_array_equal(v.numpy(), theirs[k].numpy())
    assert n_q == 16 + 8  # the frontend/backend convs and 8 context 1x1s
    assert param_bytes(mine) == param_bytes(theirs) == jquant.param_bytes(jq)
    f32 = state_dict_from_jax_params(params, stats)
    assert param_bytes(f32) == jquant.param_bytes(params)
    assert tree_signature(mine) == tree_signature(theirs)
    # dequantised, the weights are JAX's dequantised weights transposed
    deq = dequantize_tree(mine, "int8")
    jdeq = jquant.dequantize_tree(jq, "int8")
    np.testing.assert_array_equal(
        deq["frontend.0.weight"].numpy(),
        np.transpose(np.asarray(jdeq["frontend"][0]["w"]), (3, 2, 0, 1)))
    np.testing.assert_array_equal(
        deq["conv6_2.weight"].numpy()[:, :, 0, 0],
        np.asarray(jdeq["context"]["s6"]["weight"]).T)


def test_quantize_tree_modes_and_refusal():
    sd = {"a.weight": torch.ones(4, 2, 3, 3), "a.bias": torch.ones(4),
          "output_layer.weight": torch.ones(1, 4, 1, 1),
          "b.running_mean": torch.zeros(4), "b.num_batches_tracked":
          torch.tensor(3)}
    assert quantize_tree(sd, "f32")["a.weight"] is sd["a.weight"]
    b = quantize_tree(sd, "bf16")
    assert b["a.weight"].dtype == torch.bfloat16
    assert b["b.running_mean"].dtype == torch.float32
    q = quantize_tree(sd, "int8")
    assert tquant.is_quantized_leaf(q["a.weight"])
    assert q["output_layer.weight"].dtype == torch.float32
    assert q["b.num_batches_tracked"].dtype == torch.int64
    # BN buffers are not parameter bytes (JAX's batch_stats are apart)
    assert param_bytes(q) == 4 * 2 * 9 + 4 * 4 + 4 * 4 + 4 * 4
    with pytest.raises(ValueError):
        quantize_tree(sd, "fp8")
    host = host_tree(q)
    assert tree_signature(host) == tree_signature(q)
    assert all(t.device.type == "cpu" for t in
               (host["a.weight"]["q"], host["a.weight"]["scale"], host["a.bias"]))


@pytest.fixture(scope="module")
def int8_engines(he_params):
    port = ServeEngine(state_dict_from_jax_params(he_params), device="cpu",
                       serve_dtype="int8")
    jaxe = JaxServeEngine(jax.tree.map(np.asarray, he_params),
                          serve_dtype="int8")
    return port, jaxe


def _batch(dtype, seed=0):
    rng = np.random.default_rng(seed)
    items = []
    for h, w in [(64, 64), (56, 40), (48, 64)]:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if dtype == "f32":
            img = prepare_image(img)
        items.append((img, np.zeros((h // DS, w // DS, 1), np.float32)))
    return pad_batch(items, (64, 64), 4, [True] * 3, DS)


@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_int8_engine_counts_match_jax_int8_engine(int8_engines, dtype):
    port, jaxe = int8_engines
    batch = _batch(dtype, seed=7)
    got, dens = port.predict_batch(batch, want_density=True)
    want, wdens = jaxe.predict_batch(batch, want_density=True)
    assert got.shape == (4,) and got[3] == 0.0
    assert np.abs(want).max() > 1.0  # He-scaled weights: real counts
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(dens, wdens, rtol=1e-3, atol=1e-4)


def test_parity_report_grades_equal(he_params, int8_engines):
    port8, jax8 = int8_engines
    port32 = ServeEngine(state_dict_from_jax_params(he_params), device="cpu")
    jax32 = JaxServeEngine(jax.tree.map(np.asarray, he_params))
    rng = np.random.default_rng(11)
    images = [prepare_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
              for h, w in ((64, 64), (48, 72), (64, 40))]
    mine = parity_report(port8, port32, images)
    theirs = jquant.parity_report(jax8, jax32, images)
    assert mine["grade"] == theirs["grade"]
    assert mine["ladder"] == theirs["ladder"]
    assert [r for r, _ in PARITY_LADDER] == [r for r, _ in jquant.PARITY_LADDER]
    assert mine["grade"] != "fail"
    np.testing.assert_allclose(mine["worst_rel_count_delta"],
                               theirs["worst_rel_count_delta"], rtol=0.2,
                               atol=2e-4)
    for w in (0.0, 5e-4, 1e-2, 0.05, 0.5):
        assert tquant.grade_parity(w) == jquant.grade_parity(w)


def test_int8_engine_keeps_no_f32_copy(int8_engines):
    """int8 stays int8: the engine's quantised weights are int8 tensors,
    and no f32 tensor the size of one is held — the model skeleton is on
    the meta device."""
    port, _ = int8_engines
    q_sizes = {v["q"].numel() for v in port.params.values()
               if tquant.is_quantized_leaf(v)}
    assert len(q_sizes) > 5
    for k, v in port.params.items():
        if tquant.is_quantized_leaf(v):
            assert v["q"].dtype == torch.int8
        else:
            assert v.numel() not in q_sizes, k
    real = [n for n, t in list(port.model.named_parameters())
            + list(port.model.named_buffers()) if t.device.type != "meta"]
    assert real == []
    assert param_bytes(port.params) * 3.9 < param_bytes(
        quantize_tree(state_dict_from_jax_params(jax_params("he")), "f32"))


def test_int8_swap_params_quantized_tree(he_params, int8_engines):
    """A pre-quantised tree (the converted JAX int8 tree) swaps into an int8
    engine; the same tree is refused by an f32 engine (another dtype)."""
    port, _ = int8_engines
    eng = ServeEngine(state_dict_from_jax_params(jax_params("he", seed=1)),
                      device="cpu", serve_dtype="int8")
    batch = _batch("f32", seed=3)
    before = eng.predict_batch(batch)[0]
    jq = jax.tree.map(np.asarray, jquant.quantize_tree(he_params, "int8"))
    eng.swap_params(int8_state_dict_from_jax(jq), quantized=True)
    np.testing.assert_array_equal(eng.predict_batch(batch)[0],
                                  port.predict_batch(batch)[0])
    assert not np.allclose(before, port.predict_batch(batch)[0])
    f32 = ServeEngine(state_dict_from_jax_params(he_params), device="cpu")
    with pytest.raises(ValueError, match="swap_params structure mismatch"):
        f32.swap_params(int8_state_dict_from_jax(jq), quantized=True)


@pytest.mark.slow
def test_int8_grade_on_the_smokes_weights_matches_jax():
    """The smoke's int8 parity ladder input, on the CPU: its seeded He
    weights (``random_state_dict(0, he=True)``) and its first three ladder
    requests (384 x 512/768/1024 bounds).  The port's int8 engine and
    JAX's move each count from its own f32 engine's by the same amount
    (~4.5%, grade "loose" in both packages)."""
    from can_tpu.serve import prepare_image as jax_prepare_image
    from can_tpu.utils.torch_import import convert_state_dict
    from can_tpu_torch.models import random_state_dict

    sd = random_state_dict(0, he=True)
    port = {dt: ServeEngine({k: torch.from_numpy(v) for k, v in sd.items()},
                            device="cpu", serve_dtype=dt)
            for dt in ("f32", "int8")}
    jx = {dt: JaxServeEngine(convert_state_dict(sd), serve_dtype=dt)
          for dt in ("f32", "int8")}
    rng = np.random.default_rng(1)  # chip_smoke.py's SEED + 1
    for wb in (512, 768, 1024):
        img = rng.integers(0, 256, (384 - 5, wb - 3, 3), dtype=np.uint8)
        mine = parity_report(port["int8"], port["f32"], [prepare_image(img)])
        theirs = jquant.parity_report(jx["int8"], jx["f32"],
                                      [jax_prepare_image(img)])
        print(f"384x{wb}: port {mine['worst_rel_count_delta']}, "
              f"JAX {theirs['worst_rel_count_delta']}")
        assert mine["grade"] == theirs["grade"] == "loose"
        assert abs(mine["worst_rel_count_delta"]
                   - theirs["worst_rel_count_delta"]) < 2e-3
