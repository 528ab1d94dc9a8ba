"""The port's CANNet forward against ``can_tpu.models.cannet_apply``.

Weights carry over with ``state_dict_from_jax_params`` (HWIO -> OIHW,
(Cin, Cout) -> (O, I, 1, 1)).  Tolerance rtol 1e-3 / atol 1e-4 as in
tests/test_model.py:98.  ``cannet_init``'s N(0, 0.01) weights shrink the
activations layer by layer to ~1e-10 at the output, where that atol alone
would pass anything, so every case also runs He-scaled weights (the same
normals rescaled per layer to keep activations O(1)), which makes the
comparison bite.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from can_tpu.models import cannet_apply, cannet_init
from can_tpu.models.cannet import param_count as jax_param_count
from can_tpu.utils.torch_import import export_state_dict, save_params_npz
from can_tpu.utils.torch_import import reference_param_shapes as jax_ref_shapes
from can_tpu_torch.models import CANNet, random_state_dict, reference_param_shapes
from can_tpu_torch.ops import cuda_context as cc
from can_tpu_torch.utils.torch_import import (
    check_state_dict,
    load_params_npz,
    load_torch_checkpoint,
    state_dict_from_jax_params,
)


def he_scaled_params(params):
    """cannet_init's N(0, 0.01) normals rescaled to N(0, 2/fan_in) (convs)
    and N(0, 1/C) (context matrices): O(1) activations end to end."""

    def conv(p):
        kh, kw, cin, _ = p["w"].shape
        out = dict(p, w=p["w"] * (np.sqrt(2.0 / (kh * kw * cin)) / 0.01))
        if "b" in p:
            out["b"] = np.full_like(p["b"], 0.01)
        return out

    return {
        "frontend": [conv(p) for p in params["frontend"]],
        "backend": [conv(p) for p in params["backend"]],
        "output": conv(params["output"]),
        "context": {k: {n: v * (np.sqrt(1.0 / v.shape[0]) / 0.01)
                        for n, v in d.items()}
                    for k, d in params["context"].items()},
    }


def jax_params(kind: str, seed: int = 0):
    params = jax.tree.map(lambda a: np.array(a, np.float32),
                          cannet_init(jax.random.key(seed)))
    return he_scaled_params(params) if kind == "he" else params


def port_model(params) -> CANNet:
    model = CANNet(seed=None)
    model.load_state_dict(state_dict_from_jax_params(params))
    return model.eval()


@pytest.mark.parametrize("kind", ["init", "he"])
@pytest.mark.parametrize("shape", [(1, 64, 64, 3), (2, 64, 96, 3)])
def test_forward_matches_cannet_apply(kind, shape):
    params = jax_params(kind)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(cannet_apply(params, jnp.asarray(x), precision="highest"))
    with torch.no_grad():
        got = port_model(params)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], shape[1] // 8, shape[2] // 8, 1)
    if kind == "he":
        assert np.abs(want).max() > 1e-2  # the comparison is not vacuous
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_bf16_forward_tracks_f32():
    """bf16 compute (bf16 weights and activations, f32 accumulation) stays
    within a few bf16 roundings of the f32 forward, relative to the map's
    scale."""
    params = jax_params("he")
    x = np.random.default_rng(2).standard_normal((1, 64, 96, 3)).astype(np.float32)
    model = port_model(params)
    with torch.no_grad():
        f32 = model(torch.from_numpy(x)).numpy()
        bf16 = model.to(torch.bfloat16)(torch.from_numpy(x),
                                         compute_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    scale = np.abs(f32).max()
    np.testing.assert_allclose(bf16.float().numpy(), f32, rtol=0,
                               atol=5e-2 * scale)


def test_state_dict_layout_is_the_reference_layout():
    assert reference_param_shapes() == jax_ref_shapes()
    assert list(CANNet(seed=None).state_dict()) == list(jax_ref_shapes())
    params = cannet_init(jax.random.key(0))
    n_port = sum(p.numel() for p in CANNet(seed=None).parameters())
    assert n_port == jax_param_count(params)


def test_pth_and_npz_load_identical_tensors(tmp_path):
    params = jax.tree.map(np.asarray, cannet_init(jax.random.key(3)))
    carried = state_dict_from_jax_params(params)
    pth = tmp_path / "ref.pth"
    torch.save({k: torch.from_numpy(np.copy(v))
                for k, v in export_state_dict(params).items()}, pth)
    npz = tmp_path / "params.npz"
    save_params_npz(params, str(npz))
    from_pth = load_torch_checkpoint(str(pth))
    from_npz = load_params_npz(str(npz))
    assert list(from_pth) == list(from_npz) == list(carried)
    for k in carried:
        assert from_pth[k].dtype == torch.float32
        assert torch.equal(from_pth[k], carried[k]), k
        assert torch.equal(from_npz[k], carried[k]), k
    model = CANNet(seed=None)
    model.load_state_dict(from_pth, strict=True)


def test_checkpoint_wrappers_prefix_and_strictness(tmp_path):
    sd = {k: torch.from_numpy(v) for k, v in random_state_dict(0).items()}
    for i, obj in enumerate([{"state_dict": sd}, {"model": sd},
                             {f"module.{k}": v for k, v in sd.items()},
                             {k: v.half() for k, v in sd.items()}]):
        path = tmp_path / f"ck{i}.pth"
        torch.save(obj, path)
        got = load_torch_checkpoint(str(path))
        assert set(got) == set(sd)
        assert all(v.dtype == torch.float32 for v in got.values())
    missing = dict(sd)
    missing.pop("conv6_2.weight")
    with pytest.raises(ValueError, match="missing"):
        check_state_dict(missing)
    bad = dict(sd, **{"output_layer.weight": torch.zeros(1, 64, 3, 3)})
    with pytest.raises(ValueError, match="output_layer.weight"):
        check_state_dict(bad)


def test_random_state_dict_is_seeded_reference_init():
    a, b = random_state_dict(7), random_state_dict(7)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["frontend.0.weight"],
                              random_state_dict(8)["frontend.0.weight"])
    assert all(not v.any() for k, v in a.items() if k.endswith(".bias"))
    w = a["backend.0.weight"]
    assert w.dtype == np.float32 and abs(float(w.std()) - 0.01) < 1e-4
    # CANNet(seed=s) is exactly that state dict
    m = CANNet(seed=7)
    assert torch.equal(m.frontend[0].weight, torch.from_numpy(a["frontend.0.weight"]))


def _zero_gates(fv, aves, weights, hw):
    return cc.reference_context(fv, aves, [torch.zeros_like(w) for w in weights],
                                hw)


def test_he_state_dict_makes_the_gates_count():
    """``he=True`` rescales the same normals (N(0, 2/fan_in) convs,
    N(0, 1/C) context 1x1s, biases 0.01).  Under the reference init the
    gates are all sigmoid(0) and zeroing their matrices changes nothing;
    under He weights it moves the map by far more than any parity
    tolerance — what the card's checks rely on."""
    ref, he = random_state_dict(3), random_state_dict(3, he=True)
    for k, v in he.items():
        if k.endswith(".bias"):
            assert np.all(v == np.float32(0.01)), k
            continue
        fan_in = int(np.prod(v.shape[1:]))
        std = np.sqrt((1.0 if k.startswith("conv") else 2.0) / fan_in)
        np.testing.assert_allclose(v, ref[k] * np.float32(std / 0.01),
                                   rtol=1e-6, err_msg=k)
    x = torch.from_numpy(np.random.default_rng(4)
                         .standard_normal((1, 64, 96, 3)).astype(np.float32))
    effects = {}
    for name, sd in (("ref", ref), ("he", he)):
        model = CANNet(seed=None)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        with torch.no_grad():
            want = model(x)
            model.context_fused = _zero_gates
            flat = model(x)
        effects[name] = float((flat - want).abs().max() / want.abs().max())
    assert effects["ref"] < 1e-5 < 5e-2 < effects["he"], effects
