"""The port's trainer reproduces the JAX package's golden trajectory.

tests/test_golden.py's recipe on the CPU: the plain model from seed 0,
the seeded synthetic set (24 + 8 items at 64x64 and 64x96, seeds 42 and
43), global batch 8 with exact shapes, 10 epochs, evaluated after each.
JAX trains it on an 8-device mesh: the loss there is the global SSE
divided by the data-parallel size 8 (``make_dp_train_step``'s
``grad_divisor``) at lr 2e-6 x 8 (``make_lr_schedule(world_size=8)``,
the linear-scaling rule).  One process here takes the same two numbers
(``make_train_step(grad_divisor=8)``, ``make_lr_schedule(2e-6,
world_size=8)``): the same update as SSE at lr 2e-6.  The f32 MAE of every
epoch must lie within 1% of ``GOLDEN_MAE`` (imported from that file); bf16
within the 5% band that file falls back to off its pinned platform.

Two setups: JAX's own data and init (JPEG files from its writer, its
``cannet_init(key(0))`` weights), and the port's own (PNG from the port's
writer, ``CANNet(seed=0)``'s numpy draws) — what the card runs in
``chip_smoke.py [golden]``, where neither PIL nor JAX is installed.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.slow

RTOL = {"f32": 0.01, "bf16": 0.05}


def _trajectory(tmp_path, setup, tag):
    from can_tpu_torch.data import CrowdDataset, ShardedBatcher
    from can_tpu_torch.data.prefetch import DevicePut
    from can_tpu_torch.models import CANNet
    from can_tpu_torch.train import (
        create_train_state,
        evaluate,
        make_eval_step,
        make_lr_schedule,
        make_train_step,
        train_one_epoch,
    )

    if setup == "jax":
        from can_tpu.data import make_synthetic_dataset
    else:
        from can_tpu_torch.data import make_synthetic_dataset
    tr = make_synthetic_dataset(str(tmp_path / "data"), 24,
                                sizes=((64, 64), (64, 96)), seed=42)
    te = make_synthetic_dataset(str(tmp_path / "test"), 8, sizes=((64, 64),), seed=43)
    train_b = ShardedBatcher(CrowdDataset(*tr, phase="train"), 8, shuffle=True, seed=0)
    test_b = ShardedBatcher(CrowdDataset(*te, phase="test"), 8, shuffle=False, seed=0)
    model = CANNet(seed=0)
    if setup == "jax":
        import jax

        from can_tpu.models import cannet_init
        from can_tpu_torch.utils.torch_import import state_dict_from_jax_params

        params = jax.tree.map(np.asarray, cannet_init(jax.random.key(0)))
        model.load_state_dict(state_dict_from_jax_params(params))
    dt = torch.bfloat16 if tag == "bf16" else None
    state = create_train_state(model.to(memory_format=torch.channels_last),
                               make_lr_schedule(2e-6, world_size=8))
    step = make_train_step(grad_divisor=8, compute_dtype=dt)
    ev = make_eval_step(compute_dtype=dt)
    put = DevicePut("cpu")
    maes = []
    for epoch in range(10):
        state, _ = train_one_epoch(step, state, train_b.epoch(epoch), put_fn=put,
                                   epoch=epoch, prefetch=0)
        maes.append(evaluate(ev, state.model, test_b.epoch(0), put_fn=put,
                             dataset_size=test_b.dataset_size, prefetch=0)["mae"])
    return maes


@pytest.mark.parametrize("setup", ["jax", "port"])
@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_port_reproduces_the_golden_trajectory(tmp_path, setup, tag):
    from test_golden import GOLDEN_MAE

    maes = _trajectory(tmp_path, setup, tag)
    assert np.isfinite(maes).all()
    np.testing.assert_allclose(maes, GOLDEN_MAE[tag], rtol=RTOL[tag],
                               err_msg=f"{setup} {tag}: {maes}")
    assert maes[-1] < 0.75 * maes[0], maes
