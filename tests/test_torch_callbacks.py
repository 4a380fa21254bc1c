"""The port's training-loop helpers (``horovod_tpu_torch/callbacks.py``)
against the JAX package's (``horovod_tpu/callbacks.py``): each schedule
gives optax's values over a range of steps (rtol 1e-6, the
``pytest.approx`` of ``tests/test_callbacks.py``, with a floor of 1e-6
of the schedule's peak: optax computes in fp32), and works as a ``LambdaLR``.  ``metric_average`` and
``broadcast_global_variables`` run on gloo ranks in
``tests/test_torch_elastic.py``."""

import numpy as np
import pytest
import torch

from horovod_tpu import callbacks as jcb

import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks as cb

STEPS = list(range(0, 260, 3)) + [4, 10, 100, 150, 199, 200, 201]


def _same(got, want):
    """Within 1e-6 of each value and of the schedule's peak: optax
    rounds ``(init - end) * frac + end`` in fp32, 1.4e-6 off the exact
    0.025 at the start of a warm-up to 0.8."""
    peak = max(abs(float(want(s))) for s in STEPS)
    for s in STEPS:
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6,
                                   atol=1e-6 * peak, err_msg=f"step {s}")


@pytest.mark.parametrize("kw", [
    dict(base_lr=0.1, warmup_steps=10, scale=8),
    dict(base_lr=0.1, warmup_steps=10, initial_factor=0.25, scale=8),
    dict(base_lr=0.05, warmup_steps=37, scale=3),
    dict(base_lr=0.1, warmup_steps=0, scale=8),
])
def test_warmup_schedule_is_optaxs(kw):
    _same(cb.warmup_schedule(**kw), jcb.warmup_schedule(**kw))


@pytest.mark.parametrize("kw", [
    dict(base_lr=0.1, boundaries_and_scales={100: 0.1}, scale=8),
    dict(base_lr=0.1, boundaries_and_scales={30: 0.5, 60: 0.1, 200: 0.3},
         scale=2),
])
def test_piecewise_schedule_is_optaxs(kw):
    _same(cb.piecewise_schedule(**kw), jcb.piecewise_schedule(**kw))


@pytest.mark.parametrize("warmup", [4, 50])
def test_warmup_then_piecewise_is_optaxs(warmup):
    kw = dict(base_lr=0.1, warmup_steps=warmup,
              boundaries_and_scales={100: 0.1, 150: 0.5}, scale=8)
    _same(cb.warmup_then_piecewise(**kw), jcb.warmup_then_piecewise(**kw))


def test_negative_scale_raises_optaxs_words():
    with pytest.raises(ValueError) as got:
        cb.piecewise_schedule(0.1, {10: -1.0}, scale=1)
    with pytest.raises(ValueError) as want:
        jcb.piecewise_schedule(0.1, {10: -1.0}, scale=1)
    assert str(got.value) == str(want.value)


def test_scaled_lr_uses_the_world_size():
    hvd.init(device="cpu")
    try:
        assert cb.scaled_lr(0.1) == 0.1 * hvd.size()
        assert cb.scaled_lr(0.1, scale=4) == pytest.approx(0.4)
        sched = cb.warmup_schedule(0.1, warmup_steps=10)
        assert sched(10) == pytest.approx(0.1 * hvd.size())
    finally:
        hvd.shutdown()


def test_schedule_drives_lambda_lr():
    sched = cb.warmup_then_piecewise(0.1, 4, {10: 0.1}, scale=8)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=1.0)
    lr = torch.optim.lr_scheduler.LambdaLR(opt, sched)
    seen = []
    for _ in range(20):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        lr.step()
    np.testing.assert_allclose(seen, [sched(s) for s in range(20)])
    assert seen[0] == pytest.approx(0.1) and seen[-1] == pytest.approx(0.08)
