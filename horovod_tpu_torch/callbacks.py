"""Training-loop helpers: the Keras-callback surface as functions (port
of ``horovod_tpu/callbacks.py``; reference: ``horovod/_keras/
callbacks.py``: BroadcastGlobalVariablesCallback :22,
MetricAverageCallback :48, LearningRateScheduleCallback :89,
LearningRateWarmupCallback :172).

The schedules are plain ``step -> lr`` callables with optax's numbers
(``linear_schedule``, ``piecewise_constant_schedule``,
``join_schedules``).  With ``torch.optim.lr_scheduler.LambdaLR``, which
multiplies the optimizer's own rate by the callable's value, build the
optimizer at ``lr=1.0``::

    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, hvd.callbacks.warmup_schedule(0.1, warmup_steps=500))
"""

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.ops_enum import Average


def broadcast_global_variables(variables, root_rank=0):
    """Start-of-training sync: ``variables`` (a ``state_dict``) take
    ``root_rank``'s values, in place.  -> ``variables``."""
    from horovod_tpu_torch.optimizer import broadcast_parameters

    broadcast_parameters(variables, root_rank=root_rank)
    return variables


def metric_average(value, name):
    """The average of a scalar metric over the ranks (an eager Average
    allreduce named ``metric.<name>``)."""
    from horovod_tpu_torch import mpi_ops

    tensor = torch.tensor(float(value), dtype=torch.float32,
                          device=basics.device())
    return float(mpi_ops.allreduce(tensor, op=Average, name=f"metric.{name}"))


def scaled_lr(base_lr, scale=None):
    """The linear scaling rule: ``base_lr * size``."""
    return base_lr * (scale if scale is not None else basics.size())


def _linear(init_value, end_value, transition_steps):
    """``optax.linear_schedule``."""
    if transition_steps <= 0:
        return lambda step: init_value

    def schedule(step):
        count = min(max(step, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def warmup_schedule(base_lr, warmup_steps, scale=None, initial_factor=None):
    """From ``base_lr`` (times ``initial_factor``) up to ``base_lr *
    size`` over ``warmup_steps``, constant after (reference:
    LearningRateWarmupCallback).  -> ``step -> lr``."""
    target = scaled_lr(base_lr, scale)
    start = base_lr * (initial_factor if initial_factor is not None else 1.0)
    if warmup_steps <= 0:
        return lambda step: target
    return _linear(start, target, warmup_steps)


def piecewise_schedule(base_lr, boundaries_and_scales, scale=None):
    """``base_lr * size`` times every scale whose boundary ``step`` has
    reached, e.g. ``{30_000: 0.1, 60_000: 0.1}`` (reference:
    LearningRateScheduleCallback's staircase).  -> ``step -> lr``."""
    target = scaled_lr(base_lr, scale)
    if any(s < 0.0 for s in boundaries_and_scales.values()):
        raise ValueError(
            "`piecewise_constant_schedule` expects non-negative scale "
            "factors")
    steps = sorted(boundaries_and_scales.items())

    def schedule(step):
        value = target
        for boundary, factor in steps:
            if step >= boundary:
                value *= factor
        return value
    return schedule


def warmup_then_piecewise(base_lr, warmup_steps, boundaries_and_scales,
                          scale=None):
    """Warm-up to the size-scaled rate, then the staircase, its boundaries
    counted from the warm-up's end as ``optax.join_schedules`` counts
    them (reference: ``examples/keras_imagenet_resnet50.py``)."""
    warmup = warmup_schedule(base_lr, warmup_steps, scale)
    after = piecewise_schedule(base_lr, boundaries_and_scales, scale)

    def schedule(step):
        if step < warmup_steps:
            return warmup(step)
        return after(step - warmup_steps)
    return schedule
