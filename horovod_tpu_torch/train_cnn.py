"""The data-parallel CNN training step: the port of
``bench.py::_bench_resnet`` (bench.py:72-177), as functions that
``chip_smoke.py`` and a bench leg call.

The step of the reference: the model in training mode, the loss
``-mean(sum(log_softmax(logits) * onehot))``, gradients averaged over the
ranks by ``DistributedOptimizer(SGD(lr=0.1, momentum=0.9))`` (torch's
first step sets the momentum buffer to the gradient, so the update is
optax's ``sgd(0.1, momentum=0.9)``), then the BatchNorm running
statistics averaged over the ranks (the reference's ``pmean`` of the new
``batch_stats``, bench.py:117-118); without that the ranks' statistics
drift apart.  Synthetic data as the reference makes it: images from
``numpy.random.RandomState(0).randn``, labels from ``RandomState(1)``,
the global batch cut into the ranks' shares.
"""

import time

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.layers import BatchNorm
from horovod_tpu_torch.optimizer import DistributedOptimizer, \
    allreduce_gradients


def cross_entropy(logits, labels):
    """``-mean(sum(log_softmax(logits) * onehot(labels)))`` in fp32 or
    wider."""
    logp = F.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def synthetic_batch(per_rank, image, classes, device, rank=0, size=1):
    """This rank's share of the reference's global batch: NHWC fp32
    images from ``RandomState(0)``, int64 labels from ``RandomState(1)``."""
    n = per_rank * size
    x = np.random.RandomState(0).randn(n, image, image, 3).astype(np.float32)
    y = np.random.RandomState(1).randint(0, classes, (n,))
    mine = slice(rank * per_rank, (rank + 1) * per_rank)
    return (torch.from_numpy(x[mine]).to(device),
            torch.from_numpy(y[mine]).to(device))


def make_optimizer(model):
    """``DistributedOptimizer(SGD(lr=0.1, momentum=0.9))`` over the
    model's parameters (the reference's constants), with its parameters
    broadcast from rank 0."""
    from horovod_tpu_torch.optimizer import broadcast_parameters

    opt = DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    broadcast_parameters(model.state_dict(), root_rank=0)
    return opt


def average_batch_stats(model):
    """Replace every BatchNorm's running ``mean`` and ``var`` with their
    average over the ranks."""
    stats = [t for m in model.modules() if isinstance(m, BatchNorm)
             for t in (m.mean, m.var)]
    if not stats or basics.size() == 1:
        return
    with torch.no_grad():
        for t, avg in zip(stats, allreduce_gradients(stats)):
            t.copy_(avg)


def train_step(model, opt, images, labels):
    """One step of the reference's ``per_shard_step``; -> the loss (a
    tensor, not synchronised)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = cross_entropy(model(images), labels)
    loss.backward()
    opt.step()
    average_batch_stats(model)
    return loss.detach()


def timed_steps(model, opt, images, labels, steps):
    """``steps`` training steps timed as one window, as the reference
    times them: the card synchronised once before the first and once
    after the last, nothing read back in between.  -> (each step's loss,
    the window's seconds on the host clock, the milliseconds between
    consecutive step ends on the card's clock (CUDA events; empty off the
    card), a spread that does not stop the host from queueing ahead)."""
    cuda = images.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    ends = []
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(train_step(model, opt, images, labels))
        if cuda:
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    gaps = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    return torch.stack(losses).tolist(), elapsed, gaps
