"""Functions that ``tests/test_torch_run.py`` ships to ``run(fn)``'s
workers.  Plain pickle sends a function by module reference, so each
worker imports this module: it imports nothing of JAX, which would cost
every worker seconds."""

import os


def allreduce_fn(scale):
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        r = hvd.rank()
        total = hvd.allreduce(torch.full((3,), (r + 1) * scale),
                              op=hvd.Sum)
        return r, total.tolist()
    finally:
        hvd.shutdown()


def rank_fn():
    return int(os.environ["HVD_RANK"])


def failing_fn():
    raise ValueError("rank function raised")
