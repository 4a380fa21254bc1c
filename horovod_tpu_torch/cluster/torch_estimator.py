"""Torch estimator (port of ``horovod_tpu/cluster/torch_estimator.py``;
reference: ``horovod/spark/torch/estimator.py:449`` TorchEstimator: the
dataset goes to a Store, one trainer a rank runs through a Backend with
``DistributedOptimizer``, rank 0 checkpoints to the store, the metrics are
averaged, and ``fit`` returns a model that serves).

Each rank trains on its card (``hvd.device()``) through the port's
``DistributedOptimizer``, ``broadcast_parameters`` and
``broadcast_optimizer_state``; the metrics are allreduced on the port's
eager plane.  Departures from the JAX package's estimator, which trains
on the CPU: ``loss`` may also be a callable ``loss(outputs, y)``, as
``JaxEstimator``'s (the LM's ``models.lm_loss``); integer features stay
integer (token ids for an embedding; the JAX estimator casts every
feature to float32); ``seed`` seeds torch before ``model_factory`` runs;
``device`` is where ``fit`` loads rank 0's checkpoint and the returned
model serves (default: the card), whatever card rank 0 saved it from."""

import os
import tempfile
import time

import numpy as np
import torch

from horovod_tpu_torch.cluster.backend import InProcessBackend
from horovod_tpu_torch.cluster.store import (LocalStore, load_rank_shard,
                                             materialize_shards,
                                             split_validation)
from horovod_tpu_torch.common import basics

CHECKPOINT = "model.pt"


def _column(a, dtype=None):
    if not torch.is_tensor(a):
        a = np.asarray(a)
        # torch refuses a read-only view (an Arrow buffer can be one)
        a = torch.as_tensor(a if a.flags.writeable else a.copy())
    return a if dtype is None else a.to(dtype)


def _features(x):
    x = _column(x)
    return x.float() if x.is_floating_point() else x


def _labels(y):
    y = _column(y)
    return y.float() if y.dtype == torch.float64 else y


def _loss_fn(loss):
    return loss if callable(loss) else getattr(torch.nn.functional, loss)


def _clock(device):
    """The host clock once ``device`` has finished what was queued, so
    that a rank's timings hold the card's work, not its queueing."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def _train_one_rank(rank, model_factory, loss, store, epochs, batch_size,
                    learning_rate, num_ranks, has_val=False,
                    streaming=False, seed=0):
    """One rank's training, in a job this process has joined.  -> (the
    metric, this rank's timings: its wall clock at the start, the seconds
    of building the model and its optimizer, of taking rank 0's
    parameters and optimizer state, of the steps with the metric's
    allreduce, of rank 0's checkpoint and of validation)."""
    from horovod_tpu_torch.mpi_ops import allreduce
    from horovod_tpu_torch.common.ops_enum import Average, Sum
    from horovod_tpu_torch.optimizer import (DistributedOptimizer,
                                             broadcast_optimizer_state,
                                             broadcast_parameters)

    start = time.time()
    device = basics.device()
    torch.manual_seed(seed)
    model = model_factory().to(device)
    optimizer = torch.optim.SGD(model.parameters(), lr=learning_rate,
                                momentum=0.9)
    t_build = _clock(device)
    loss_fn = _loss_fn(loss)
    if streaming:
        from horovod_tpu_torch.utils.data import lockstep_shard_batches

        batches = lockstep_shard_batches(store, rank, num_ranks,
                                         batch_size, epochs)
    else:
        from horovod_tpu_torch.utils.data import BatchIterator

        shard = load_rank_shard(store, rank, num_ranks)
        batches = BatchIterator(shard, min(batch_size, len(shard["x"])),
                                epochs=epochs)

    broadcast_parameters(model.state_dict(), root_rank=0)
    broadcast_optimizer_state(optimizer, root_rank=0)
    optimizer = DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters())
    t_sync = _clock(device)

    loss = torch.zeros(())
    steps = 0
    for batch in batches:
        xb = _features(batch["x"]).to(device)
        yb = _labels(batch["y"]).to(device)
        optimizer.zero_grad()
        loss = loss_fn(model(xb), yb)
        loss.backward()
        optimizer.step()
        steps += 1

    avg_loss = float(allreduce(
        torch.tensor([float(loss.detach())], device=device), op=Average,
        name="torch_estimator.metric.loss")[0])
    t_train = time.time()

    if rank == 0:
        os.makedirs(store.checkpoint_path(), exist_ok=True)
        torch.save(model.state_dict(),
                   os.path.join(store.checkpoint_path(), CHECKPOINT))
    t_ckpt = time.time()
    timings = {"start": start, "steps": steps, "build_s": t_build - start,
               "sync_s": t_sync - t_build, "train_s": t_train - t_sync,
               "checkpoint_s": t_ckpt - t_train}
    if not has_val:
        return avg_loss, timings
    vs = load_rank_shard(store, rank, num_ranks, split="val")
    vx, vy = _features(vs["x"]).to(device), _labels(vs["y"]).to(device)
    with torch.no_grad():
        local = float(loss_fn(model(vx), vy))
    rows = float(len(vx))
    # weighted by rows: np.array_split's val shards can differ by one
    total = allreduce(torch.tensor([local * rows, rows], device=device),
                      op=Sum, name="torch_estimator.metric.val_loss")
    timings["val_s"] = time.time() - t_ckpt
    return ({"loss": avg_loss, "val_loss": float(total[0] / total[1])},
            timings)


class TorchModel:
    """What ``TorchEstimator.fit`` returns: the fitted module on
    ``device``, in eval mode."""

    def __init__(self, model, loss_fn, device=None):
        self.model = model
        self._loss_fn = loss_fn
        self.device = device

    def predict(self, x):
        with torch.no_grad():
            return self.model(_features(x).to(self.device))

    def evaluate(self, x, y):
        with torch.no_grad():
            return float(self._loss_fn(self.predict(x),
                                       _labels(y).to(self.device)))


class TorchEstimator:
    """Distributed trainer for a torch module over a Store and a Backend.

    ``model_factory``: a callable with no arguments that builds the
    module; each rank builds it (under ``torch.manual_seed(seed)``) and
    takes rank 0's parameters, and ``fit`` builds it again to load the
    checkpoint, as the reference rebuilds a model for its remote
    trainers.  With ``ProcessBackend`` it and ``loss`` must be picklable
    by name (see ``backend.py``).  ``loss``: the name of a
    ``torch.nn.functional`` loss, or a callable ``loss(outputs, y)``.
    Training is SGD with momentum 0.9; ``validation`` holds out the last
    fraction of the rows and adds ``val_loss``; ``streaming`` reads
    batches row group by row group from a ``ParquetStore``.  ``device``:
    where ``fit`` loads the checkpoint and the model serves, and the
    device of the default ``InProcessBackend``.

    After ``fit``, ``timings`` holds its seconds: ``materialize_s``,
    ``run_s`` (the backend's run), ``reload_s``, and each rank's
    ``ranks`` (``start``, its wall clock when its work began, ``steps``,
    ``build_s``: the model and its optimizer, ``sync_s``: rank 0's
    parameters and optimizer state,
    ``train_s``: the steps and the metric, ``checkpoint_s``, ``val_s``).
    """

    def __init__(self, model_factory, loss="mse_loss", epochs=1,
                 batch_size=32, learning_rate=0.01, store=None,
                 backend=None, validation=None, streaming=False, seed=0,
                 device=None):
        self.model_factory = model_factory
        self.loss = loss
        self.epochs = epochs
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.store = store
        self.backend = backend
        self.validation = validation
        # stream row groups instead of loading shards (sharded-dataset
        # stores only)
        self.streaming = streaming
        self.seed = seed
        self.device = device
        self.timings = None

    def fit(self, x, y):
        """Materialize ``(x, y)`` to the store, train a rank a process,
        -> (``TorchModel``, the ranks' metrics)."""
        t0 = time.time()
        device = basics.resolve_device(self.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        store = self.store or LocalStore(tempfile.mkdtemp(
            prefix="hvd_torch_estimator_"))
        if self.streaming:
            # before the backend joins a job: the error is the store's
            from horovod_tpu_torch.utils.data import require_sharded_store
            require_sharded_store(store)
        backend = self.backend or InProcessBackend(device=self.device)
        n = backend.num_processes()

        x_val = y_val = None
        if self.validation is not None:
            x, y, x_val, y_val = split_validation(x, y, self.validation)
        materialize_shards(store, x, y, n, x_val=x_val, y_val=y_val)
        t1 = time.time()

        results = backend.run(
            _train_one_rank,
            args=(self.model_factory, self.loss, store, self.epochs,
                  self.batch_size, self.learning_rate, n,
                  x_val is not None, self.streaming, self.seed))
        t2 = time.time()

        torch.manual_seed(self.seed)
        model = self.model_factory().to(device)
        model.load_state_dict(torch.load(
            os.path.join(store.checkpoint_path(), CHECKPOINT),
            map_location=device, weights_only=True))
        model.eval()
        self.timings = {"materialize_s": t1 - t0, "run_start": t1,
                        "run_s": t2 - t1, "reload_s": time.time() - t2,
                        "ranks": [t for _, t in results]}
        return (TorchModel(model, _loss_fn(self.loss), device),
                [m for m, _ in results])
