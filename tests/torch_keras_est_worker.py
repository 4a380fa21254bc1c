"""The Keras estimator's fits for ``tests/test_torch_keras_estimator.py``,
in one process (TensorFlow costs 10-20 s to import, here and in each
rank):

    python torch_keras_est_worker.py OUT.npz

The port's two-rank fit through ``ProcessBackend`` runs in a thread
while its ranks start, and meanwhile the main thread fits the JAX
estimator and the port's on one in-process rank each.  Data and weights
come from numpy seeds; Keras's shuffle comes from the global seed, set
before each one-rank fit, so the thread's Keras work that draws random
numbers (the fitted model's build) waits until both are done."""

import os
import sys
import tempfile
import threading

import numpy as np


def model_and_data(rows, seed):
    import keras

    rng = np.random.RandomState(seed)
    x = rng.randn(rows, 8).astype(np.float32)
    w = rng.randn(8, 2).astype(np.float32)
    y = x @ w + 0.01 * rng.randn(rows, 2).astype(np.float32)
    model = keras.Sequential([keras.layers.Dense(16, activation="relu"),
                              keras.layers.Dense(2)])
    model.build((None, 8))
    model.set_weights([rng.randn(*v.shape).astype(np.float32) * 0.3
                       for v in model.get_weights()])
    return model, x, y


def one():
    """The JAX KerasEstimator and the port's, one in-process rank each."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import keras

    from horovod_tpu.cluster import KerasEstimator as JaxKerasEstimator
    from horovod_tpu.cluster import LocalStore as JaxStore
    from horovod_tpu.cluster.backend import InProcessBackend as JaxBackend
    from horovod_tpu_torch.cluster import (InProcessBackend, KerasEstimator,
                                           LocalStore)

    model, x, y = model_and_data(64, 3)
    res = {}
    for tag, est in (
            ("jax", JaxKerasEstimator(
                model, loss="mse", optimizer="sgd", epochs=3, batch_size=8,
                learning_rate=0.02, validation=0.25,
                store=JaxStore(tempfile.mkdtemp()),
                backend=JaxBackend(num_proc=1))),
            ("port", KerasEstimator(
                model, loss="mse", optimizer="sgd", epochs=3, batch_size=8,
                learning_rate=0.02, validation=0.25,
                store=LocalStore(tempfile.mkdtemp()),
                backend=InProcessBackend(device="cpu")))):
        keras.utils.set_random_seed(7)
        fitted, metrics = est.fit(x, y)
        for i, w in enumerate(fitted.model.get_weights()):
            res[f"{tag}.w{i}"] = w
        res[f"{tag}.loss"] = metrics[0]["loss"]
        res[f"{tag}.val_loss"] = metrics[0]["val_loss"]
        res[f"{tag}.evaluate"] = fitted.evaluate(x[-16:], y[-16:])
    return res


def two(model, x, y, gate):
    """The port's fit at two ranks through ProcessBackend, on uneven
    validation shards (27 rows: 14 and 13); after the ranks return it
    waits for ``gate``."""
    from horovod_tpu_torch.cluster import (KerasEstimator, LocalStore,
                                           ProcessBackend)

    class Gated(ProcessBackend):
        def run(self, fn, args=(), kwargs=None):
            out = super().run(fn, args=args, kwargs=kwargs)
            gate.wait()
            return out

    est = KerasEstimator(model, loss="mse", optimizer="sgd", epochs=3,
                         batch_size=8, learning_rate=0.02,
                         store=LocalStore(tempfile.mkdtemp()),
                         backend=Gated(2, device="cpu"), validation=0.3)
    fitted, metrics = est.fit(x, y)
    res = {"two.loss": [m["loss"] for m in metrics],
           "two.val_loss": [m["val_loss"] for m in metrics]}
    x_val, y_val = x[-27:], y[-27:]
    res["two.evaluate_all"] = fitted.evaluate(x_val, y_val)
    # each rank's validation shard, evaluated with the fitted weights
    res["two.evaluate_shards"] = [fitted.evaluate(xs, ys) for xs, ys in zip(
        np.array_split(x_val, 2), np.array_split(y_val, 2))]
    res["two.shard_rows"] = [len(s) for s in np.array_split(x_val, 2)]
    return res


def main(out):
    res, errors, gate = {}, [], threading.Event()

    def run_two(*args):
        try:
            res.update(two(*args))
        except BaseException as exc:  # noqa: BLE001 — reraised below
            errors.append(exc)

    thread = threading.Thread(target=run_two,
                              args=(*model_and_data(90, 5), gate))
    thread.start()
    try:
        res.update(one())
    finally:
        gate.set()
        thread.join()
    if errors:
        raise errors[0]
    np.savez(out, **res)


if __name__ == "__main__":
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")
    main(sys.argv[1])
    print("KERAS_EST_OK", flush=True)
