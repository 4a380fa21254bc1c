"""One rank of the TensorFlow and Keras binding scenarios, run under
either package's launcher by ``tests/test_torch_tensorflow.py``:

    python torch_tf_worker.py horovod_tpu|horovod_tpu_torch OUT_DIR

Every input is made with numpy from a seed (the rank's where it should
differ); each scenario's results go to ``OUT_DIR/rank<r>.npz`` under a
key that starts with the scenario's name, so that the test holds the
port's keys against the JAX package's.  The TF1 session hook runs last:
it turns eager execution off for the process."""

import importlib
import os
import sys
import tempfile

PKG, OUT = sys.argv[1], sys.argv[2]
if PKG == "horovod_tpu":
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import tensorflow as tf  # noqa: E402
import keras  # noqa: E402

hvd = importlib.import_module(f"{PKG}.tensorflow")
hvd_keras = importlib.import_module(f"{PKG}.keras")
Compression = importlib.import_module(
    f"{PKG}.tensorflow.compression").Compression
HvdError = importlib.import_module(f"{PKG}.common.handles").HvdError

if PKG == "horovod_tpu_torch":
    hvd.init(device="cpu")
else:
    hvd.init()
r, n = hvd.rank(), hvd.size()
assert n == 2, n
res = {}


def rng(seed, own=True):
    return np.random.RandomState(1000 * seed + (r if own else 0))


def keep(key, value):
    res[key] = np.asarray(value)


# ------------------------------------------------ dtype x op matrix
DTYPES = (tf.float16, tf.bfloat16, tf.float32, tf.float64,
          tf.int32, tf.int64, tf.uint8, tf.int8)
for k, dtype in enumerate(DTYPES):
    ops = ((hvd.Sum, "s"), (hvd.Average, "a")) \
        if dtype.is_floating else ((hvd.Sum, "s"),)
    if dtype.is_floating:
        x = rng(k).randn(3, 2) * 4
    else:
        x = rng(k).randint(0 if dtype == tf.uint8 else -5, 6, (3, 2))
    for op, tag in ops:
        out = hvd.allreduce(tf.cast(x, dtype), op=op,
                            name=f"mx_{dtype.name}_{tag}")
        assert out.dtype == dtype, (out.dtype, dtype)
        keep(f"matrix.{dtype.name}.{tag}", np.asarray(out, np.float64))

# ------------------------------------------------------- error cases
for bad, kwargs, frag in (
        (tf.ones([2 + r % 2]), {"op": hvd.Sum}, "shape"),
        (tf.cast(tf.ones([3]), tf.float32 if r % 2 == 0 else tf.float64),
         {"op": hvd.Sum}, "dtype"),
        (tf.ones([3]), {"op": hvd.Sum if r % 2 == 0 else hvd.Average},
         "op")):
    try:
        hvd.allreduce(bad, name=f"mxe_{frag}", **kwargs)
        raise SystemExit(f"expected HvdError for {frag}")
    except HvdError as exc:
        keep(f"errors.{frag}", frag in str(exc).lower())
# a poisoned name recovers
keep("errors.recovered",
     hvd.allreduce(tf.ones([3]), op=hvd.Sum, name="mxe_shape"))

# ------------------------------------------------------- collectives
for name, comp in (("fp16", Compression.fp16), ("bf16", Compression.bf16)):
    out = hvd.allreduce(tf.constant(rng(20).randn(8).astype(np.float32)),
                        op=hvd.Sum, name=f"comp_{name}", compression=comp)
    assert out.dtype == tf.float32
    keep(f"compression.{name}", out)
keep("collectives.average_default",
     hvd.allreduce(tf.constant(rng(21).randn(5).astype(np.float32)),
                   name="avg"))
keep("collectives.scaled",
     hvd.allreduce(tf.constant(rng(22).randn(4)), op=hvd.Sum, name="scl",
                   prescale_factor=0.5, postscale_factor=3.0))
keep("collectives.allgather",
     hvd.allgather(tf.constant(rng(23).randn(r + 1, 2).astype(np.float32)),
                   name="ag"))
keep("collectives.allgather_int",
     hvd.allgather(tf.constant(rng(24).randint(0, 9, (r + 2, 3))),
                   name="agi"))
keep("collectives.broadcast",
     hvd.broadcast(tf.constant(rng(25).randn(3)), root_rank=1, name="bc"))
keep("collectives.alltoall",
     hvd.alltoall(tf.constant(rng(26).randn(4).astype(np.float32)),
                  name="a2a"))
keep("collectives.alltoall_splits",
     hvd.alltoall(tf.constant(rng(27).randn(5, 2).astype(np.float32)),
                  splits=[2, 3] if r == 0 else [4, 1], name="a2as"))
for i, t in enumerate(hvd.grouped_allreduce(
        [tf.constant(rng(28 + i).randn(3).astype(np.float32))
         for i in range(3)], op=hvd.Sum, name="grp")):
    keep(f"collectives.grouped.{i}", t)
keep("collectives.object", hvd.broadcast_object(
    {"epoch": 3, "rank": r} if r == 0 else None, root_rank=0)["epoch"])
v = tf.Variable(rng(31).randn(2, 2).astype(np.float32))
hvd.broadcast_variables([v], root_rank=1)
keep("collectives.broadcast_variables", v.numpy())

# -------------------------------------------------- IndexedSlices
slices = tf.IndexedSlices(
    values=tf.constant(rng(32).randn(2, 4).astype(np.float32)),
    indices=tf.constant([0 + r, 2 + r], dtype=tf.int64),
    dense_shape=tf.constant([4, 4], dtype=tf.int64))
out = hvd.allreduce(slices, name="sparse")
assert isinstance(out, tf.IndexedSlices)
keep("sparse.values", out.values)
keep("sparse.indices", out.indices)
out = hvd.allreduce(slices, op=hvd.Sum, name="sparse_scaled",
                    prescale_factor=0.5, postscale_factor=0.25)
keep("sparse.scaled_values", out.values)


# ------------------------------------------------------ graph mode
@tf.function
def graph_sum(x):
    return hvd.allreduce(x, op=hvd.Sum, name="graph_ar")


@tf.function
def graph_gather(x):
    return hvd.allgather(x, name="graph_ag")


keep("graph.sum", graph_sum(tf.constant(rng(33).randn(6).astype(np.float32))))
keep("graph.sum_again",
     graph_sum(tf.constant(rng(34).randn(6).astype(np.float32))))
keep("graph.gather",
     graph_gather(tf.constant(rng(35).randn(r + 1, 2).astype(np.float32))))

# ----------------------------------- a gradient through the allreduce
v = tf.Variable(rng(36, own=False).randn(2).astype(np.float32))
with tf.GradientTape() as tape:
    avg = hvd.allreduce(v * (r + 1.0), op=hvd.Average, name="thru")
    loss = tf.reduce_sum(avg * avg)
keep("grad.value", avg)
keep("grad.gradient", tape.gradient(loss, v))


# ------------------------------------------- Keras models and training
def dense_model(widths=(8, 1), seed=40):
    layers = [keras.layers.Dense(w, activation="relu" if i + 1 < len(widths)
                                 else None) for i, w in enumerate(widths)]
    model = keras.Sequential(layers)
    model.build((None, 4))
    model.set_weights([rng(seed + i, own=False).randn(*w.shape)
                       .astype(np.float32) * 0.5
                       for i, w in enumerate(model.get_weights())])
    return model


x = rng(50).randn(16, 4).astype(np.float32)
y = (rng(51).randn(16, 1) * 0.1 + 1.0).astype(np.float32)

model = dense_model()
opt = keras.optimizers.SGD(learning_rate=0.05)
losses = []
for step in range(10):
    with hvd.DistributedGradientTape(tf.GradientTape()) as tape:
        loss = tf.reduce_mean((model(x) - y) ** 2)
    grads = tape.gradient(loss, model.trainable_variables)
    opt.apply_gradients(zip(grads, model.trainable_variables))
    losses.append(float(hvd.allreduce(loss, name=f"l.{step}")))
assert losses[-1] < losses[0], losses
keep("tape.losses", losses)
for i, w in enumerate(model.get_weights()):
    keep(f"tape.w{i}", w)

model = dense_model((1,), seed=60)
dopt = hvd.DistributedOptimizer(keras.optimizers.SGD(learning_rate=0.1))
with tf.GradientTape() as tape:
    loss = tf.reduce_mean((model(x) - y) ** 2)
grads = tape.gradient(loss, model.trainable_variables)
dopt.apply_gradients(zip(grads, model.trainable_variables))
for i, w in enumerate(model.get_weights()):
    keep(f"optimizer.w{i}", w)

model = dense_model((1,), seed=70)
acc = hvd.DistributedOptimizer(keras.optimizers.SGD(learning_rate=0.1),
                               backward_passes_per_step=2)
before = model.get_weights()
for i in range(2):
    with tf.GradientTape() as tape:
        loss = tf.reduce_mean((model(x[8 * i:8 * i + 8]) - y[8 * i:8 * i + 8])
                              ** 2)
    grads = tape.gradient(loss, model.trainable_variables)
    acc.apply_gradients(zip(grads, model.trainable_variables))
    if i == 0:
        keep("bpps.unchanged", all(np.array_equal(b, a) for b, a in
                                   zip(before, model.get_weights())))
for i, w in enumerate(model.get_weights()):
    keep(f"bpps.w{i}", w)

emb = keras.Sequential([keras.layers.Embedding(16, 4), keras.layers.Flatten(),
                        keras.layers.Dense(1)])
emb.build((None, 3))
emb.set_weights([rng(80 + i, own=False).randn(*w.shape).astype(np.float32)
                 for i, w in enumerate(emb.get_weights())])
sopt = hvd.DistributedOptimizer(keras.optimizers.SGD(learning_rate=0.1),
                                sparse_as_dense=True)
with tf.GradientTape() as tape:
    loss = tf.reduce_mean(
        (emb(tf.constant([[r, 2, 5]], dtype=tf.int32)) - 1.0) ** 2)
grads = tape.gradient(loss, emb.trainable_variables)
assert any(isinstance(g, tf.IndexedSlices) for g in grads)
sopt.apply_gradients(zip(grads, emb.trainable_variables))
for i, w in enumerate(emb.get_weights()):
    keep(f"sparse_as_dense.w{i}", w)

# model.fit with the four callbacks: warmup over epochs 0-1, then the
# schedule halves the rate in epoch 2 and restores it in epoch 3
model = dense_model((2, 1), seed=90)
model.compile(optimizer=hvd_keras.DistributedOptimizer(
    keras.optimizers.SGD(learning_rate=0.05)), loss="mse", run_eagerly=True)
fx = rng(95).randn(32, 4).astype(np.float32)
fy = (rng(96).randn(32, 1) * 0.1 + 1.0).astype(np.float32)
cbs = [hvd_keras.callbacks.BroadcastGlobalVariablesCallback(0),
       hvd_keras.callbacks.MetricAverageCallback(),
       hvd_keras.callbacks.LearningRateWarmupCallback(
           warmup_epochs=2, steps_per_epoch=4),
       hvd_keras.callbacks.LearningRateScheduleCallback(
           lambda epoch: 0.5 if epoch == 2 else 1.0, start_epoch=2)]
hist = model.fit(fx, fy, batch_size=8, epochs=4, verbose=0, callbacks=cbs,
                 shuffle=False)
keep("fit.loss", hist.history["loss"])
keep("fit.lr", float(model.optimizer.learning_rate.numpy()))
for i, w in enumerate(model.get_weights()):
    keep(f"fit.w{i}", w)

path = os.path.join(tempfile.mkdtemp(prefix=f"hvd_tf_{r}_"), "m.keras")
model.save(path)
loaded = hvd_keras.load_model(path)
keep("load_model.wrapped", getattr(loaded.optimizer, "_hvd_wrapped", False))
keep("load_model.class", type(loaded.optimizer).__name__)
keep("load_model.same", all(np.array_equal(a, b) for a, b in
                            zip(loaded.get_weights(), model.get_weights())))
rewrapped = hvd_keras.load_model(path)
rewrapped.fit(fx, fy, batch_size=8, epochs=1, verbose=0, shuffle=False)
for i, w in enumerate(rewrapped.get_weights()):
    keep(f"load_model.refit_w{i}", w)

keep("keras_ops.allreduce", hvd_keras.allreduce(
    tf.constant(rng(97).randn(2).astype(np.float32)), name="kar"))
keep("keras_ops.allgather", hvd_keras.allgather(
    tf.constant(rng(98).randn(1, 2).astype(np.float32)), name="kag"))
keep("keras_ops.broadcast", hvd_keras.broadcast(
    tf.constant(rng(99).randn(2).astype(np.float32)), 0, name="kbc"))
try:
    hvd_keras.broadcast_global_variables(0)
    raise SystemExit("expected TypeError")
except TypeError as exc:
    keep("keras_ops.tf1_type_error", "TF1" in str(exc))
bmodel = dense_model((1,), seed=100 + r)
hvd_keras.broadcast_global_variables(bmodel, root_rank=1)
for i, w in enumerate(bmodel.get_weights()):
    keep(f"keras_ops.bgv_w{i}", w)

# --------------------------------------------- the TF1 session hook
tf.compat.v1.disable_eager_execution()
g = tf.Graph()
with g.as_default():
    v1 = tf.compat.v1.get_variable(
        "v1", initializer=tf.constant(rng(110).randn(3).astype(np.float32)))
    v2 = tf.compat.v1.get_variable(
        "v2", initializer=tf.constant(rng(111).randn(2, 2)))
    hook = hvd.BroadcastGlobalVariablesHook(root_rank=1)
    with tf.compat.v1.train.MonitoredTrainingSession(hooks=[hook]) as s:
        out1, out2 = s.run([v1, v2])
keep("tf1_hook.v1", out1)
keep("tf1_hook.v2", out2)

os.makedirs(OUT, exist_ok=True)
np.savez(os.path.join(OUT, f"rank{r}.npz"), **res)
print(f"rank {r} TF_WORKER_OK", flush=True)
hvd.shutdown()
