"""The MXNet binding's scenarios on four ranks, over the numpy stand-in
``tests/_mxnet_shim`` (which must be on ``sys.path``), run by
``tests/test_torch_mxnet.py``:

    python torch_mx_worker.py horovod_tpu OUT_DIR        # 4 device ranks
    python -m horovod_tpu_torch.run -np 4 python torch_mx_worker.py \\
        horovod_tpu_torch OUT_DIR                        # 4 gloo ranks

Inputs are made with numpy from the rank's seed and rounded to
multiples of 1/64, so that every sum over four ranks is exact in any
order; each rank's results go to ``OUT_DIR/rank<r>.npz``."""

import importlib
import os
import sys

import numpy as np

N = 4


def values(r, seed, shape):
    rng = np.random.RandomState(100 * seed + r)
    return (np.round(rng.randn(*shape) * 64) / 64).astype(np.float32)


def scenario(hvd, mx, r):
    res = {}
    n = hvd.size()
    assert n == N, n

    # -- the collectives ----------------------------------------------------
    t = mx.nd.array(values(r, 1, (4,)))
    out = hvd.allreduce(t, average=True, name="mx.avg")
    assert out.dtype == np.float32
    res["coll.avg"] = out.asnumpy()
    t = mx.nd.array(values(r, 2, (3,)))
    assert hvd.allreduce_(t, average=False, name="mx.sum") is t
    res["coll.sum_in_place"] = t.asnumpy()
    t = mx.nd.array(np.arange(5, dtype=np.int64) * (r + 1))
    res["coll.int_sum"] = hvd.allreduce(t, average=False,
                                        name="mx.int").asnumpy()
    res["coll.allgather"] = hvd.allgather(
        mx.nd.array(values(r, 3, (r + 1, 2))), name="mx.ag").asnumpy()
    b = mx.nd.array(values(r, 4, (3,)))
    hvd.broadcast_(b, root_rank=2, name="mx.bc")
    res["coll.broadcast_in_place"] = b.asnumpy()
    res["coll.alltoall"] = hvd.alltoall(
        mx.nd.array(values(r, 5, (N, 2))), name="mx.a2a").asnumpy()
    src = mx.nd.array(values(r, 6, (2,)))
    res["coll.broadcast"] = hvd.broadcast(src, root_rank=1,
                                          name="mx.bc2").asnumpy()
    res["coll.source_untouched"] = np.array_equal(src.asnumpy(),
                                                  values(r, 6, (2,)))

    # -- DistributedOptimizer: the sum and rescale_grad / size ------------
    opt = hvd.DistributedOptimizer(
        mx.optimizer.SGD(learning_rate=0.1, rescale_grad=1.0))
    w = mx.nd.array(values(0, 7, (4,)))
    opt.update(0, w, mx.nd.array(values(r, 8, (4,))), None)
    res["opt.index"] = w.asnumpy()
    ws = [mx.nd.array(values(0, 9 + i, (2, 3))) for i in range(3)]
    gs = [mx.nd.array(values(r, 12 + i, (2, 3))) for i in range(3)]
    opt.update_multi_precision((10, 11, 12), ws, gs, [None] * 3)
    for i, w_i in enumerate(ws):
        res[f"opt.tuple{i}"] = w_i.asnumpy()
    opt.set_learning_rate(0.2)
    res["opt.lr"] = opt.lr
    opt.set_lr_mult({})
    opt.set_wd_mult({})
    res["opt.state_none"] = opt.create_state_multi_precision(0, w) is None
    try:
        hvd.DistributedOptimizer(opt)
        res["opt.double_wrap"] = False
    except ValueError:
        res["opt.double_wrap"] = True

    # -- gluon DistributedTrainer -----------------------------------------
    params = [mx.gluon.Parameter(f"w{i}",
                                 data=mx.nd.array(values(0, 20 + i, (3,))))
              for i in range(3)]
    params[2].grad_req = "null"
    for i, p in enumerate(params):
        p.grad[:] = values(r, 30 + i, (3,))
    trainer = hvd.DistributedTrainer(
        params, mx.optimizer.SGD(learning_rate=0.5, rescale_grad=1.0))
    res["trainer.kvstore_none"] = trainer._kvstore is None
    trainer.step(batch_size=2)
    for i, p in enumerate(params):
        res[f"trainer.w{i}"] = p.data().asnumpy()
    # a parameter on two contexts has one gradient on each: every one is
    # summed across ranks on its own
    multi = [_TwoContexts(mx, f"m{i}", values(0, 50 + i, (3,)),
                          [values(r, 52 + 2 * i + j, (3,)) for j in range(2)])
             for i in range(2)]
    hvd.DistributedTrainer(
        multi, mx.optimizer.SGD(learning_rate=0.5))._allreduce_grads()
    for i, p in enumerate(multi):
        for j, g in enumerate(p.list_grad()):
            res[f"trainer.ctx{i}.{j}"] = g.asnumpy()
    try:
        hvd.DistributedTrainer(params, hvd.DistributedOptimizer(
            mx.optimizer.SGD(learning_rate=0.1)))
        res["trainer.double_wrap"] = False
    except ValueError:
        res["trainer.double_wrap"] = True

    # -- broadcast_parameters from rank 3, and the deferred parameter ------
    bparams = {
        "a": mx.nd.array(values(r, 40, (2,))),
        "b": mx.gluon.Parameter("b", data=mx.nd.array(values(r, 41, (2, 2)))),
        "deferred": mx.gluon.Parameter("deferred"),
    }
    hvd.broadcast_parameters(bparams, root_rank=3)
    res["bcast.a"] = bparams["a"].asnumpy()
    res["bcast.b"] = bparams["b"].data().asnumpy()
    # each rank initializes with its own values; the hook broadcasts
    # rank 3's at that moment
    bparams["deferred"].initialize(mx.nd.array(values(r, 42, (2,))))
    res["bcast.deferred"] = bparams["deferred"].data().asnumpy()
    try:
        hvd.broadcast_parameters([1, 2], root_rank=0)
        res["bcast.rejects_list"] = False
    except ValueError:
        res["bcast.rejects_list"] = True

    # the re-exported build probes (each package answers for its own)
    res["probes.mpi"] = hvd.mpi_built()
    res["probes.gloo"] = hvd.gloo_built()
    res["probes.threads"] = hvd.mpi_threads_supported()
    res["probes.homogeneous"] = hvd.is_homogeneous()
    return res


def _TwoContexts(mx, name, data, grads):
    """A gluon ``Parameter`` held on two contexts, as real gluon keeps a
    parameter initialized on two devices: one gradient each."""

    class Parameter(mx.gluon.Parameter):
        def list_grad(self):
            return self.grads

    p = Parameter(name, data=mx.nd.array(data))
    p.grads = [mx.nd.array(g) for g in grads]
    return p


def save(out, r, res):
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, f"rank{r}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})


def main():
    import mxnet as mx

    pkg, out = sys.argv[1], sys.argv[2]
    hvd = importlib.import_module(f"{pkg}.mxnet")
    if pkg == "horovod_tpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from horovod_tpu.common import basics

        hvd.init()
        for r, res in enumerate(basics.run_parallel(
                lambda r: scenario(hvd, mx, r), num_ranks=N)):
            save(out, r, res)
    else:
        hvd.init(device="cpu")
        save(out, hvd.rank(), scenario(hvd, mx, hvd.rank()))
    print("MX_WORKER_OK", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
