"""The port's input pipeline (``horovod_tpu_torch/utils/data.py``)
against the JAX package's (``horovod_tpu/utils/data.py``).

``BatchIterator`` gives the JAX iterator's batches bit for bit over
epochs (shuffled or not, tail kept or dropped, dict, tuple and single
array shards), and raises its errors.  ``prefetch_to_device`` is held to
``tests/test_data.py``'s cases on ``device="cpu"``: the values, the
source's errors at ``next()``, an early close that stops the producer
and releases every staged batch, and the argument checks; without a
card its default device raises rather than fall back to the CPU.  The
card's path (pinned memory, a side stream, the consumer's wait) runs in
``chip_smoke.py`` phase 11 (d).
"""

import time
import weakref

import numpy as np
import pytest
import torch

from horovod_tpu.utils import data as jdata

from horovod_tpu_torch.utils import data


def _shard(rows=20, feat=3):
    return {"x": np.arange(rows * feat, dtype=np.float32)
                   .reshape(rows, feat),
            "y": np.arange(rows, dtype=np.int32)}


def _structure(kind, rows):
    s = _shard(rows)
    if kind == "tuple":
        return (s["x"], s["y"])
    if kind == "array":
        return s["x"]
    return s


def _leaves(batch):
    if isinstance(batch, dict):
        return [batch[k] for k in sorted(batch)]
    if isinstance(batch, (tuple, list)):
        return list(batch)
    return [batch]


@pytest.mark.parametrize("kind", ["dict", "tuple", "array"])
@pytest.mark.parametrize("shuffle,drop", [(False, True), (True, True),
                                          (True, False), (False, False)])
def test_batches_are_the_jax_iterators(kind, shuffle, drop):
    src = _structure(kind, 22)
    kw = dict(shuffle=shuffle, seed=5, drop_remainder=drop, epochs=3)
    got = list(data.BatchIterator(src, 4, **kw))
    want = list(jdata.BatchIterator(src, 4, **kw))
    assert len(got) == len(want) == 3 * (5 if drop else 6)
    for g, w in zip(got, want):
        assert type(g) is type(w)
        for a, b in zip(_leaves(g), _leaves(w)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    it = data.BatchIterator(src, 4, **kw)
    assert it.batches_per_epoch == \
        jdata.BatchIterator(src, 4, **kw).batches_per_epoch


def test_tensor_shards_batch_as_numpy_ones():
    s = _shard(16)
    got = list(data.BatchIterator({k: torch.from_numpy(v)
                                   for k, v in s.items()}, 4, shuffle=True))
    want = list(jdata.BatchIterator(s, 4, shuffle=True))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["x"].numpy(), w["x"])


def test_infinite_epochs_and_validation_errors():
    it = iter(data.BatchIterator(_shard(4), 2, epochs=None))
    for _ in range(10):
        next(it)
    for args, match in [((_shard(4), 0), "batch_size"),
                        ((_shard(2), 4), "drop_remainder"),
                        (({"x": np.zeros(3), "y": np.zeros(4)}, 1), "ragged"),
                        (({}, 1), "empty")]:
        with pytest.raises(ValueError, match=match) as got:
            data.BatchIterator(*args)
        with pytest.raises(ValueError) as want:
            jdata.BatchIterator(*args)
        assert str(got.value) == str(want.value)


# -------------------------------------------------------- device prefetch
def test_prefetch_values_match():
    host = list(data.BatchIterator(_shard(16), 4))
    dev = list(data.prefetch_to_device(
        iter(data.BatchIterator(_shard(16), 4)), size=2, device="cpu"))
    assert len(dev) == len(host)
    for h, d in zip(host, dev):
        assert torch.is_tensor(d["x"]) and d["x"].device.type == "cpu"
        np.testing.assert_array_equal(d["x"].numpy(), h["x"])
        np.testing.assert_array_equal(d["y"].numpy(), h["y"])
        # a copy: the loop may not write into the source's memory
        assert not np.shares_memory(d["x"].numpy(), h["x"])


def test_prefetch_propagates_source_errors():
    def bad():
        yield {"x": np.zeros((2, 2)), "y": np.zeros(2)}
        raise RuntimeError("loader died")

    it = data.prefetch_to_device(bad(), size=1, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="loader died"):
        next(it)


def test_prefetch_early_close_releases_producer():
    produced = []

    def src():
        for i in range(100):
            produced.append(i)
            yield {"x": np.full((2, 2), i)}

    it = data.prefetch_to_device(src(), size=1, device="cpu")
    next(it)
    it.close()
    time.sleep(0.5)
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n, "producer kept running after close"
    assert n < 100


def test_prefetch_close_releases_all_staged_batches(monkeypatch):
    refs = []
    real = torch.Tensor.to

    def tracking_to(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        refs.append(weakref.ref(out))
        return out

    monkeypatch.setattr(torch.Tensor, "to", tracking_to)

    def src():
        for i in range(10):
            yield np.full((4,), i, np.float32)

    it = data.prefetch_to_device(src(), size=2, device="cpu")
    first = next(it)
    it.close()
    del first
    deadline = time.time() + 3.0
    while any(r() is not None for r in refs) and time.time() < deadline:
        time.sleep(0.05)
    alive = sum(r() is not None for r in refs)
    assert refs and alive == 0, f"{alive} staged batches still pinned"
    assert it is not None


def test_prefetch_rejects_bad_args():
    with pytest.raises(ValueError, match="size") as got:
        data.prefetch_to_device(iter([]), size=0, device="cpu")
    with pytest.raises(ValueError) as want:
        jdata.prefetch_to_device(iter([]), size=0)
    assert str(got.value) == str(want.value)


def test_prefetch_defaults_to_the_card(monkeypatch):
    """No silent CPU: the default device is the job's, else the card,
    and asking for the card without one raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data.prefetch_to_device(iter([]))
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        out = list(data.prefetch_to_device(iter([np.ones(3)])))
        assert out[0].device == hvd.device()
    finally:
        hvd.shutdown()
