"""The port's block-scaled int8 compression
(``horovod_tpu_torch/common/compression.py``) against the JAX package's
(``horovod_tpu/common/compression.py``).

- The quantizer and the dequantizer are bitwise equal to the JAX ones on
  inputs made with numpy from seeds, with zero blocks, ties at .5, +-max
  and sub-block tails; ``Int8Compressor.compress`` too.
- ``resolve_compression``, ``compressor_for`` and ``HVD_TPU_COMPRESSION``
  have the reference's surface (``tests/test_compression.py``).
- On 2 and 4 gloo ranks (subprocesses, rendezvous through a
  ``FileStore``), ``quantized_allreduce``, ``quantized_reduce_scatter``
  and ``quantized_all_gather`` match the JAX functions run under
  ``shard_map`` on as many CPU devices: within 1e-6 of each element's
  block max (the two sides accumulate in the same order, with the same
  fused multiply-adds, so they are in fact equal), and within the error
  bound of the fp32 sum, ``(n + 1) * blockmax / 254``.  One block has
  the same scale on every rank, so that every odd sum of its values is a
  tie when the reduced block is requantized: a sum rounded differently
  rounds the other way there.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu.common import compression as jc
from horovod_tpu.parallel import make_mesh
from horovod_tpu.parallel._compat import shard_map_unchecked

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import compression as tc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = tc.INT8_BLOCK


def _inputs(seed, n_blocks=12):
    """Blocks of every kind the quantizer meets: gaussian at several
    scales, all zero, exact ties at .5 of a step (block max 127, so the
    scale is 1.0), +-max, a lone outlier, tiny values."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n_blocks, B) * rng.choice([1e-3, 1.0, 50.0],
                                             (n_blocks, 1))).astype(np.float32)
    x[1] = 0.0
    x[2] = np.tile([127.0, -127.0, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5], B // 8)
    x[3, :] = rng.randn(B)
    x[3, 7], x[3, 8] = 3.0, -3.0                      # +-max of the block
    x[4, :] = 1e-3
    x[4, 100] = 1e4                                    # one outlier
    x[5] = rng.randn(B).astype(np.float32) * 1e-30     # tiny, normal
    return x.reshape(-1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(12 * B,), (3, 4 * B), (2, 3, 2 * B)])
def test_quantize_and_dequantize_are_bitwise_the_references(seed, shape):
    x = _inputs(seed).reshape(shape)
    q, s = tc.quantize_int8_blocks(_t(x))
    jq, js = jc.quantize_int8_blocks(_j(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = tc.dequantize_int8_blocks(q, s)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jc.dequantize_int8_blocks(jq, js)))


def test_quantizer_rounds_ties_to_even_and_keeps_zero_blocks_exact():
    x = _inputs(0)
    q, s = tc.quantize_int8_blocks(_t(x))
    assert float(s[1]) == 1.0 and not q[B:2 * B].any()
    ties = q[2 * B:2 * B + 8].tolist()
    assert ties == [127, -127, 0, 0, 2, -2, 2, -2]
    assert q[3 * B + 7] == 127 and q[3 * B + 8] == -127


@pytest.mark.parametrize("size", [1, 255, 256, 257, 1000, 12 * B])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_compressor_round_trip_is_the_references(size, dtype):
    x = _inputs(size)[:size]
    got, ctx = tc.Int8Compressor.compress(_t(x).to(getattr(torch, dtype)))
    want, _ = jc.Int8Compressor.compress(_j(x).astype(getattr(jnp, dtype)))
    assert ctx is None and tc.Int8Compressor.decompress(got, ctx) is got
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


def test_int8_compressor_passes_integers_through():
    x = torch.arange(1000, dtype=torch.int32)
    got, _ = tc.Int8Compressor.compress(x)
    assert got is x


def test_resolve_compression_surface():
    assert tc.resolve_compression(None, default="int8") == "int8"
    assert tc.resolve_compression("BF16") == "bf16"
    assert tc.resolve_compression(tc.Compression.int8) == "int8"
    assert tc.resolve_compression(tc.Compression.none) == "none"
    assert tc.resolve_compression(tc.Int8Compressor()) == "int8"
    assert tc.compressor_for("int8") is tc.Int8Compressor
    assert tc.Compression.int8.block_quantized
    assert sorted(tc.COMPRESSION_NAMES) == sorted(jc.COMPRESSION_NAMES)
    for bad in ("zstd", object()):
        with pytest.raises(ValueError):
            tc.resolve_compression(bad)
        with pytest.raises(ValueError):
            jc.resolve_compression(bad)


def test_hvd_tpu_compression_env(monkeypatch):
    monkeypatch.setenv("HVD_TPU_COMPRESSION", "int8")
    assert basics.default_compression() == "int8"
    monkeypatch.setenv("HVD_TPU_COMPRESSION", "bogus")
    with pytest.raises(ValueError):
        basics.default_compression()
    monkeypatch.delenv("HVD_TPU_COMPRESSION")
    assert basics.default_compression() == "none"


def test_hvd_tpu_compression_is_the_default_of_every_reduction(monkeypatch):
    """At one rank the eager plane resolves int8 to the exact wire
    (``xla_executor.py:232``); the request still carries the default."""
    monkeypatch.setenv("HVD_TPU_COMPRESSION", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()
    monkeypatch.setenv("HVD_TPU_COMPRESSION", "int8")
    hvd.init(device="cpu")
    try:
        from horovod_tpu_torch.ops import eager
        assert basics._get_state().compression == "int8"
        req = eager._request(0, torch.ones(300), "x")
        assert req.sig.compression == "int8"
        req = eager._request(0, torch.ones(300), "x", compression="none")
        assert req.sig.compression == "none"
        x = torch.from_numpy(_inputs(3))
        assert torch.equal(hvd.allreduce(x, op=hvd.Sum), x)
        ex = basics._get_state().controller._executor
        assert ex.wires["none"] >= 1 and ex.wires["int8"] == 0
    finally:
        hvd.shutdown()


# ------------------------------------------------ multi-rank collectives
WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import compression as tc

    data_path, store_path, out_path = sys.argv[1:4]
    data = np.load(data_path)
    torch.set_num_threads(1)
    hvd.init(device="cpu", store_path=store_path)
    try:
        r = hvd.rank()
        out = {}
        for k in data.files:
            x = torch.from_numpy(data[k][r])
            if k.startswith("ar"):
                out[k] = tc.quantized_allreduce(x)
            elif k.startswith("rs"):
                out[k] = tc.quantized_reduce_scatter(x)
            else:
                out[k] = tc.quantized_all_gather(x)
        np.savez(out_path, **{k: v.numpy() for k, v in out.items()})
    finally:
        hvd.shutdown()
""")


def _jax_collectives(data, n):
    mesh = make_mesh({"hvd": n}, devices=jax.devices()[:n])
    fns = {"ar": lambda x: jc.quantized_allreduce(x[0], "hvd")[None],
           "rs": lambda x: jc.quantized_reduce_scatter(x[0], "hvd")[None],
           "ag": lambda x: jc.quantized_all_gather(x[0], "hvd")[None]}
    out = {}
    for k, v in data.items():
        fn = jax.jit(shard_map_unchecked(fns[k[:2]], mesh=mesh,
                                         in_specs=P("hvd"),
                                         out_specs=P("hvd")))
        out[k] = np.asarray(fn(jnp.asarray(v)))
    return out


def _block_max(a):
    """Each element's block max (blocks of 256 from the start)."""
    flat = np.abs(a.reshape(-1))
    pad = -flat.size % B
    blocks = np.pad(flat, (0, pad)).reshape(-1, B).max(axis=1)
    return np.repeat(blocks, B)[:flat.size].reshape(a.shape)


def _exact(k, v, n):
    """The fp32 result each rank should approximate, and the inputs whose
    block maxima bound its error."""
    if k.startswith("ag"):
        return [v.reshape(-1)] * n
    total = v.astype(np.float64).sum(axis=0)
    if k.startswith("rs"):
        return [total[r] for r in range(n)]
    return [total] * n


@pytest.mark.parametrize("n", [2, 4])
def test_quantized_collectives_match_jax_shard_map(tmp_path, n):
    rng = np.random.RandomState(40 + n)
    data = {
        # sub-block tail: 1000 elements pad to n chunks of whole blocks
        "ar_tail": np.stack([_inputs(10 * n + r)[:1000]
                             for r in range(n)]),
        "ar_full": np.stack([_inputs(20 * n + r) for r in range(n)]),
        "rs": np.stack([_inputs(30 * n + r)[:n * 2 * B].reshape(n, 2 * B)
                        for r in range(n)]),
        # contributions of opposite signs cancel in the sum
        "rs_cancel": np.stack([(1 if r % 2 else -1)
                               * _inputs(50)[:n * B].reshape(n, B)
                               + rng.randn(n, B).astype(np.float32) * 1e-2
                               for r in range(n)]),
        "ag": np.stack([_inputs(40 * n + r)[:3 * B] for r in range(n)]),
    }
    data = {k: v.astype(np.float32) for k, v in data.items()}
    np.savez(tmp_path / "data.npz", **data)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = []
    try:
        for r in range(n):
            env = dict(os.environ, HVD_RANK=str(r), HVD_SIZE=str(n),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(tmp_path / "data.npz"),
                 str(tmp_path / "store"), str(tmp_path / f"out{r}.npz")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for p in procs:
            out, _ = p.communicate(timeout=60)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = [np.load(tmp_path / f"out{r}.npz") for r in range(n)]
    want = _jax_collectives(data, n)
    for k, v in data.items():
        exact = _exact(k, v, n)
        for r in range(n):
            got, ref = ranks[r][k], want[k][r]
            assert got.dtype == np.float32 and got.shape == ref.shape, k
            tol = 1e-6 * _block_max(ref) + 1e-30
            bad = np.flatnonzero(np.abs(got - ref) > tol)
            assert bad.size == 0, (k, r, bad[:8])
            if k.startswith("ag"):
                # one quantization of each rank's chunk
                bound = _block_max(exact[r]) / 254 * 1.0001
            else:
                # each contribution's quantization and the result's
                inputs = v[:, r] if k.startswith("rs") else v
                blockmax = np.maximum(
                    np.max([_block_max(c) for c in inputs], axis=0),
                    _block_max(exact[r].astype(np.float32)))
                bound = (n + 1) * blockmax / 254 * 1.0001
            err = np.abs(got.astype(np.float64) - exact[r])
            assert np.all(err <= bound), (k, r, float((err - bound).max()))
