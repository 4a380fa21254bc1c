"""The port stands alone: ``horovod_tpu_torch``, ``chip_smoke.py``,
``chip_negotiation_ab.py`` and ``chip_abort_diag.py`` import neither JAX
nor the JAX package, the card is the default device,
and no entry point falls back to the CPU when asked for the card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "horovod_tpu", "horovod"}


def _port_files():
    files = sorted((REPO / "horovod_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py", REPO / "chip_negotiation_ab.py",
                    REPO / "chip_abort_diag.py"]


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "HVD_"))}
    env["PYTHONPATH"] = str(REPO)
    return env


def test_import_leaves_jax_and_horovod_tpu_out():
    # the TensorFlow and Keras bindings are not in this list: importing
    # TensorFlow imports jax (tensorflow/lite/python/util.py), so with
    # TensorFlow installed they cannot leave jax out; the test below
    # imports them without their frameworks
    code = (
        "import sys\n"
        "import horovod_tpu_torch, horovod_tpu_torch.models, "
        "horovod_tpu_torch.optimizer, horovod_tpu_torch.ops.cuda, "
        "horovod_tpu_torch.ops.cuda._build, horovod_tpu_torch.parallel, "
        "horovod_tpu_torch.ops.eager, horovod_tpu_torch.ops.controller, "
        "horovod_tpu_torch.ops.nccl_executor, horovod_tpu_torch.mpi_ops, "
        "horovod_tpu_torch.sync_batch_norm, "
        "horovod_tpu_torch.common.handles, "
        "horovod_tpu_torch.common.response_cache, "
        "horovod_tpu_torch.common.objects, "
        "horovod_tpu_torch.common.ops_enum, "
        "horovod_tpu_torch.common.compression, "
        "horovod_tpu_torch.models.layers, horovod_tpu_torch.models.resnet, "
        "horovod_tpu_torch.models.vgg, horovod_tpu_torch.models.inception, "
        "horovod_tpu_torch.models.mlp, horovod_tpu_torch.train_cnn, "
        "horovod_tpu_torch.sharding, horovod_tpu_torch.sharding.zero, "
        "horovod_tpu_torch.parallel._comm, "
        "horovod_tpu_torch.parallel.ring_attention, "
        "horovod_tpu_torch.parallel.zigzag_attention, "
        "horovod_tpu_torch.parallel.ulysses, horovod_tpu_torch.groups, "
        "horovod_tpu_torch.parallel.mesh, "
        "horovod_tpu_torch.parallel.tensor_parallel, "
        "horovod_tpu_torch.parallel.moe, horovod_tpu_torch.parallel.pipeline, "
        "horovod_tpu_torch.sharding.mesh_executor, "
        "horovod_tpu_torch.ops.adasum, horovod_tpu_torch.elastic, "
        "horovod_tpu_torch.elastic.state, "
        "horovod_tpu_torch.elastic.membership, "
        "horovod_tpu_torch.elastic.election, "
        "horovod_tpu_torch.common.drain, horovod_tpu_torch.common.busy, "
        "horovod_tpu_torch.common.rtt, horovod_tpu_torch.checkpoint, "
        "horovod_tpu_torch.checkpoint.store, "
        "horovod_tpu_torch.checkpoint.manager, "
        "horovod_tpu_torch.utils.checkpoint, horovod_tpu_torch.utils.data, "
        "horovod_tpu_torch.callbacks, horovod_tpu_torch.utils.logging, "
        "horovod_tpu_torch.common.topology, horovod_tpu_torch.common.config, "
        "horovod_tpu_torch.common.autotune, horovod_tpu_torch.ops.autotune, "
        "horovod_tpu_torch.utils.timeline, "
        "horovod_tpu_torch.run, horovod_tpu_torch.run.__main__, "
        "horovod_tpu_torch.run.runner, horovod_tpu_torch.run.launch, "
        "horovod_tpu_torch.run.api, horovod_tpu_torch.run.task_runner, "
        "horovod_tpu_torch.run.allocate, horovod_tpu_torch.run.config_parser, "
        "horovod_tpu_torch.run.http_server, horovod_tpu_torch.run.http_client, "
        "horovod_tpu_torch.run.safe_shell_exec, horovod_tpu_torch.run.cache, "
        "horovod_tpu_torch.run.host_hash, horovod_tpu_torch.run.ssh_check, "
        "horovod_tpu_torch.run.mpi_run, horovod_tpu_torch.run.js_run, "
        "horovod_tpu_torch.run.lsf, horovod_tpu_torch.run.service.secret, "
        "horovod_tpu_torch.run.service.network, "
        "horovod_tpu_torch.run.service.driver_service, "
        "horovod_tpu_torch.run.service.task_service, "
        "horovod_tpu_torch.run.service.task_main, "
        "horovod_tpu_torch.run.driver_discovery, "
        "horovod_tpu_torch.cluster, horovod_tpu_torch.cluster.store, "
        "horovod_tpu_torch.cluster.parquet_store, "
        "horovod_tpu_torch.cluster.backend, "
        "horovod_tpu_torch.cluster.torch_estimator, "
        "horovod_tpu_torch.spark, horovod_tpu_torch.spark.runner, "
        "horovod_tpu_torch.spark.backend, horovod_tpu_torch.spark.torch, "
        "horovod_tpu_torch.spark.keras, "
        "horovod_tpu_torch.cluster.keras_estimator, "
        "horovod_tpu_torch.common.arrays, "
        "horovod_tpu_torch.common.host_bridge, horovod_tpu_torch.mxnet\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_clean_env(),
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_the_cluster_layer_needs_neither_pyarrow_nor_pyspark():
    """``import horovod_tpu_torch.cluster`` and ``.spark`` succeed where
    neither package can be imported (the card's machine has neither);
    ``ParquetStore`` and ``spark.run`` then raise their ImportErrors."""
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\n"
        "sys.modules['pyspark'] = None\n"
        "import horovod_tpu_torch.cluster as cluster\n"
        "import horovod_tpu_torch.spark as spark\n"
        "for call, what in ((lambda: cluster.ParquetStore('x'), 'pyarrow'),"
        " (lambda: spark.run(print), 'PySpark')):\n"
        "    try:\n"
        "        call()\n"
        "        raise SystemExit('no ImportError')\n"
        "    except ImportError as exc:\n"
        "        assert what in str(exc), exc\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_clean_env(),
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_the_bindings_import_without_their_frameworks():
    """With ``tensorflow``, ``keras`` and ``mxnet`` refused by a
    ``sys.meta_path`` finder, the bindings and the Keras estimator
    import, jax stays out, and each binding's first use raises an
    ImportError naming its framework."""
    code = (
        "import sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('tensorflow', 'keras', 'mxnet'):\n"
        "            raise ImportError(f'{name} refused')\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import numpy as np\n"
        "import horovod_tpu_torch.tensorflow as hvd_tf\n"
        "import horovod_tpu_torch.tensorflow.compression as comp\n"
        "import horovod_tpu_torch.keras as hvd_keras\n"
        "import horovod_tpu_torch.mxnet as hvd_mx\n"
        "import horovod_tpu_torch.cluster.keras_estimator as ke\n"
        "for call, what in (\n"
        "        (lambda: hvd_tf.allreduce(np.ones(2)), 'TensorFlow'),\n"
        "        (lambda: hvd_tf.DistributedGradientTape(None), 'TensorFlow'),\n"
        "        (lambda: hvd_tf.BroadcastGlobalVariablesHook(0), 'TensorFlow'),\n"
        "        (lambda: comp.Compression.fp16.compress(None), 'TensorFlow'),\n"
        "        (lambda: hvd_keras.DistributedOptimizer(None), 'Keras'),\n"
        "        (lambda: hvd_keras.callbacks.MetricAverageCallback(), 'Keras'),\n"
        "        (lambda: hvd_mx.allreduce(None), 'MXNet'),\n"
        "        (lambda: hvd_mx.DistributedTrainer([], None), 'MXNet'),\n"
        "        (lambda: ke.KerasEstimator(None).fit(np.ones((4, 2)),\n"
        "                                             np.ones(4)), 'Keras')):\n"
        "    try:\n"
        "        call()\n"
        "        raise SystemExit(f'no ImportError for {what}')\n"
        "    except ImportError as exc:\n"
        "        assert what in str(exc), exc\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN | {'tensorflow', 'keras', 'mxnet'})!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_clean_env(),
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_file_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names = [node.args[0].value]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.relative_to(REPO)}:{node.lineno} imports {name}")


def test_asking_for_the_card_without_one_raises(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.basics import resolve_device
    from horovod_tpu_torch.models import Transformer, TransformerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        hvd.init()
    assert not hvd.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        Transformer(TransformerConfig(vocab_size=16, n_layers=1, d_model=8,
                                      n_heads=2, d_ff=16, max_len=4))
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", ["ResNet18", "ResNet50", "VGG16",
                                  "InceptionV3", "MLP"])
def test_cnn_models_ask_for_the_card(monkeypatch, name):
    """The CNN models are built on the card unless asked for the CPU."""
    from horovod_tpu_torch import models

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (4,) if name == "MLP" else ()
    kw = dict(image=32, classifier_width=8) if name == "VGG16" else {}
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        getattr(models, name)(*args, **kw)
    m = getattr(models, name)(*args, device="cpu", **kw)
    assert all(p.device.type == "cpu" for p in m.parameters())


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from horovod_tpu_torch.ops.cuda import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_key_covers_sources_and_flags():
    from horovod_tpu_torch.ops.cuda import _build

    names = [p.name for p in _build.sources()]
    assert names == ["flash_attention.cu", "layer_norm.cu",
                     "softmax_xent.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert len(_build._digest()) == 16


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """No card, or no repository around the script: a non-zero exit and
    no result line."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "alone":
        cwd = tmp_path
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = _clean_env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
