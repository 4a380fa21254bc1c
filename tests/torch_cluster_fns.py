"""Model factories and functions that the cluster tests
(``tests/test_torch_cluster.py``, ``test_torch_parquet.py``,
``test_torch_spark.py``) hand to estimators and to ``run(fn)``'s
workers.  Plain pickle sends them by module reference, so each worker
imports this module: it imports nothing of JAX."""

import numpy as np
import torch


def mlp_factory():
    """The plain module both packages' ``TorchEstimator`` fit: the same
    weights in every process (the seed is its own)."""
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                               torch.nn.Linear(16, 3))


def linear_data(n=64, din=8, dout=3, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(din, dout).astype(np.float32)
    x = rng.randn(n, din).astype(np.float32)
    return x, (x @ w).astype(np.float32)


# the small LM of the JaxEstimator comparison
LM = dict(vocab_size=64, n_layers=2, d_model=64, n_heads=2, d_ff=128,
          max_len=16)


def lm_factory(state_path):
    """The port's small transformer on the CPU, in fp32, with the
    weights at ``state_path`` (the JAX model's, ``params_from_flax``)."""
    from horovod_tpu_torch.models import Transformer, TransformerConfig

    model = Transformer(TransformerConfig(dtype=torch.float32, **LM),
                        device="cpu")
    model.load_state_dict(torch.load(state_path, weights_only=True))
    return model


def lm_tokens(rows=32, seed=3):
    return np.random.RandomState(seed).randint(
        0, LM["vocab_size"], (rows, LM["max_len"])).astype(np.int32)


def rank_and_world(rank, a, b=0):
    """A Backend's function: ``(rank, the world's size, a + b)``."""
    from horovod_tpu_torch.common import basics

    return rank, basics.size(), a + b
