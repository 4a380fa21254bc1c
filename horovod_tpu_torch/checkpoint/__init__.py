"""Durable sharded checkpointing with resume (port of
``horovod_tpu/checkpoint/__init__.py``).

Surface::

    hvd.checkpoint.CheckpointManager(dir, interval_steps, keep)
    hvd.checkpoint.manager_from_env()   # None when HVD_TPU_CKPT_DIR is unset

``elastic.run`` attaches a manager when the checkpoint directory is set.
"""

from horovod_tpu_torch.checkpoint import store
from horovod_tpu_torch.checkpoint.manager import CheckpointManager
from horovod_tpu_torch.utils import env as env_util

__all__ = ["CheckpointManager", "manager_from_env", "store"]


def manager_from_env():
    """A :class:`CheckpointManager` over ``HVD_TPU_CKPT_DIR`` (every
    ``HVD_TPU_CKPT_INTERVAL`` commits, default 10, keeping
    ``HVD_TPU_CKPT_KEEP`` checkpoints, default 2), or None when the
    directory is unset."""
    directory = env_util.get_str(env_util.HVD_TPU_CKPT_DIR)
    if not directory:
        return None
    interval = max(1, env_util.get_int(env_util.HVD_TPU_CKPT_INTERVAL,
                                       env_util.DEFAULT_CKPT_INTERVAL_STEPS))
    keep = max(0, env_util.get_int(env_util.HVD_TPU_CKPT_KEEP,
                                   env_util.DEFAULT_CKPT_KEEP))
    return CheckpointManager(directory, interval_steps=interval, keep=keep)
