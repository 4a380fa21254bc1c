"""Pickled-object broadcast over the eager plane (port of
``horovod_tpu/common/objects.py``; reference:
``horovod/torch/__init__.py:608`` broadcast_object: pickle to a byte
tensor, broadcast the length, then the payload).

The root signs the pickle with the job key (``basics.job_key``) and
every rank checks the digest before it unpickles: gloo and NCCL carry no
authentication, and the reference unpickles only bytes that came
through its HMAC-verified frames (``horovod_tpu/common/objects.py``)."""

import pickle

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops import eager
from horovod_tpu_torch.run.service import secret


def broadcast_object(obj, root_rank=0, name=None):
    """Broadcast a picklable object from ``root_rank``; every rank calls
    it.  Two eager broadcasts on ``hvd.device()``: the payload's length as
    two non-negative int32 halves (31 bits each), then the uint8
    payload."""
    name = name or "bcast_object"
    dev = basics.device()
    key = basics._get_state().key
    if basics.rank() == root_rank:
        data = pickle.dumps(obj)
        data = secret.sign(key, data) + data
        payload = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
        length = torch.tensor([len(data) & 0x7FFFFFFF, len(data) >> 31],
                              dtype=torch.int32, device=dev)
    else:
        payload = None
        length = torch.zeros(2, dtype=torch.int32, device=dev)
    length = eager.wait(eager.broadcast_async(
        length, root_rank, name=f"{name}.len")).tolist()
    if payload is None:
        payload = torch.zeros((length[1] << 31) | length[0],
                              dtype=torch.uint8, device=dev)
    out = eager.wait(eager.broadcast_async(payload, root_rank,
                                          name=f"{name}.data"))
    blob = out.cpu().numpy().tobytes()
    digest, data = blob[:secret.DIGEST_LEN], blob[secret.DIGEST_LEN:]
    if not secret.check(key, data, digest):
        raise PermissionError(
            f"broadcast_object '{name}' from root rank {root_rank} failed "
            f"HMAC verification on rank {basics.rank()}: the ranks' job "
            f"keys differ (HVD_SECRET_KEY)")
    return pickle.loads(data)
