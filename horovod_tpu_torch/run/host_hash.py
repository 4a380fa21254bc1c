"""Host identity (port of ``horovod_tpu/run/host_hash.py``; reference: ``horovod/run/util/host_hash.py``): ranks
sharing a host_hash share local (fast-interconnect) topology.  The hash
folds in an optional salt (``HVD_HOSTNAME_HASH_SALT``) so containerized
deployments where every container reports the same hostname can force
distinct identities."""

import hashlib
import socket

from horovod_tpu_torch.utils import env as env_util


def host_hash(salt=None) -> str:
    hostname = socket.gethostname()
    if salt is None:
        salt = env_util.get_str(env_util.HVD_HOSTNAME_HASH_SALT, "")
    digest = hashlib.md5(f"{hostname}-{salt}".encode()).hexdigest()
    return f"{hostname.split('.')[0]}-{digest[:8]}"
