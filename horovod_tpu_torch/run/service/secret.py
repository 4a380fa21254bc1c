"""The job key and message signing (port of
``horovod_tpu/run/service/secret.py``; reference:
``horovod/run/common/util/secret.py``): an HMAC key minted by the
launcher and passed to the ranks through ``HVD_SECRET_KEY``, so that
only processes of this job can place bytes before each other's
unpickler."""

import hashlib
import hmac
import os

DIGEST_LEN = 32  # sha256


def make_secret_key() -> bytes:
    return os.urandom(32)


def sign(key: bytes, payload: bytes) -> bytes:
    return hmac.new(key, payload, hashlib.sha256).digest()


def check(key: bytes, payload: bytes, digest: bytes) -> bool:
    return hmac.compare_digest(sign(key, payload), digest)


def sign_parts(key: bytes, *parts) -> bytes:
    """HMAC over the concatenation of ``parts`` without joining them."""
    mac = hmac.new(key, digestmod=hashlib.sha256)
    for part in parts:
        mac.update(part)
    return mac.digest()


def check_parts(key: bytes, digest: bytes, *parts) -> bool:
    return hmac.compare_digest(sign_parts(key, *parts), digest)
