"""Durable checkpoint file formats (port of
``horovod_tpu/checkpoint/store.py``; the same names, sidecars and rules,
so that each package reads the other's pickle shards).

On-disk layout inside ``HVD_TPU_CKPT_DIR``::

    s{step:012d}-e{epoch}-w{world}-r{rank}.shard       one per rank
    s{step:012d}-e{epoch}-w{world}-r{rank}.shard.meta.json   sha256, size, codec
    manifest-s{step:012d}-e{epoch}-w{world}.json       rank 0, written last

Every file is written tmp + ``os.replace`` (atomic on POSIX), and the
meta sidecar lands after its shard, so a digest only ever describes a
fully renamed shard.  Completeness is a read-time property: a manifest
is usable when all ``world`` shards exist and every shard's bytes hash
to its recorded digest.  A job killed mid-write leaves a manifest that
fails validation, and the reader falls back to the previous complete
one.

The payload codec is the reference's ``pickle``, recorded in each meta
sidecar.  The reference writes flax ``msgpack`` where flax is installed;
the port has no flax, so it refuses a shard of any other codec (or of
none recorded) with an error that names it, rather than guess.
"""

import hashlib
import json
import os
import pickle
import re

_SHARD_RE = re.compile(
    r"^s(\d{12})-e(\d+)-w(\d+)-r(\d+)\.shard$")
_MANIFEST_RE = re.compile(
    r"^manifest-s(\d{12})-e(\d+)-w(\d+)\.json$")

MANIFEST_FORMAT = 1
CODEC = "pickle"


class CorruptShardError(RuntimeError):
    """A shard (or its meta sidecar) is missing, truncated, fails its
    digest or cannot be decoded: the enclosing manifest is incomplete."""


def shard_name(step, epoch, world, rank) -> str:
    return f"s{step:012d}-e{epoch}-w{world}-r{rank}.shard"


def manifest_name(step, epoch, world) -> str:
    return f"manifest-s{step:012d}-e{epoch}-w{world}.json"


def _atomic_write(path, data: bytes):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_shard(directory, step, epoch, world, rank, payload: dict):
    """Serialize ``payload`` (numpy arrays and Python values) into this
    rank's shard and its meta sidecar.  -> the shard's file name."""
    blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    name = shard_name(step, epoch, world, rank)
    path = os.path.join(directory, name)
    _atomic_write(path, blob)
    meta = {"sha256": hashlib.sha256(blob).hexdigest(),
            "bytes": len(blob), "codec": CODEC}
    _atomic_write(f"{path}.meta.json", json.dumps(meta).encode())
    return name


def read_shard(directory, step, epoch, world, rank) -> dict:
    """Load and digest-verify one shard; :class:`CorruptShardError` on
    any missing, torn, forged or foreign piece."""
    name = shard_name(step, epoch, world, rank)
    path = os.path.join(directory, name)
    try:
        with open(f"{path}.meta.json", "rb") as f:
            meta = json.loads(f.read().decode())
        with open(path, "rb") as f:
            blob = f.read()
        # a torn write can leave valid json of the wrong shape
        if not isinstance(meta, dict):
            raise CorruptShardError(
                f"{name}: meta sidecar is {type(meta).__name__}, "
                f"expected object")
        recorded = int(meta.get("bytes", -1))
    except CorruptShardError:
        raise
    except (OSError, ValueError, TypeError) as exc:
        raise CorruptShardError(f"{name}: {exc}") from exc
    if len(blob) != recorded:
        raise CorruptShardError(
            f"{name}: {len(blob)} bytes on disk, meta records "
            f"{meta.get('bytes')}")
    if hashlib.sha256(blob).hexdigest() != meta.get("sha256"):
        raise CorruptShardError(f"{name}: sha256 mismatch")
    codec = meta.get("codec")
    if codec != CODEC:
        raise CorruptShardError(
            f"{name}: codec {codec!r} cannot be read here (only "
            f"{CODEC!r}; flax msgpack is not ported)")
    try:
        # wire-safe: not wire input — a local checkpoint file this job
        # (or a prior incarnation of it) wrote, sha256-verified against
        # its meta sidecar before it reaches the unpickler
        return pickle.loads(blob)
    except Exception as exc:  # noqa: BLE001 — an undecodable payload
        raise CorruptShardError(f"{name}: undecodable: {exc}") from exc


def write_manifest(directory, step, epoch, world, extra=None):
    body = {"format": MANIFEST_FORMAT, "step": int(step),
            "epoch": int(epoch), "world_size": int(world)}
    body.update(extra or {})
    _atomic_write(os.path.join(directory, manifest_name(step, epoch, world)),
                  json.dumps(body).encode())


def read_manifest(directory, step, epoch, world) -> dict:
    """One manifest's body; ``ValueError`` (the restore walk's "try the
    previous one") for torn json or json of the wrong shape."""
    name = manifest_name(step, epoch, world)
    with open(os.path.join(directory, name), "rb") as f:
        try:
            body = json.loads(f.read().decode())
        except (ValueError, UnicodeDecodeError) as exc:
            raise ValueError(f"{name}: {exc}") from exc
    if not isinstance(body, dict):
        raise ValueError(
            f"{name}: manifest body is {type(body).__name__}, "
            f"expected object")
    return body


def _keys(directory, pattern):
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return [m for m in map(pattern.match, names) if m]


def list_manifests(directory):
    """Every manifest, newest (step, epoch) first: ``[(step, epoch,
    world), ...]``."""
    return sorted(((int(m.group(1)), int(m.group(2)), int(m.group(3)))
                   for m in _keys(directory, _MANIFEST_RE)), reverse=True)


def list_own_shards(directory, rank):
    """This rank's shard keys, newest first: ``[(step, epoch, world)]``."""
    return sorted(((int(m.group(1)), int(m.group(2)), int(m.group(3)))
                   for m in _keys(directory, _SHARD_RE)
                   if int(m.group(4)) == rank), reverse=True)


def remove_shard(directory, step, epoch, world, rank):
    path = os.path.join(directory, shard_name(step, epoch, world, rank))
    for p in (path, f"{path}.meta.json"):
        try:
            os.remove(p)
        except OSError:
            pass


def remove_manifest(directory, step, epoch, world):
    try:
        os.remove(os.path.join(directory, manifest_name(step, epoch, world)))
    except OSError:
        pass
