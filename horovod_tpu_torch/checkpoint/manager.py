"""Background sharded checkpoint writer and resume (port of
``horovod_tpu/checkpoint/manager.py``).

Layered on :class:`horovod_tpu_torch.elastic.State`: ``State.commit()``
already takes a snapshot on the host (``_committed``: copies of the
parameters and of the optimizer's ``state_dict()``, the full gathered
state under eager ZeRO), which it refuses once the job has aborted, so
that a snapshot taken across the abort, whose update may hold a partly
reduced gradient, never reaches the disk.  ``maybe_save`` hands that
snapshot to a writer thread, so training overlaps the checkpoint's I/O;
its queue is depth-1 latest-wins: under a slow disk intermediate
snapshots are skipped rather than queued.

Per (step, epoch, world) checkpoint:

- every rank writes its block (``sharding.zero.flat_shard``, the eager
  ZeRO row partition) of the flat parameter vector (every parameter and
  buffer of the ``state_dict``, in its order, in the wider of fp32 and
  their dtypes) and, when the optimizer snapshot is in full form, its
  block of every 1-D optimizer tensor of the parameters' length;
- rank 0 also writes the other optimizer tensors and the optimizer
  state's layout (the ``state_dict`` with each tensor replaced by its
  index and dtype), and, last, the manifest.

A torch optimizer makes its state at its first step, so a fresh one has
none to compare with: the layout travels in the checkpoint (the
reference checks the leaf count against the live tree instead), and
``load_state_dict`` rejects a layout that does not fit the optimizer.

Resume (:meth:`CheckpointManager.restore_latest`, rank 0 at
``elastic.run``'s entry) walks the manifests newest first, verifies
every shard's digest, re-assembles the state at the world size it was
written at and installs it as the State's committed snapshot;
``State.restore()`` and the first ``sync()`` then re-shard it to the
current world size.
"""

import logging
import os
import threading
import time

import numpy as np
import torch

from horovod_tpu_torch.checkpoint import store
from horovod_tpu_torch.common import busy
from horovod_tpu_torch.sharding.zero import flat_shard

_log = logging.getLogger("horovod_tpu_torch")
_LEAF = "__hvd_leaf__"


def _flatten_params(params):
    """(the flat parameter vector as numpy, its length) of a committed
    ``{name: tensor}``; None -> (None, 0)."""
    if params is None:
        return None, 0
    tensors = list(params.values())
    dtype = torch.float32
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    return flat.numpy(), int(flat.numel())


def _unflatten_params(flat, live):
    """``{name: tensor}`` shaped and typed as ``live`` from a flat
    vector."""
    out, offset = {}, 0
    for name, t in live.items():
        piece = flat[offset:offset + t.numel()]
        out[name] = torch.from_numpy(np.array(piece)).view(t.shape).to(
            t.dtype)
        offset += t.numel()
    return out


def _split(tree, leaves):
    """``tree`` with every tensor replaced by a marker of its index into
    ``leaves`` (which receives the tensor) and its dtype."""
    if isinstance(tree, dict):
        return {k: _split(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split(v, leaves) for v in tree)
    if torch.is_tensor(tree):
        leaves.append(tree)
        return {_LEAF: len(leaves) - 1,
                "dtype": str(tree.dtype).replace("torch.", "")}
    return tree


def _join(tree, leaves):
    if isinstance(tree, dict):
        if _LEAF in tree:
            return leaves[tree[_LEAF]].to(getattr(torch, tree["dtype"]))
        return {k: _join(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_join(v, leaves) for v in tree)
    return tree


def _to_numpy(t):
    """numpy has no bfloat16: floating tensors narrower than fp32 travel
    as fp32 (exactly) and are cast back on restore."""
    if t.dtype.is_floating_point and t.element_size() < 4:
        t = t.float()
    return t.numpy()


class CheckpointManager:
    """One a process; owns the writer thread and the resume logic."""

    def __init__(self, directory, interval_steps=1, keep=2):
        self._dir = directory
        self._interval = max(1, int(interval_steps))
        self._keep = max(0, int(keep))   # 0: keep everything
        os.makedirs(directory, exist_ok=True)
        self._cond = threading.Condition()
        self._snapshot = None       # latest-wins slot; guarded by _cond
        self._stop = False          # guarded by _cond
        self._writing = False       # guarded by _cond
        self._last_step = None      # last step handed to the writer
        self.errors = 0             # failed writes
        self.writes = []            # (step, bytes written, seconds) a write
        self._thread = threading.Thread(target=self._writer_loop,
                                        daemon=True,
                                        name="hvd-torch-ckpt-writer")
        self._thread.start()

    # ---------------------------------------------------------- write side
    def maybe_save(self, state) -> bool:
        """Called from ``State.commit()``: a write every
        ``interval_steps`` committed steps."""
        if state.step % self._interval != 0:
            return False
        return self.save_now(state)

    def save_now(self, state) -> bool:
        """Queue the state's committed snapshot."""
        if state._committed is None:
            return False
        params, opt, step, epoch = state._committed
        if step == self._last_step:
            return False   # commit() runs again at a retried boundary
        rank, world, wid = self._topology()
        self._last_step = step
        snap = {"params": params, "opt": opt,
                "opt_full": bool(state._opt_full), "step": int(step),
                "epoch": int(epoch), "rank": rank, "world": world,
                "wid": wid}
        with self._cond:
            self._snapshot = snap   # latest wins
            self._cond.notify()
        return True

    @staticmethod
    def _topology():
        """(rank, world, worker id) at save time, read at every snapshot:
        after a reconfiguration (a coordinator fail-over included) the
        new rank 0 writes the manifests."""
        from horovod_tpu_torch.common import basics

        if basics.is_initialized():
            return basics.rank(), basics.size(), basics.worker_id()
        return 0, 1, 0

    def wait(self, timeout=30.0) -> bool:
        """Block until the writer has drained the queue."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._snapshot is not None or self._writing:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
        return True

    def close(self, flush=True, timeout=30.0):
        if flush:
            self.wait(timeout)
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._thread.join(timeout=timeout)

    def _writer_loop(self):
        while True:
            with self._cond:
                while self._snapshot is None and not self._stop:
                    self._cond.wait()
                if self._stop and self._snapshot is None:
                    return
                snap, self._snapshot = self._snapshot, None
                self._writing = True
            try:
                t0 = time.perf_counter()
                # a slow disk here must read as "slow, not dead" to the
                # coordinator's liveness scan
                with busy.window():
                    nbytes = self._write(snap)
                self.writes.append((snap["step"], nbytes,
                                    time.perf_counter() - t0))
            except Exception:  # noqa: BLE001 — a failed checkpoint
                # write must not kill training; the previous complete
                # manifest stays the recovery point
                self.errors += 1
                _log.warning("checkpoint: write failed", exc_info=True)
            finally:
                with self._cond:
                    self._writing = False
                    self._cond.notify_all()

    def _write(self, snap):
        """Write this rank's shard (and on rank 0 the manifest); -> the
        shard's bytes."""
        step, epoch = snap["step"], snap["epoch"]
        rank, world = snap["rank"], snap["world"]
        flat, n_params = _flatten_params(snap["params"])
        payload = {"params": (flat_shard(flat, world, rank)
                              if flat is not None else
                              np.zeros((0,), np.float32))}
        opt, opt_kind, opt_num = snap["opt"], "none", 0
        if opt is not None:
            leaves = []
            layout = _split(opt, leaves)
            opt_num = len(leaves)
            sharded, rest = {}, {}
            opt_kind = "full" if snap["opt_full"] else "replicated"
            for i, leaf in enumerate(leaves):
                if (snap["opt_full"] and leaf.dim() == 1
                        and leaf.shape[0] == n_params):
                    sharded[str(i)] = flat_shard(_to_numpy(leaf), world,
                                                 rank)
                elif rank == 0:
                    rest[str(i)] = _to_numpy(leaf)
            payload["opt_sharded"] = sharded
            payload["opt_rest"] = rest
            if rank == 0:
                payload["opt_layout"] = layout
        store.write_shard(self._dir, step, epoch, world, rank, payload)
        if rank == 0:
            # manifest last: its presence says "worth validating", and
            # validation still asks for all the world's shards
            store.write_manifest(
                self._dir, step, epoch, world,
                extra={"n_params": n_params, "opt_kind": opt_kind,
                       "opt_num_leaves": opt_num,
                       "root_wid": snap.get("wid", 0)})
        self._prune(rank)
        return os.path.getsize(os.path.join(
            self._dir, store.shard_name(step, epoch, world, rank)))

    def _prune(self, rank):
        if self._keep <= 0:
            return
        own = store.list_own_shards(self._dir, rank)
        # group by (step, epoch) newest first; keep the newest groups
        kept = sorted({(s, e) for s, e, _ in own}, reverse=True)
        dead = set(kept[self._keep:])
        for s, e, w in own:
            if (s, e) in dead:
                store.remove_shard(self._dir, s, e, w, rank)
                if rank == 0:
                    store.remove_manifest(self._dir, s, e, w)
                    # the whole dead group: shards of ranks beyond the
                    # current world have no owner left to prune them
                    for r in range(w):
                        if r != rank:
                            store.remove_shard(self._dir, s, e, w, r)

    # --------------------------------------------------------- resume side
    def restore_latest(self, state):
        """Install the newest complete checkpoint as ``state``'s committed
        snapshot and roll the live state onto it, walking past
        incomplete or corrupt manifests and ones that do not fit the
        live model.  -> ``(step, epoch)`` or None.  Call it on one rank
        (the sync root) before the first ``sync()``."""
        for step, epoch, world in store.list_manifests(self._dir):
            try:
                result = self._restore_one(state, step, epoch, world)
            except (store.CorruptShardError, OSError, ValueError,
                    KeyError, TypeError, RuntimeError) as exc:
                # manifest and shard fields are corruption-shaped input:
                # anything wrong in them means "walk back"
                _log.warning(
                    "checkpoint: manifest step=%d epoch=%d world=%d "
                    "unusable (%s); trying previous", step, epoch, world,
                    exc)
                continue
            self._last_step = step
            _log.warning("checkpoint: resumed from step %d (epoch %d, "
                         "written at world %d)", step, epoch, world)
            return result
        return None

    def _restore_one(self, state, step, epoch, world):
        manifest = store.read_manifest(self._dir, step, epoch, world)
        shards = [store.read_shard(self._dir, step, epoch, world, r)
                  for r in range(world)]
        flat = np.concatenate([np.asarray(s["params"]) for s in shards])
        n_params = int(manifest.get("n_params", flat.size))
        if flat.size != n_params:
            raise ValueError(f"assembled {flat.size} params, manifest "
                             f"records {n_params}")
        if state.params is not None:
            live = sum(t.numel() for t in state.params.values())
            if live != n_params:
                raise ValueError(f"checkpoint holds {n_params} params but "
                                 f"the live model has {live}")
            params = _unflatten_params(flat, state.params)
        elif n_params:
            raise ValueError(
                "checkpoint holds params but the live State has none")
        else:
            params = None

        opt_kind = manifest.get("opt_kind", "none")
        opt = None
        if opt_kind != "none":
            if state.optimizer_state is None:
                raise ValueError("checkpoint holds optimizer state but the "
                                 "live State has none")
            num = int(manifest["opt_num_leaves"])
            leaves = []
            for i in range(num):
                key = str(i)
                if key in shards[0].get("opt_sharded", {}):
                    leaves.append(np.concatenate(
                        [np.asarray(s["opt_sharded"][key]) for s in shards]))
                elif key in shards[0].get("opt_rest", {}):
                    leaves.append(np.asarray(shards[0]["opt_rest"][key]))
                else:
                    raise ValueError(
                        f"optimizer leaf {i} missing from checkpoint")
            opt = _join(shards[0]["opt_layout"],
                        [torch.from_numpy(np.array(x)) for x in leaves])

        previous = (state._committed, state._opt_full)
        state._committed = (params, opt, int(step), int(epoch))
        state._opt_full = opt_kind == "full"
        try:
            state.restore()
        except Exception:
            # an optimizer that does not take this layout: back to the
            # previous snapshot, and walk back
            state._committed, state._opt_full = previous
            if previous[0] is not None:
                state.restore()
            raise
        return int(step), int(epoch)
