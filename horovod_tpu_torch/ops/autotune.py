"""Autotune of the eager plane (port of ``horovod_tpu/ops/autotune.py``).

The reference tunes runtime knobs on rank 0 and sends the winners to
every rank inside the coordinator's responses, so that every rank
applies the same values at the same cycle boundary
(``horovod/common/controller.cc:33`` ``SynchronizeParameters``).  Here
rank 0's :class:`~horovod_tpu_torch.ops.controller.Controller` owns an
:class:`AutotuneManager`: it records the bytes of each cycle's executed
responses, ticks the score window, and puts each new ``(seq, params)``
into its own cycle message.  Every rank reads it from the gathered
cycle, which is the same on every rank, and applies it at one fixed
point of absorbing that cycle, before the cycle is planned.

The knobs are those that have a meaning in the port: the fusion
threshold, the cycle time, the hierarchical allreduce and allgather, the
response cache, and compression on/off when a compressor is configured.
The JAX package's ``ring_segment_bytes``, ``ring_stripes`` and
``schedule`` steer its TCP data plane and are not ported.
"""

import threading
import time

from horovod_tpu_torch.common.autotune import ParameterManager
from horovod_tpu_torch.utils.logging import get_logger


def default_params(config):
    """The knob values ``tuned_params()`` reports before any tuned value
    is applied (and always when autotune is off)."""
    return {
        "fusion_threshold_bytes": config.fusion_threshold_bytes,
        "cycle_time_ms": config.cycle_time_ms,
        "hierarchical_allreduce": config.hierarchical_allreduce,
        "hierarchical_allgather": config.hierarchical_allgather,
        "cache_enabled": True,
        "compression": config.compression,
        "tuning": False,
        "best_score_bytes_per_sec": 0.0,
    }


class AutotuneManager:
    """Rank 0's tuner: records per-cycle bytes, re-optimizes, and reports
    changed values for the controller to publish."""

    @classmethod
    def create(cls, config):
        """The manager when ``config.autotune`` is on, else None.  A
        failure raises: the job never runs untuned in silence."""
        return cls(config) if config.autotune else None

    def __init__(self, config):
        # the tuner explores compression as on/off; the compressor stays
        # the configured one, and with none configured the toggle is not
        # in the walk
        self._compression = str(config.compression)
        comp_on = self._compression != "none"
        self._lock = threading.Lock()
        self._pm = ParameterManager(   # guarded by self._lock
            warmup_samples=config.autotune_warmup_samples,
            steady_state_samples=config.autotune_steady_state_samples,
            bayes_opt_max_samples=config.autotune_bayes_opt_max_samples,
            gp_noise=config.autotune_gaussian_process_noise,
            log_path=config.autotune_log or None,
            fusion_threshold_bytes=config.fusion_threshold_bytes,
            cycle_time_ms=config.cycle_time_ms,
            hierarchical_allreduce=config.hierarchical_allreduce,
            hierarchical_allgather=config.hierarchical_allgather,
            compression=comp_on, compression_available=comp_on)
        self._start = time.monotonic()
        self._seq = 0        # guarded by self._lock
        self._last = None    # guarded by self._lock
        self._closed = False  # guarded by self._lock

    def record(self, nbytes):
        with self._lock:
            if not self._closed:
                self._pm.record(int(nbytes))

    def maybe_update(self):
        """Tick the tuner's clock; -> ``(seq, params)`` when the values
        changed (and on the first call), else None."""
        with self._lock:
            if self._closed:
                return None
            changed = self._pm.update(time.monotonic() - self._start)
            if not changed and self._last is not None:
                return None
            params = self._snapshot_locked()
            if params == self._last:
                return None
            self._last = params
            self._seq += 1
            get_logger().debug("autotune: new params #%d %s", self._seq,
                               params)
            return self._seq, params

    def params(self):
        with self._lock:
            if self._closed:
                return dict(self._last or {})
            return self._snapshot_locked()

    def _snapshot_locked(self):  # holds: self._lock
        pm = self._pm
        return {
            "fusion_threshold_bytes": pm.fusion_threshold_bytes,
            "cycle_time_ms": pm.cycle_time_ms,
            "hierarchical_allreduce": pm.hierarchical_allreduce,
            "hierarchical_allgather": pm.hierarchical_allgather,
            "cache_enabled": pm.cache_enabled,
            "compression": (self._compression if pm.compression_enabled
                            else "none"),
            "tuning": pm.tuning,
            "best_score_bytes_per_sec": pm.best_score,
        }

    def close(self):
        with self._lock:
            if not self._closed:
                self._closed = True
                self._pm.close()
