"""The autotuner: Gaussian-process Bayesian optimization of the eager
plane's knobs (port of ``horovod_tpu/common/autotune.py``, whose math
and walk live in ``csrc/hvd/parameter_manager.cc`` and
``csrc/hvd/optim/{gaussian_process,bayesian_optimization}.cc``;
reference: ``horovod/common/parameter_manager.{h,cc}``).

The tuner runs on the host, a few dozen samples a window, so it is
written here in Python on float64, with the C++ core's arithmetic in the
C++ core's order: the same ``(bytes, time)`` observations give the same
published values and the same CSV rows.  Its candidates stride a fixed
Halton sequence, so the walk is deterministic.

Departure from the JAX package: the walk has no ring or schedule
probes.  Those knobs steer the JAX package's TCP data plane, which the
port does not have (NCCL picks its own algorithm), so this is the C++
walk with ``ring_tunable`` and ``schedule_tunable`` off, and the CSV
rows carry no ``ring_segment_bytes``, ``ring_stripes`` and ``schedule``
columns.

Tuning walk: for each categorical configuration (hierarchical
allreduce, hierarchical allgather, response cache, and compression when
a compressor is configured), starting with the configured one, run
``bayes_opt_max_samples`` evaluations over (log2 fusion MB, cycle time
ms).  Each point is held for ``steady_state_samples`` score windows
(median taken); the first ``warmup_samples`` windows after a change are
discarded.  When the walk ends, the best configuration seen is pinned
and tuning stops.
"""

import math

import numpy as np

# search space: log2(fusion MB) in [0, 8] (1 MB .. 256 MB), cycle time in
# [1, 25] ms (parameter_manager.cc)
_FUSION_LOG_LOW, _FUSION_LOG_HIGH = 0.0, 8.0
_CYCLE_LOW, _CYCLE_HIGH = 1.0, 25.0
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT2PI = 0.3989422804014327
_HALTON_BASES = (2, 3, 5, 7, 11, 13)
_MB = 1024 * 1024


def _llround(x):
    """C's ``llround``: to nearest, halves away from zero."""
    f = math.floor(x)
    diff = x - f
    if diff > 0.5 or (diff == 0.5 and x > 0):
        f += 1
    return int(f)


def _fusion_bytes(log2_mb):
    return _llround(math.pow(2.0, log2_mb)) * _MB


# --------------------------------------------------------- linear algebra
def _cholesky(m, n):
    """In-place lower Cholesky factor of the row-major ``n x n`` list
    ``m``; False if it is not positive definite."""
    for j in range(n):
        diag = m[j * n + j]
        for k in range(j):
            diag -= m[j * n + k] * m[j * n + k]
        if diag <= 0.0:
            return False
        diag = math.sqrt(diag)
        m[j * n + j] = diag
        for i in range(j + 1, n):
            v = m[i * n + j]
            for k in range(j):
                v -= m[i * n + k] * m[j * n + k]
            m[i * n + j] = v / diag
        for k in range(j + 1, n):
            m[j * n + k] = 0.0
    return True


def _cholesky_solve(chol, n, b):
    b = list(b)
    for i in range(n):
        v = b[i]
        for k in range(i):
            v -= chol[i * n + k] * b[k]
        b[i] = v / chol[i * n + i]
    for ii in range(n - 1, -1, -1):
        v = b[ii]
        for k in range(ii + 1, n):
            v -= chol[k * n + ii] * b[k]
        b[ii] = v / chol[ii * n + ii]
    return b


class GaussianProcess:
    """GP regression with an RBF kernel:
    ``k(a, b) = signal_variance * exp(-||a - b||^2 / (2 length_scale^2))``,
    observation noise ``noise_variance`` on the diagonal."""

    def __init__(self, length_scale=1.0, signal_variance=1.0,
                 noise_variance=1e-6):
        self._ls = float(length_scale)
        self._sv = float(signal_variance)
        self._noise = float(noise_variance)
        self._x = []
        self._alpha = []
        self._chol = []

    def _kernel(self, a, b):
        sq = 0.0
        for ai, bi in zip(a, b):
            d = ai - bi
            sq += d * d
        return self._sv * math.exp(-sq / (2.0 * self._ls * self._ls))

    def _fit(self, x, y):
        n = len(x)
        k = [0.0] * (n * n)
        for i in range(n):
            for j in range(i + 1):
                v = self._kernel(x[i], x[j])
                if i == j:
                    v += self._noise
                k[i * n + j] = v
                k[j * n + i] = v
        if not _cholesky(k, n):
            return False
        self._x = x
        self._chol = k
        self._alpha = _cholesky_solve(k, n, y)
        return True

    def fit(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 1:
            # n one-dimensional samples, not one n-dimensional sample
            x = x[:, None]
        y = np.asarray(y, dtype=np.float64)
        if len(y) != x.shape[0]:
            raise ValueError(
                f"x has {x.shape[0]} samples but y has {len(y)}")
        if not self._fit([[float(v) for v in row] for row in x],
                         [float(v) for v in y]):
            raise ValueError("GP fit failed: kernel matrix not SPD")
        return self

    def _predict(self, x):
        n = len(self._x)
        if n == 0:
            return 0.0, self._sv
        ks = [self._kernel(xi, x) for xi in self._x]
        m = 0.0
        for i in range(n):
            m += ks[i] * self._alpha[i]
        v = list(ks)
        chol = self._chol
        for i in range(n):
            t = v[i]
            for k in range(i):
                t -= chol[i * n + k] * v[k]
            v[i] = t / chol[i * n + i]
        reduction = 0.0
        for i in range(n):
            reduction += v[i] * v[i]
        var = self._kernel(x, x) - reduction
        return m, var if var > 0.0 else 0.0

    def predict(self, x):
        """Posterior (mean, variance) at a single point."""
        return self._predict([float(v) for v in
                              np.asarray(x, dtype=np.float64).ravel()])


def expected_improvement(mean, stddev, best, xi=0.01):
    """EI for maximization at a point with posterior (mean, stddev)."""
    improvement = mean - best - xi
    if stddev <= 0.0:
        return improvement if improvement > 0.0 else 0.0
    z = improvement / stddev
    cdf = 0.5 * (1.0 + math.erf(z * _INV_SQRT2))
    pdf = _INV_SQRT2PI * math.exp(-0.5 * z * z)
    return improvement * cdf + stddev * pdf


def _halton(index, base):
    f, r, i = 1.0, 0.0, index
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


class BayesianOptimizer:
    """GP + expected-improvement search over a box, maximized over a
    fixed Halton candidate sweep."""

    def __init__(self, low, high, gp_noise=1e-4, num_candidates=256):
        self._low = [float(v) for v in np.asarray(low, np.float64).ravel()]
        self._high = [float(v) for v in
                      np.asarray(high, np.float64).ravel()]
        self._noise = float(gp_noise)
        self._num_candidates = int(num_candidates)
        self._seeds_used = 0
        self._x = []
        self._y = []
        self._best_y = -math.inf

    @property
    def num_samples(self):
        return len(self._x)

    @property
    def best_y(self):
        return self._best_y

    def add_sample(self, x, y):
        x = [float(v) for v in np.asarray(x, np.float64).ravel()]
        self._x.append(x)
        self._y.append(float(y))
        if y > self._best_y:
            self._best_y = float(y)

    def _candidate(self, index):
        return [lo + _halton(index + 1, _HALTON_BASES[d % 6]) * (hi - lo)
                for d, (lo, hi) in enumerate(zip(self._low, self._high))]

    def _suggest(self):
        dim = len(self._low)
        if len(self._x) < dim + 2:
            # seed phase: the centre first, then strided Halton points
            if self._seeds_used == 0:
                self._seeds_used += 1
                return [0.5 * (lo + hi)
                        for lo, hi in zip(self._low, self._high)]
            self._seeds_used += 1
            return self._candidate(17 * (self._seeds_used - 1))
        mean_y = 0.0
        for y in self._y:
            mean_y += y
        mean_y /= len(self._y)
        var_y = 0.0
        for y in self._y:
            var_y += (y - mean_y) * (y - mean_y)
        var_y /= len(self._y)
        scale = math.sqrt(var_y) if var_y > 1e-12 else 1.0

        def norm(x):
            return [(x[d] - self._low[d]) / (self._high[d] - self._low[d])
                    if self._high[d] - self._low[d] > 0 else 0.0
                    for d in range(dim)]

        xu = [norm(x) for x in self._x]
        yn = [(y - mean_y) / scale for y in self._y]
        gp = GaussianProcess(0.25, 1.0, self._noise)
        if not gp._fit(xu, yn):
            self._seeds_used += 1
            return self._candidate(17 * (self._seeds_used - 1))
        best_norm = (self._best_y - mean_y) / scale
        best_ei = -1.0
        best = self._candidate(0)
        for c in range(self._num_candidates):
            cand = self._candidate(c)
            m, v = gp._predict(norm(cand))
            ei = expected_improvement(m, math.sqrt(v), best_norm)
            if ei > best_ei:
                best_ei = ei
                best = cand
        return best

    def suggest(self):
        return np.asarray(self._suggest(), dtype=np.float64)


class ParameterManager:
    """The tuning walk on a virtual clock: :meth:`record` the bytes of
    executed responses, :meth:`update` at a time in seconds on any
    increasing clock; the current values are its properties."""

    def __init__(self, warmup_samples=3, steady_state_samples=10,
                 bayes_opt_max_samples=20, gp_noise=0.8, log_path=None,
                 fusion_threshold_bytes=64 * _MB, cycle_time_ms=1.0,
                 hierarchical_allreduce=False, hierarchical_allgather=False,
                 cache_enabled=True, compression=False,
                 compression_available=False):
        self._warmup = int(warmup_samples)
        self._steady = int(steady_state_samples)
        self._max_samples = int(bayes_opt_max_samples)
        self._noise = float(gp_noise)
        fusion = int(fusion_threshold_bytes)
        seed = (bool(hierarchical_allreduce), bool(hierarchical_allgather),
                bool(cache_enabled), bool(compression))
        comp = bool(compression)
        walk = [(False, False, True, comp), (True, False, True, comp),
                (False, True, True, comp), (True, True, True, comp),
                (False, False, False, comp)]
        if compression_available:
            # one probe of the other compression state
            walk.append((False, False, True, not comp))
        # the walk starts at the configured categorical
        self._walk = [seed] + [c for c in walk if c != seed]
        self._walk_index = 0
        self._best_fusion_log2_mb = math.log2(max(1.0, fusion / (1024.0
                                                                 * 1024.0)))
        self._best_cycle_ms = float(cycle_time_ms)
        self._best_cat = seed
        self._fusion_bytes = fusion
        self._cycle_ms = float(cycle_time_ms)
        (self._hier_allreduce, self._hier_allgather, self._cache_enabled,
         self._compression) = seed
        self._tuning = True
        self._best_score = 0.0
        self._window_bytes = 0
        self._window_start = -1.0
        self._discard_left = self._warmup
        self._window_scores = []
        self._point = None
        self._log = None
        if log_path:
            self._log = open(log_path, "w")
            self._log.write("score_bytes_per_sec,fusion_threshold_mb,"
                            "cycle_time_ms,hierarchical_allreduce,"
                            "hierarchical_allgather,cache_enabled,"
                            "compression\n")
        self._bayes = self._new_optimizer()
        self._apply_point(self._bayes._suggest())

    def _new_optimizer(self):
        return BayesianOptimizer([_FUSION_LOG_LOW, _CYCLE_LOW],
                                 [_FUSION_LOG_HIGH, _CYCLE_HIGH],
                                 self._noise)

    def _apply_point(self, point):
        self._point = point
        self._fusion_bytes = _fusion_bytes(point[0])
        self._cycle_ms = point[1]
        (self._hier_allreduce, self._hier_allgather, self._cache_enabled,
         self._compression) = self._walk[self._walk_index]
        self._discard_left = self._warmup
        self._window_scores = []
        self._window_bytes = 0
        self._window_start = -1.0

    def _apply_best(self):
        self._fusion_bytes = _fusion_bytes(self._best_fusion_log2_mb)
        self._cycle_ms = self._best_cycle_ms
        (self._hier_allreduce, self._hier_allgather, self._cache_enabled,
         self._compression) = self._best_cat
        self._tuning = False
        if self._log is not None:
            self._log.flush()

    def _next_categorical(self):
        self._walk_index += 1
        if self._walk_index >= len(self._walk):
            self._apply_best()
            return
        self._bayes = self._new_optimizer()
        self._apply_point(self._bayes._suggest())

    def _log_row(self, score):
        if self._log is None:
            return
        self._log.write("%.1f,%.2f,%.2f,%d,%d,%d,%d\n" % (
            score, self._fusion_bytes / (1024.0 * 1024.0), self._cycle_ms,
            self._hier_allreduce, self._hier_allgather, self._cache_enabled,
            self._compression))

    def record(self, nbytes):
        if self._tuning:
            self._window_bytes += int(nbytes)

    def update(self, now_seconds):
        """Close a score window at ``now_seconds``; True if the tuned
        values changed."""
        if not self._tuning:
            return False
        now = float(now_seconds)
        if self._window_start < 0.0:
            self._window_start = now
            self._window_bytes = 0
            return False
        elapsed = now - self._window_start
        if elapsed <= 0.0:
            return False
        score = float(self._window_bytes) / elapsed
        self._window_start = now
        self._window_bytes = 0
        if self._discard_left > 0:
            self._discard_left -= 1
            return False
        self._window_scores.append(score)
        if len(self._window_scores) < self._steady:
            return False
        self._window_scores.sort()
        observed = self._window_scores[len(self._window_scores) // 2]
        self._window_scores = []
        self._log_row(observed)
        if observed > self._best_score:
            self._best_score = observed
            self._best_fusion_log2_mb = self._point[0]
            self._best_cycle_ms = self._point[1]
            self._best_cat = self._walk[self._walk_index]
        self._bayes.add_sample(self._point, observed)
        if self._bayes.num_samples >= self._max_samples:
            self._next_categorical()
        else:
            self._apply_point(self._bayes._suggest())
        return True

    def close(self):
        if self._log is not None:
            self._log.close()
            self._log = None

    @property
    def fusion_threshold_bytes(self):
        return self._fusion_bytes

    @property
    def cycle_time_ms(self):
        return self._cycle_ms

    @property
    def hierarchical_allreduce(self):
        return self._hier_allreduce

    @property
    def hierarchical_allgather(self):
        return self._hier_allgather

    @property
    def cache_enabled(self):
        return self._cache_enabled

    @property
    def compression_enabled(self):
        return self._compression

    @property
    def tuning(self):
        return self._tuning

    @property
    def best_score(self):
        return self._best_score
