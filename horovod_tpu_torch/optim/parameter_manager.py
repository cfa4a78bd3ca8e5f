"""Autotuning of runtime knobs by Bayesian optimization.

The port's own copy of ``horovod_tpu/optim/parameter_manager.py`` (numpy
only; the port imports nothing of the reference), kept equal to it line
for line in the numerics, so that the same recorded samples give the
same proposals bit for bit.  Reference lineage: Horovod's
``parameter_manager.cc`` with its Gaussian-process surrogate and
expected-improvement sampling: warmup windows discarded, score =
training samples/sec, freeze at the best point after the budget.

Usage::

    pm = ParameterManager(knobs={"fusion_threshold": (1<<20, 1<<28)})
    while training:
        t0 = time.perf_counter(); steps(...); dt = time.perf_counter()-t0
        suggestion = pm.record(samples=batch*k, seconds=dt)
        if suggestion:   # rebuild the train step with suggestion values
            ...
"""

from __future__ import annotations

import json
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class GaussianProcess:
    """Minimal GP regressor with RBF kernel (reference:
    ``gaussian_process.cc``)."""

    def __init__(self, length_scale: float = 1.0, noise: float = 1e-6,
                 signal_variance: float = 1.0) -> None:
        self.length_scale = length_scale
        self.noise = noise
        self.signal_variance = signal_variance
        self._x: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None
        self._k_inv: Optional[np.ndarray] = None

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return self.signal_variance * np.exp(-0.5 * d2 / self.length_scale ** 2)

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        self._x = np.atleast_2d(np.asarray(x, np.float64))
        self._y = np.asarray(y, np.float64)
        k = self._kernel(self._x, self._x)
        k[np.diag_indices_from(k)] += self.noise
        self._k_inv = np.linalg.inv(k)

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        x = np.atleast_2d(np.asarray(x, np.float64))
        if self._x is None:
            return (np.zeros(len(x)),
                    np.full(len(x), math.sqrt(self.signal_variance)))
        ks = self._kernel(x, self._x)
        mean = ks @ self._k_inv @ self._y
        kss = self.signal_variance
        var = np.maximum(kss - np.einsum("ij,jk,ik->i", ks, self._k_inv, ks),
                         1e-12)
        return mean, np.sqrt(var)


def expected_improvement(mean: np.ndarray, std: np.ndarray,
                         best: float, xi: float = 0.01) -> np.ndarray:
    """EI acquisition (reference: ``bayesian_optimization.cc``)."""
    from math import erf, sqrt

    z = (mean - best - xi) / std
    cdf = 0.5 * (1.0 + np.vectorize(erf)(z / sqrt(2.0)))
    pdf = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
    return (mean - best - xi) * cdf + std * pdf


class ParameterManager:
    """Online knob tuner (reference: ``ParameterManager``).

    Knobs are searched in log2 space over ``(low, high)`` ranges.
    ``record(samples, seconds)`` aggregates scores; every
    ``steps_per_sample`` records it proposes the next candidate (after
    ``warmup_samples`` discarded).  When the candidate pool is
    exhausted or scores converge, tuning freezes at the best point
    (reference behavior).

    Discrete/boolean knobs ride the same continuous machinery with a
    **snap at the apply boundary**: the caller quantizes each proposal
    onto its lattice (``hierarchical_inner_size`` → nearest divisor of
    the rank count, ``pipeline_depth`` → int in [1, 8], ``two_phase`` →
    the 1=off / 2=on pair) and mirrors the as-applied point back via
    :meth:`mirror`, so scores are always attributed to values the job
    actually ran — see ``basics._apply_autotuned_knobs``.
    """

    def __init__(self, knobs: Dict[str, Tuple[float, float]],
                 *, warmup_samples: int = 3, steps_per_sample: int = 10,
                 max_samples: int = 20, candidates_per_round: int = 64,
                 log_path: Optional[str] = None, seed: int = 0,
                 initial: Optional[Dict[str, float]] = None) -> None:
        if not knobs:
            raise ValueError("ParameterManager needs at least one knob")
        self.knob_names = sorted(knobs)
        self.bounds = np.array(
            [[math.log2(knobs[k][0]), math.log2(knobs[k][1])]
             for k in self.knob_names])
        self.warmup_samples = warmup_samples
        self.steps_per_sample = steps_per_sample
        self.max_samples = max_samples
        self.candidates_per_round = candidates_per_round
        self._rng = np.random.RandomState(seed)
        self._gp = GaussianProcess(length_scale=2.0)
        self._x: List[np.ndarray] = []
        self._y: List[float] = []
        # Scores are recorded against _current, so it MUST match the
        # knob values the caller is actually running — seed it with the
        # live values when given, else the midpoint is just the
        # conventional first candidate.  Out-of-bounds seeds would break
        # that invariant silently (and 0 breaks log2); reject them so
        # the caller decides (basics falls back to adopting the
        # manager's start point as the live value).
        if initial:
            vals = []
            for i, k in enumerate(self.knob_names):
                v = initial.get(k, float(2 ** self.bounds[i].mean()))
                if not (2 ** self.bounds[i, 0] <= v <= 2 ** self.bounds[i, 1]):
                    raise ValueError(
                        f"initial value {v} for knob {k!r} is outside the "
                        f"search bounds [{2 ** self.bounds[i, 0]:.0f}, "
                        f"{2 ** self.bounds[i, 1]:.0f}]")
                vals.append(math.log2(v))
            self._current = np.array(vals)
        else:
            self._current = self.bounds.mean(axis=1)
        # One manager drives one train step (make_train_step claims it);
        # concurrent consumers would cross-pollute scores.
        self.claimed = False
        self._records: List[float] = []
        self._samples_seen = 0
        self._frozen = False
        self._log = open(log_path, "w") if log_path else None

    # --- public API --------------------------------------------------------

    @property
    def frozen(self) -> bool:
        return self._frozen

    def close(self) -> None:
        """Flush and close the autotune log (idempotent; called from
        ``hvd.shutdown``)."""
        if self._log:
            self._log.close()
            self._log = None

    def mirror(self, values: Optional[Dict[str, float]],
               frozen: bool) -> None:
        """Adopt a peer's tuner decision (multi-controller worlds: rank
        0 tunes, everyone else mirrors — the reference's coordinator
        broadcast).  ``values`` of None leaves the current point."""
        if values:
            self._current = np.array(
                [math.log2(values[k]) for k in self.knob_names])
        self._frozen = frozen
        if frozen:
            self.close()

    def current_values(self) -> Dict[str, float]:
        return {k: float(2 ** v)
                for k, v in zip(self.knob_names, self._current)}

    def record(self, samples: float, seconds: float) -> Optional[Dict[str, float]]:
        """Feed one timing observation.  Returns new knob values when the
        manager wants the caller to reconfigure, else None."""
        if self._frozen or seconds <= 0:
            return None
        self._records.append(samples / seconds)
        if len(self._records) < self.steps_per_sample:
            return None
        score = float(np.median(self._records))
        self._records = []
        return self._ingest(score)

    def record_window(self, samples: float,
                      seconds: float) -> Optional[Dict[str, float]]:
        """Feed one aggregated window: ``steps_per_sample`` steps fenced
        ONCE (one device sync per window instead of per step — the right
        cadence for asynchronous CUDA launches, where per-step wall times
        are meaningless).  Equivalent to :meth:`record` fed per-step timings
        of identical rate; returns new knob values or None, same
        contract."""
        if self._frozen or seconds <= 0:
            return None
        return self._ingest(samples / seconds)

    # --- internals ---------------------------------------------------------

    def _ingest(self, score: float) -> Optional[Dict[str, float]]:
        """Shared score-ingestion tail of record/record_window: warmup
        discard → observe (x=current, y=score) → freeze or propose."""
        self._samples_seen += 1
        if self._samples_seen <= self.warmup_samples:
            return None  # discard warmup; keep current knobs
        self._x.append(self._current.copy())
        self._y.append(score)
        self._log_sample(score)
        if len(self._y) >= self.max_samples:
            return self._freeze()
        self._current = self._propose()
        return self.current_values()

    def _propose(self) -> np.ndarray:
        y = np.asarray(self._y)
        # Normalize scores for GP conditioning.
        y_n = (y - y.mean()) / (y.std() + 1e-9)
        self._gp.fit(np.asarray(self._x), y_n)
        cand = self._rng.uniform(self.bounds[:, 0], self.bounds[:, 1],
                                 size=(self.candidates_per_round,
                                       len(self.knob_names)))
        mean, std = self._gp.predict(cand)
        ei = expected_improvement(mean, std, float(y_n.max()))
        return cand[int(np.argmax(ei))]

    def _freeze(self) -> Dict[str, float]:
        best = int(np.argmax(self._y))
        self._current = self._x[best]
        self._frozen = True
        self._log_sample(self._y[best], note="frozen")
        if self._log:
            self._log.close()
            self._log = None
        return self.current_values()

    def _log_sample(self, score: float, note: str = "") -> None:
        if self._log:
            self._log.write(json.dumps({
                "knobs": self.current_values(), "score": score,
                "note": note, "ts": time.time(),
            }) + "\n")
            self._log.flush()
