"""Online autotuning of the training step (``HOROVOD_AUTOTUNE=1``).

Counterpart of ``horovod_tpu/optim/autotune.py``.  Horovod's runtime
scores training samples/sec a tuning window, proposes new knob values
(Bayesian optimization, :mod:`.parameter_manager`), applies them to the
next cycle and freezes at the best point after its budget.

The knobs (the fusion threshold and the others ``basics`` adds) are read
from the session's config when a step runs, so a proposal is applied by
writing it into the live config and rebuilding the step: the port's
re-jit boundary.  The wrapper times windows of ``steps_per_sample``
steps with one ``torch.cuda.synchronize()`` a window (a step's host time
alone measures the launches, not the work), and leaves the first step
after each rebuild out of every window, as the reference leaves out the
step that compiles.  Rank 0 scores and decides; it broadcasts each
decision and the other ranks mirror it, so every rank rebuilds the same
step (different collective programs would hang).  Once the manager
freezes, the wrapper passes straight through.

``hvd.make_train_step`` returns one of these when autotune is on.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

import torch

from .. import basics
from ..obs import instrument as _obs

logger = logging.getLogger(__name__)


def _batch_rows(batch) -> int:
    """Samples a step on this rank: the rows of the batch's first
    tensor."""
    from .distributed_optimizer import _batch_leaves

    leaves = _batch_leaves(batch)
    return int(leaves[0].shape[0]) if leaves and leaves[0].dim() else 0


def _synchronize() -> None:
    if basics.device().type == "cuda":
        torch.cuda.synchronize()


class AutotunedTrainStep:
    """A train step that rebuilds itself as the
    :class:`~.parameter_manager.ParameterManager` proposes knob values.

    ``rebuild()`` returns a fresh ``step(model, batch)`` that reads the
    live config (``make_train_step``'s does).  :attr:`applied` lists the
    fusion thresholds installed, :attr:`applied_knobs` every applied
    point."""

    def __init__(self, rebuild: Callable[[], Callable], pm) -> None:
        self._rebuild = rebuild
        self._pm = pm
        self._step = rebuild()
        self._window_steps = 0
        self._window_samples = 0.0
        self._t0 = 0.0
        self._burn_in = True
        self.applied: list = []
        self.applied_knobs: list = []

    @property
    def frozen(self) -> bool:
        return self._pm.frozen

    def __call__(self, model, batch, *rest):
        if self._pm.frozen:
            return self._step(model, batch, *rest)
        if self._burn_in:
            # The first step of a rebuilt step: trained, never scored.
            out = self._step(model, batch, *rest)
            _synchronize()
            self._burn_in = False
            return out
        if self._window_steps == 0:
            # The last window (or burn-in) ended synchronized: the queue
            # is empty, t0 is honest.
            self._t0 = time.perf_counter()
        out = self._step(model, batch, *rest)
        self._window_steps += 1
        self._window_samples += _batch_rows(batch)
        if self._window_steps >= self._pm.steps_per_sample:
            _synchronize()
            dt = time.perf_counter() - self._t0
            suggestion = self._record_synchronized(self._window_samples, dt)
            # The decision log: every scored window and what the manager
            # proposed.
            _obs.on_autotune_window(
                self._window_samples / dt if dt > 0 else 0.0, suggestion)
            self._window_steps = 0
            self._window_samples = 0.0
            if suggestion is not None:
                self._apply(suggestion)
        return out

    def _record_synchronized(self, samples: float, dt: float):
        """Score the window and return the proposal, the same on every
        rank: rank 0 runs the manager and broadcasts its decision, the
        others mirror it."""
        if basics.size() == 1:
            return self._pm.record_window(samples, dt)
        from ..functions import broadcast_object

        payload = None
        if basics.rank() == 0:
            suggestion = self._pm.record_window(samples, dt)
            payload = (suggestion, self._pm.frozen)
        suggestion, frozen = broadcast_object(payload, root_rank=0)
        if basics.rank() != 0:
            self._pm.mirror(suggestion, frozen)
        return suggestion

    def _apply(self, suggestion) -> None:
        applied = basics._apply_autotuned_knobs(suggestion)
        # Attribute the next scores to the values as applied (snapped).
        self._pm.mirror(applied, frozen=self._pm.frozen)
        self._step = self._rebuild()
        self._burn_in = True
        self.applied.append(applied.get("fusion_threshold"))
        self.applied_knobs.append(applied)
        _obs.on_autotune_apply(applied, self._pm.frozen)
        logger.info("autotune %s %s (%d applied so far)",
                    "froze at" if self._pm.frozen else "trying", applied,
                    len(self.applied))
