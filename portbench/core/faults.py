"""Faults planted under the timed path, for the tests and the
calibration that show ``correct`` catches them.  ``run.py`` never plants
one.

- ``unchanged_state``: the optimizer's step does nothing, so the step
  returns with the parameters and the optimizer state unchanged;
- ``half_batch``: the loss is taken over the first half of the batch's
  rows, the mean over those;
- ``no_exchange``: the gradients are not reduced between the ranks;
- ``altered_loss``: the loss is altered by 1% where it is produced.
"""

from __future__ import annotations

import contextlib
from typing import Optional
from unittest import mock

NAMES = ("unchanged_state", "half_batch", "no_exchange", "altered_loss")


@contextlib.contextmanager
def planted(name: Optional[str]):
    if name is None:
        yield
        return
    from horovod_tpu_torch.optim import distributed_optimizer as do

    orig = do._loss_and_aux
    if name == "unchanged_state":
        patch = mock.patch.object(do.DistributedOptimizer, "step",
                                  lambda self, closure=None: None)
    elif name == "half_batch":
        def half(loss_fn, model, batch, has_aux):
            return orig(loss_fn, model,
                        tuple(t[: t.shape[0] // 2] for t in batch), has_aux)
        patch = mock.patch.object(do, "_loss_and_aux", half)
    elif name == "no_exchange":
        patch = mock.patch.object(do, "_reduce_grads",
                                  lambda grads, **kwargs: grads)
    elif name == "altered_loss":
        def altered(loss_fn, model, batch, has_aux):
            loss, aux = orig(loss_fn, model, batch, has_aux)
            return loss * 1.01, aux
        patch = mock.patch.object(do, "_loss_and_aux", altered)
    else:
        raise ValueError(f"unknown fault {name!r}; faults: {NAMES}")
    with patch:
        yield
