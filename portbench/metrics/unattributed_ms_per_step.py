"""``unattributed_ms_per_step``: device ms a step on rank 0 of the
kernels, copies and sets in the traced steps launched under none of the
port's layer ranges and stage spans (``core/spans.py``'s ``EVERY``):
the loss average across ranks, anything the ranges miss."""

from portbench.core.spans import unattributed_ms_per_step


def read(ctx):
    return unattributed_ms_per_step(ctx)
