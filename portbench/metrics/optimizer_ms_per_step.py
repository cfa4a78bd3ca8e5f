"""``optimizer_ms_per_step``: device ms a step on rank 0 of the
operations launched inside the port's ``hvd_tpu_apply`` span: the
wrapped AdamW's step."""

from portbench.core.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "hvd_tpu_apply")
