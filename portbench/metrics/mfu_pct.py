"""``mfu_pct``: model FLOPs of the steps of the traced run's untraced
window over the card's bf16 peak times the window's wall time, on every
rank alike (``work/counts.py::model_flops_per_step``).  Recompute is not
counted.  None on a card that ``work/peaks.json`` lacks."""

from portbench.work.counts import model_flops_per_step


def read(ctx):
    if ctx.peaks is None:
        return None
    flops = model_flops_per_step(ctx.shape, ctx.batch, ctx.seq)
    return (100.0 * flops * ctx.window["steps"]
            / (ctx.peaks["bf16_flops"] * ctx.window["wall_s"]))
