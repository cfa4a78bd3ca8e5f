"""``attn_layer_ms_per_step``: device ms a step on rank 0 of the
operations launched inside the port's ``hvd_tpu_layer_attn`` ranges,
forward and backward: every block's attention sublayer (its LayerNorm,
products, attention and residual add), so it holds what
``attn_bwd_ms_per_step`` reads."""

from portbench.core.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "hvd_tpu_layer_attn")
