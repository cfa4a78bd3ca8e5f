"""``mlp_ms_per_step``: device ms a step on rank 0 of the operations
launched inside the port's ``hvd_tpu_layer_mlp`` ranges, forward and
backward: every block's MLP sublayer (its LayerNorm, up product, GELU,
down product and residual add)."""

from portbench.core.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "hvd_tpu_layer_mlp")
