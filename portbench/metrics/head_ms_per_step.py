"""``head_ms_per_step``: device ms a step on rank 0 of the operations
launched inside the port's ``hvd_tpu_layer_head`` ranges, forward and
backward: the loss head (GPT: ``ln_f``, the f32 ``lm_head``, the
log-softmax cross-entropy; BERT: the pooler, the MLM transform, the tied
f32 decoder, the masked cross-entropy)."""

from portbench.core.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "hvd_tpu_layer_head")
