"""``int8_wire_roofline``: the int8 wire's kernels (B2
``quantize_rows``, B3 ``dequantize_accumulate*``, B4
``dequantize_rows*``) on rank 0: a step's bytes at the memory rate
(``work/counts.py::int8_wire_bytes``, error feedback included) over
their device time, over the traced steps."""

from portbench.work.counts import int8_wire_bytes


def _wire_kernel(name: str) -> bool:
    # "quantize_rows" is also a part of B4's "dequantize_rows".
    return "quantize_rows" in name or "dequantize_accumulate" in name


def read(ctx):
    ops = [op for op in ctx.trace.device_ops(ctx.trace.window(),
                                             kernels_only=True)
           if _wire_kernel(op.name)]
    if not ops or ctx.peaks is None:
        return None
    wire = ctx.cell.workload["wire"]
    nbytes = int8_wire_bytes(ctx.leaf_numels, ctx.world,
                             bool(wire["error_feedback"]))["total"]
    bound = nbytes * ctx.traced_steps / ctx.peaks["hbm_bytes_per_s"]
    spent = sum(op.end - op.start for op in ops) * 1e-6
    return 100.0 * bound / spent
