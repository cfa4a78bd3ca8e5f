"""``flash_bwd_roofline``: the attention backward's share of its
roofline on rank 0: the bound of the traced steps' backward calls
(``n_layer`` a step) over the device time of every kernel launched inside
the ``_Flash3Backward`` autograd node, linked to their launch by
correlation id in the trace that holds the host's ops (as
``attn_bwd_ms_per_step`` finds them).

A call's bound is counted here from the cell's shape alone, the same
work whatever computes it: five products of ``2·BH·T·Tk·D`` operations
(``S = QKᵀ``, ``dP = dO·Vᵀ``, ``dV``, ``dK``, ``dQ``; half when
causal) against Q, O, dO and dQ (T rows) and K, V, dK and dV (Tk rows)
in bf16 and the f32 lse and Δ, each moved once; the larger of the two
times (``work/counts.py::bound_s``).  Recompute and split products are
not counted, so the share cannot pass 100%.  None on a card that
``work/peaks.json`` lacks."""

from portbench.work.counts import bound_s


def flash_bwd_call(bh: int, t: int, tk: int, d: int, causal: bool) -> dict:
    flops = 10.0 * bh * t * tk * d * (0.5 if causal else 1.0)
    nbytes = 2.0 * bh * d * (4 * t + 4 * tk) + 4.0 * 2 * bh * t
    return {"flops": flops, "bytes": nbytes}


def read(ctx):
    trace = ctx.host_trace
    ops = trace.launched_under("_Flash3Backward",
                               trace.device_ops(trace.window()))
    if not ops or ctx.peaks is None:
        return None
    s = ctx.shape
    work = flash_bwd_call(ctx.batch * s["n_head"], ctx.seq, ctx.seq,
                          s["d_model"] // s["n_head"], s["causal"])
    calls = s["n_layer"] * ctx.traced_steps
    bound = bound_s(work["flops"], work["bytes"], ctx.peaks) * calls
    spent = sum(op.end - op.start for op in ops) * 1e-6
    return 100.0 * bound / spent
