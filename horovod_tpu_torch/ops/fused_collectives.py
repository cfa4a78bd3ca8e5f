"""Fused collectives: the int8 wire, the sharded optimizer's all-gather
+ apply, and the FSDP unshard epilogue.

Counterpart of the public entry points of
``horovod_tpu/ops/pallas_collectives.py`` (``docs/fused_collectives.md``).

* :func:`fused_quantize_reducescatter`, :func:`fused_quantize_allgather`
  and :func:`fused_allreduce` are the port's int8 wire
  (:mod:`.quantization`) under the reference's names: its phases already
  run the hand-written kernels B2–B4, so it is the fused tier.
* :func:`fused_allgather_sgd_apply` and :func:`fused_allgather_adam_apply`
  quantize this rank's reduced gradient shard, all-gather payload and
  scales, and apply the SGD or Adam leaf update in one kernel pass over
  the gathered int8 rows (:mod:`.apply_kernels`, B6 and B7): the f32
  gradient of the whole leaf is never written to device memory.
* :func:`fused_matmul_allgather` computes ``x @ w_shard`` in kernel B5
  (:mod:`.matmul_kernel`) and all-gathers the activation tile, so the
  gathered weight never exists.

Every function takes an optional ``group`` (a ``torch.distributed``
process group, the default group when None) in place of the
reference's ``axis``/``groups``; in a world of one it runs the
reference's ``n == 1`` path.  The reference's Pallas tile sizes
(``block_m``/``block_n``/``block_k``) are not arguments: the kernels
choose their own tiles.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .apply_kernels import adam_apply, sgd_apply
from .matmul_kernel import blocked_matmul
from .quantization import (_world, gather_quantized, int8_allgather,
                           int8_allreduce, int8_reducescatter)

fused_quantize_reducescatter = int8_reducescatter
fused_quantize_allgather = int8_allgather
fused_allreduce = int8_allreduce


def _flat_f32(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).to(torch.float32).contiguous()


def _check_leaf(param: torch.Tensor, n: int, k: int) -> None:
    if param.numel() != n * k:
        raise ValueError(f"leaf of {param.numel()} elements is not {n} "
                         f"shards of {k}")


def fused_allgather_sgd_apply(param: torch.Tensor, grad_shard: torch.Tensor,
                              *, lr: float, group=None,
                              block_size: int = 1024) -> torch.Tensor:
    """All-gather this rank's reduced gradient shard on the int8 wire and
    apply ``p - lr * g`` to the flat ``[n * shard]`` leaf ``param`` in one
    kernel pass.  Returns the updated leaf, shaped and typed like
    ``param``.  The dequantized gradient is bit for bit
    ``int8_allgather``'s."""
    n = _world(group)
    if n == 1:
        g = grad_shard.to(torch.float32).reshape(-1)
        return (param.reshape(-1).to(torch.float32) - lr * g).to(
            param.dtype).reshape(param.shape)
    q, s, k = gather_quantized(grad_shard, group=group, block_size=block_size)
    _check_leaf(param, n, k)
    new_p = sgd_apply(q, s, _flat_f32(param), lr=lr)
    return new_p.to(param.dtype).reshape(param.shape)


def fused_allgather_adam_apply(param: torch.Tensor, mu: torch.Tensor,
                               nu: torch.Tensor, grad_shard: torch.Tensor, *,
                               lr: float, step: int, b1: float = 0.9,
                               b2: float = 0.999, eps: float = 1e-8,
                               group=None, block_size: int = 1024):
    """All-gather this rank's reduced gradient shard on the int8 wire and
    apply the Adam leaf update (moments and bias correction, the
    ``optax.adam`` shape) in one kernel pass.  ``step`` is the 1-based
    update count of the bias correction.  Returns ``(param, mu, nu)``
    updated, each shaped and typed like its input."""
    if step < 1:
        raise ValueError(f"step must be >= 1 for bias correction, "
                         f"got {step}")
    n = _world(group)
    bc1 = 1.0 - float(b1) ** int(step)
    bc2 = 1.0 - float(b2) ** int(step)
    if n == 1:
        g = grad_shard.to(torch.float32).reshape(param.shape)
        m_new = b1 * mu.to(torch.float32) + (1 - b1) * g
        v_new = b2 * nu.to(torch.float32) + (1 - b2) * (g * g)
        upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        return ((param.to(torch.float32) - lr * upd).to(param.dtype),
                m_new.to(mu.dtype), v_new.to(nu.dtype))
    q, s, k = gather_quantized(grad_shard, group=group, block_size=block_size)
    _check_leaf(param, n, k)
    new_p, new_m, new_v = adam_apply(
        q, s, _flat_f32(param), _flat_f32(mu), _flat_f32(nu), lr=float(lr),
        b1=float(b1), b2=float(b2), eps=float(eps), bc1=bc1, bc2=bc2)
    return (new_p.to(param.dtype).reshape(param.shape),
            new_m.to(mu.dtype).reshape(mu.shape),
            new_v.to(nu.dtype).reshape(nu.shape))


def fused_matmul_allgather(x: torch.Tensor, w_shard: torch.Tensor, *,
                           group=None) -> torch.Tensor:
    """The FSDP unshard epilogue: ``x [M, K] @ w_shard [K, N/n]`` in
    kernel B5, then an all-gather of the ``[M, N/n]`` activation tile.
    Returns ``[M, N]`` in x's dtype with the ranks' columns in rank
    order, equal to ``x @`` the column-gathered weight.  In a world of
    one the kernel's tile is the result."""
    y = blocked_matmul(x.contiguous(), w_shard.contiguous())
    n = _world(group)
    if n == 1:
        return y
    mm, nl = y.shape
    gathered = y.new_empty((n * mm, nl))
    dist.all_gather_into_tensor(gathered, y, group=group)
    return gathered.reshape(n, mm, nl).transpose(0, 1).reshape(mm, -1)
