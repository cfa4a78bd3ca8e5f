"""The sharded optimizer's fused apply kernels: dequantize the gathered
int8 gradient and apply the SGD or the Adam leaf update in one pass.

Counterparts of ``horovod_tpu/ops/pallas_collectives.py``'s
``_sgd_kernel`` and ``_adam_kernel`` (launched through
``_apply_gridded``).  The CUDA source is ``csrc/fused_apply.cu``.

The gradient arrives as the int8 all-gather left it: payload ``q``
``[n, m, b]`` and scales ``s`` ``[n, m]``, contributor ``c``'s shard of
``k`` elements as ``m`` blocks of ``b`` (the last one zero padded on the
wire).  The parameter and the moments are flat ``[n * k]`` f32 leaves.
The gradient is ``q * s`` in f32, bit for bit the all-gather's, and the
update is the reference's, operation by operation in its order:

* SGD: ``p - lr * g``;
* Adam: ``m' = b1 m + (1 - b1) g``, ``v' = b2 v + (1 - b2) (g g)``,
  ``p - lr ((m' / bc1) / (sqrt(v' / bc2) + eps))``.

Each constant is the f32 rounding of a Python double, as the reference's
weak-typed Python floats are; ``1 - b1`` is taken in double before it is
rounded.  The plain versions hold the constants as 0-dim f32 tensors on
the operands' device, so every product and quotient is a plain f32
operation (PyTorch multiplies by the reciprocal when a CUDA tensor is
divided by a Python number), and equal their kernels bit for bit.

Both kernels are bound by bytes; see the note at the top of the CUDA
source.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .kernel_common import (check_operand, kernel, on_card, raise_on_error,
                            stream_of)

_P, _I64, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_signatures = {
    "hvd_sgd_apply": [_P, _P, _P, _P, _I64, _I64, ctypes.c_int, _I64, _F, _P],
    "hvd_adam_apply": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                       ctypes.c_int, _I64, _F, _F, _F, _F, _F, _F, _F, _F,
                       _P],
}


def _lib() -> ctypes.CDLL:
    return _build.load("fused_apply", _signatures)


def _layout(q: torch.Tensor, s: torch.Tensor, p: torch.Tensor,
            ) -> Tuple[int, int, int, int]:
    """``(n, m, b, k)`` of the gathered wire and a flat ``[n * k]``
    leaf; raises where the shapes do not fit together."""
    if q.dim() != 3 or tuple(s.shape) != tuple(q.shape[:2]):
        raise ValueError(f"expected q [n, m, b] and s [n, m]; got "
                         f"{tuple(q.shape)} and {tuple(s.shape)}")
    n, m, b = q.shape
    if p.dim() != 1 or n == 0 or p.numel() % n:
        raise ValueError(f"leaf {tuple(p.shape)} is not flat [n * k] for "
                         f"n = {n}")
    k = p.numel() // n
    if m != -(-k // max(b, 1)):
        raise ValueError(f"{m} blocks of {b} do not hold a shard of {k}")
    return n, m, b, k


def _gathered_grad(q: torch.Tensor, s: torch.Tensor, k: int) -> torch.Tensor:
    """The dequantized gradient as a flat ``[n * k]`` leaf."""
    n = q.shape[0]
    g = q.to(torch.float32) * s[..., None]
    return g.reshape(n, -1)[:, :k].reshape(-1)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


# --- plain versions -----------------------------------------------------------

def sgd_apply_plain(q, s, p, *, lr: float) -> torch.Tensor:
    k = _layout(q, s, p)[3]
    return p - _f32(lr, p) * _gathered_grad(q, s, k)


def adam_apply_plain(q, s, p, mu, nu, *, lr: float, b1: float, b2: float,
                     eps: float, bc1: float, bc2: float):
    g = _gathered_grad(q, s, _layout(q, s, p)[3])
    m_new = _f32(b1, p) * mu + _f32(1.0 - b1, p) * g
    v_new = _f32(b2, p) * nu + _f32(1.0 - b2, p) * (g * g)
    update = (m_new / _f32(bc1, p)) / (torch.sqrt(v_new / _f32(bc2, p))
                                       + _f32(eps, p))
    return p - _f32(lr, p) * update, m_new, v_new


# --- kernel wrappers ----------------------------------------------------------

@kernel
def sgd_apply(q: torch.Tensor, s: torch.Tensor, p: torch.Tensor, *,
              lr: float) -> torch.Tensor:
    """Gathered int8 gradient (q ``[n, m, b]``, s ``[n, m]``) and a flat
    f32 leaf ``[n * k]`` → the SGD update ``p - lr * g``, a new leaf.
    Bound by bytes (9 B an element)."""
    n, m, b, k = _layout(q, s, p)
    if not on_card(q):
        return sgd_apply_plain(q, s, p, lr=lr)
    check_operand(q, "q", (torch.int8,), 3)
    check_operand(s, "s", (torch.float32,), 2)
    check_operand(p, "p", (torch.float32,), 1)
    out = torch.empty_like(p)
    if out.numel():
        rc = _lib().hvd_sgd_apply(q.data_ptr(), s.data_ptr(), p.data_ptr(),
                                  out.data_ptr(), n * m, m, b, k, lr,
                                  stream_of(q))
        raise_on_error(rc, "sgd_apply")
        sgd_apply.launches += 1
    return out


@kernel
def adam_apply(q: torch.Tensor, s: torch.Tensor, p: torch.Tensor,
               mu: torch.Tensor, nu: torch.Tensor, *, lr: float, b1: float,
               b2: float, eps: float, bc1: float, bc2: float):
    """Gathered int8 gradient and flat f32 leaves p, mu, nu ``[n * k]``
    → ``(p', mu', nu')``, the Adam update with bias corrections ``bc1``
    and ``bc2``.  Bound by bytes (25 B an element)."""
    n, m, b, k = _layout(q, s, p)
    if not on_card(q):
        return adam_apply_plain(q, s, p, mu, nu, lr=lr, b1=b1, b2=b2,
                                eps=eps, bc1=bc1, bc2=bc2)
    check_operand(q, "q", (torch.int8,), 3)
    check_operand(s, "s", (torch.float32,), 2)
    for name, t in (("p", p), ("mu", mu), ("nu", nu)):
        check_operand(t, name, (torch.float32,), 1)
        if t.shape != p.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(p.shape)}")
    outs = [torch.empty_like(p) for _ in range(3)]
    if p.numel():
        rc = _lib().hvd_adam_apply(
            q.data_ptr(), s.data_ptr(), p.data_ptr(), mu.data_ptr(),
            nu.data_ptr(), *(o.data_ptr() for o in outs), n * m, m, b, k,
            lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, bc1, bc2, stream_of(q))
        raise_on_error(rc, "adam_apply")
        adam_apply.launches += 1
    return tuple(outs)
