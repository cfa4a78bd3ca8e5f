"""The one traffic generator: a pool of batches from a traffic file.

A traffic file (``traffic/<name>.json``) gives the batch a rank takes,
the sequence length, how many distinct batches the pool holds
(``pool_batches``), and for masked-LM the masking rule.  The pool is
drawn for the whole world at once on the device, from the seed, in a
few calls: every rank draws the same global pool and takes its own rows,
so the reference can rebuild any rank's batch.  Step ``s`` takes pool
batch ``s % pool_batches``; every seed gives the same sizes.

Kinds:

- ``causal_lm``: random tokens ``[rows, seq_len + 1]`` in
  ``[token_low, vocab)``; the batch is ``(inputs, targets)``, the
  targets shifted by one.
- ``masked_lm``: random tokens in ``[token_low, vocab)`` between
  ``cls_token`` and ``sep_token``; of the positions between them,
  ``round(mask_share * (seq_len - 2))`` a row are chosen, and each is
  replaced by ``mask_token``, by a random token or kept, with the shares
  of ``replace`` (BERT's 80/10/10).  The batch is ``(input_ids,
  labels, label_mask)``: the labels are the original tokens, the mask
  1 at the chosen positions.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .seeds import generator


class Pool:
    """``pool_batches`` global batches; :meth:`batch` cuts a rank's rows."""

    def __init__(self, traffic: dict, vocab: int, seed: int, world: int,
                 device) -> None:
        self.rows = int(traffic["batch_per_rank"])
        self.size = int(traffic["pool_batches"])
        kind = traffic["kind"]
        if kind == "causal_lm":
            self._global = _causal_lm(traffic, vocab, seed, world, device)
        elif kind == "masked_lm":
            self._global = _masked_lm(traffic, vocab, seed, world, device)
        else:
            raise ValueError(f"unknown traffic kind {kind!r}")

    def batch(self, step: int, rank: int) -> Tuple[torch.Tensor, ...]:
        """Rank ``rank``'s batch of step ``step`` (0-based), contiguous."""
        i = step % self.size
        lo, hi = rank * self.rows, (rank + 1) * self.rows
        return tuple(t[i, lo:hi].contiguous() for t in self._global)

    def rank_batches(self, rank: int) -> List[Tuple[torch.Tensor, ...]]:
        """Every pool batch of ``rank``, made once so the window only
        indexes a list."""
        return [self.batch(i, rank) for i in range(self.size)]


def _causal_lm(traffic, vocab, seed, world, device):
    p, rows = int(traffic["pool_batches"]), world * int(traffic["batch_per_rank"])
    t = int(traffic["seq_len"])
    tokens = torch.randint(int(traffic["token_low"]), vocab, (p, rows, t + 1),
                           generator=generator(seed, "tokens", device),
                           device=device)
    return tokens[..., :-1], tokens[..., 1:]


def _masked_lm(traffic, vocab, seed, world, device):
    p, rows = int(traffic["pool_batches"]), world * int(traffic["batch_per_rank"])
    t = int(traffic["seq_len"])
    gen = generator(seed, "tokens", device)
    low = int(traffic["token_low"])
    labels = torch.randint(low, vocab, (p, rows, t), generator=gen,
                           device=device)
    labels[..., 0] = int(traffic["cls_token"])
    labels[..., -1] = int(traffic["sep_token"])
    k = round(float(traffic["mask_share"]) * (t - 2))
    # k positions of 1..t-2 a row, uniformly: the k smallest of t-2 draws.
    chosen = torch.rand((p, rows, t - 2), generator=gen,
                        device=device).argsort(dim=-1)[..., :k] + 1
    label_mask = torch.zeros((p, rows, t), dtype=torch.int64, device=device)
    label_mask.scatter_(-1, chosen, 1)
    share = traffic["replace"]
    u = torch.rand((p, rows, k), generator=gen, device=device)
    randoms = torch.randint(low, vocab, (p, rows, k), generator=gen,
                            device=device)
    original = labels.gather(-1, chosen)
    replaced = torch.where(
        u < share["mask"], torch.full_like(original, int(traffic["mask_token"])),
        torch.where(u < share["mask"] + share["random"], randoms, original))
    input_ids = labels.scatter(-1, chosen, replaced)
    return input_ids, labels, label_mask
