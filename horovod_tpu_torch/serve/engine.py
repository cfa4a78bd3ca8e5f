"""Continuous-batching inference engine over the port's ``GPT``.

Counterpart of ``horovod_tpu/serve/engine.py``.  The serving hot path
is two programs, eager torch under ``torch.inference_mode()``:

* **prefill** — one program per *length bucket* ``L``: run the prompt
  (padded to ``L``) through the model, sample the first token, and
  write its K/V into this request's cache.  With prefix sharing the
  bucket is chosen for the *suffix*: a prompt whose leading tokens are
  resident in the KV pool recomputes only what is not cached.
* **decode** — ONE program for the whole slot batch: every active
  request advances per call, each slot at its own depth, so admission
  never waits for the batch to drain.

Two KV layouts live under this one API (``HVD_TPU_SERVE_KV``):

* **paged** (default) — one ``[num_blocks, block, H, D]`` pool per
  layer plus a host-side block table (``serve/kv/``): refcounted token
  blocks, prefix sharing with copy-on-write, LRU eviction.  The
  programs index the pool *through* a per-slot block table, so the
  table is data, not shape.  Block 0 is the reserved *trash block*:
  unmapped table entries point at it and invalid positions (padding,
  rejected speculative tokens, past-the-cache) route into it.
* **dense** — per-slot ``[slots, S, H, D]`` rows; the token-identity
  oracle the paged path is tested against.

**Speculative decoding** (``SamplingParams(spec=True)``; greedy
requests only): a drafter model proposes ``HVD_TPU_SERVE_SPEC_K``
tokens per step, the target verifies the whole draft in ONE batched
forward, and the accepted prefix makes the emitted tokens identical to
plain greedy decode.

Sampling is greedy / temperature / top-k, resolved **per slot** in the
one decode program, so mixed sampling configs batch together.

Where the port differs from the reference on purpose:

* the caches are torch tensors written in place; no program returns a
  new pool, and no pool is reallocated on the hot path;
* sampling draws from an explicit ``torch.Generator`` on the model's
  device, seeded from ``seed`` (the reference splits a JAX PRNG key).
  Greedy tokens equal the reference's; sampled tokens reproduce within
  the port for a given seed.  :meth:`export_rng` and
  ``resume_slot(rng=)`` carry the generator's state;
* eager torch has no trace: ``trace_counts`` counts each program's
  first call on a new shape (one per prefill bucket, one decode), the
  port's counterpart of a trace;
* the engine takes the port's :class:`~..models.transformer.GPT`
  module, which holds its parameters, where the reference takes
  ``(model, params)``; a drafter is such a module too;
* a tensor-parallel replica (``tp > 1``) is one process over an explicit
  list of shard devices (``devices=``, passed to ``plan.tp_plan(tp,
  devices=)``; the counterpart of the reference's ``tensor`` mesh): the
  model becomes :func:`~..models.transformer.tensor_parallel_replica`
  (``qkv`` and ``up`` column slices on each shard's device, everything
  else once on the first shard's device) and each shard's device holds
  the ``H / tp`` heads of every pool block.  With no ``devices`` the
  first ``tp`` CUDA devices are used, and fewer raise.

Threads: the batcher's thread drives the card (start, step, resume,
preempt, import).  Handler threads call :meth:`release` and read slot
state; those touch host arrays only, under ``_slot_lock``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..models.transformer import (ColumnShards, GPT, init_kv_cache,
                                  tensor_parallel_replica)
from .kv import BlockPool, TRASH_BLOCK

def resolved_config():
    """The serving layer's config: the live Config when this process
    ran ``hvd.init``, else a fresh parse of the environment (the same
    parser and defaults)."""
    from .. import basics
    from ..config import Config

    return basics.config() if basics.is_initialized() else Config.from_env()


class PromptTooLongError(ValueError):
    """Prompt exceeds the largest prefill bucket / cache length."""


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (greedy when ``temperature == 0``).
    ``spec=True`` opts the request into speculative decoding (engines
    built with a drafter; greedy requests only — temperature rows in
    the same batch keep plain single-token semantics)."""

    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0                 # 0 = full vocab
    stop_token: Optional[int] = None
    spec: bool = False


def _sample(logits, gen: torch.Generator, temps, topks):
    """Per-row sampling over ``[B, V]`` float32 logits: greedy rows
    (``temp <= 0``) take argmax; the rest draw from temperature-scaled
    logits restricted to each row's top-k.  Ranks come from a stable
    double argsort, so ties mask as the reference's do.  The draw is
    Gumbel-max on uniforms from ``gen``; every call draws ``[B, V]``,
    so the generator advances the same way whatever the rows hold."""
    v = logits.shape[-1]
    greedy = logits.argmax(dim=-1)
    order = torch.argsort(-logits, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    k = torch.where(topks > 0, topks, v)[:, None]
    masked = torch.where(ranks < k, logits, -torch.inf)
    scaled = masked / temps.clamp_min(1e-6)[:, None]
    u = torch.rand(scaled.shape, generator=gen, device=scaled.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    sampled = (scaled + gumbel).argmax(dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled)


def _flat_tree(tree: Mapping, prefix: str = "") -> dict:
    """A nested param tree (flax's layout) or a flat ``{name: array}``
    as ``{dotted name: array}``."""
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flat_tree(val, name + "."))
        else:
            flat[name] = val
    return flat


class InferenceEngine:
    """Slot-based prefill/decode engine; the batcher owns scheduling.

    ``start(slot, prompt, sampling)`` prefills a request into ``slot``
    and returns its first token; ``step()`` decodes for every active
    slot and returns ``{slot: [tokens]}`` — one token per slot on the
    plain path, up to ``spec_k + 1`` under speculative decoding.
    Per-phase wall time lands on the timeline (phases
    ``SERVE_PREFILL`` / ``SERVE_DECODE``) when one is active.  The
    engine runs on the model's device.
    """

    def __init__(self, model: GPT, *,
                 max_slots: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 max_seq_len: Optional[int] = None,
                 kv_cache: Optional[str] = None,
                 kv_block: Optional[int] = None,
                 kv_blocks: Optional[int] = None,
                 drafter: Optional[GPT] = None,
                 spec_k: Optional[int] = None,
                 tp: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 weights_version: int = 0,
                 seed: int = 0):
        cfg = resolved_config()
        mcfg = model.config
        self._model = model
        self._dev = next(model.parameters()).device
        # Reference names and shapes of the weights (the swap's tree).
        self._param_shapes = {n: tuple(p.shape)
                              for n, p in model.named_parameters()}
        self.max_slots = int(max_slots or cfg.serve_max_batch)
        self.max_seq_len = int(max_seq_len or mcfg.max_seq_len)
        if self.max_seq_len > mcfg.max_seq_len:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the model's "
                f"positional table ({mcfg.max_seq_len})")
        buckets = tuple(prefill_buckets or cfg.serve_prefill_buckets)
        # Clamp buckets to the cache length; keep at least one.
        self.prefill_buckets = tuple(sorted(
            {min(int(b), self.max_seq_len) for b in buckets if b > 0}))
        if not self.prefill_buckets:
            raise ValueError(f"no usable prefill buckets in {buckets}")
        self.kv_mode = (kv_cache or cfg.serve_kv).lower()
        if self.kv_mode not in ("paged", "dense"):
            raise ValueError(f"unknown kv_cache mode {self.kv_mode!r}; "
                             f"expected 'paged' or 'dense'")
        # Tensor-parallel replica: the forward shards over ``devices``
        # (column-parallel qkv/up, heads through attention, the head
        # outputs and gelu(up) gathered in shard order before the
        # replicated out/down), so the logits are tp=1's wherever a
        # column slice of a product rounds as the whole product does.
        # The paged pool shards on its head dim (each shard's device
        # holds H/tp heads of every block) while the block table and
        # the BlockPool bookkeeping stay one host state.
        self.tp = int(tp if tp is not None else cfg.serve_tp)
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        self.devices = (self._dev,)
        if self.tp > 1:
            if self.kv_mode != "paged":
                raise ValueError(
                    "tensor-parallel serving requires the paged KV "
                    "cache (HVD_TPU_SERVE_KV=paged) — the head-sharded "
                    "pool is the TP layout")
            if mcfg.n_head % self.tp:
                raise ValueError(
                    f"tp={self.tp} must divide the model's head count "
                    f"({mcfg.n_head}) for the head-sharded pool")
            from ..plan import tp_plan

            self.devices = tp_plan(
                self.tp, devices=devices if devices is not None else "cuda")
            self._model = model = tensor_parallel_replica(model,
                                                          self.devices)
            self._dev = self.devices[0]
        elif devices is not None:
            raise ValueError("devices= lists a tensor-parallel replica's "
                             "shards; tp=1 runs on the model's device")
        # Slot state: every mutation goes through the guarded helpers
        # below (_bind_slot / _advance_slot / _clear_slot) — release()
        # arrives from RPC handler threads while the batcher thread is
        # mid-step.
        self._slot_lock = threading.Lock()
        self._positions = np.zeros(self.max_slots, np.int64)   # guarded-by: _slot_lock
        self._active = np.zeros(self.max_slots, bool)          # guarded-by: _slot_lock
        self._temps = np.zeros(self.max_slots, np.float32)     # guarded-by: _slot_lock
        self._topks = np.zeros(self.max_slots, np.int64)       # guarded-by: _slot_lock
        self._last_tokens = np.zeros(self.max_slots, np.int64)  # guarded-by: _slot_lock
        self._spec = np.zeros(self.max_slots, bool)            # guarded-by: _slot_lock
        self._prefix_hits = np.zeros(self.max_slots, np.int64)  # guarded-by: _slot_lock
        # Weight hot-swap state: the running version and the staged
        # next version awaiting the batcher's flip barrier.
        self._weights_version = int(weights_version)  # guarded-by: _slot_lock
        self._staged_params = None                    # guarded-by: _slot_lock
        self._staged_version = None                   # guarded-by: _slot_lock
        self._gen = torch.Generator(device=self._dev).manual_seed(seed)
        # First-call counters: each program bumps its key the first
        # time it runs on a shape (the bounded-recompile contract).
        self.trace_counts = collections.Counter()
        self._seen = set()
        n_layer = mcfg.n_layer
        head_dim = mcfg.d_model // mcfg.n_head
        with torch.inference_mode():
            if self.kv_mode == "paged":
                self.kv_block = int(kv_block or cfg.serve_kv_block)
                if self.kv_block < 1:
                    raise ValueError(f"kv_block must be >= 1, got "
                                     f"{self.kv_block}")
                self.blocks_per_slot = -(-self.max_seq_len // self.kv_block)
                floor = 1 + self.max_slots * self.blocks_per_slot
                budget = int(kv_blocks if kv_blocks is not None
                             else cfg.serve_kv_blocks)
                if budget == 0:
                    # Auto: every slot fully servable plus an equal
                    # share of prefix-cache headroom.
                    budget = 1 + 2 * self.max_slots * self.blocks_per_slot
                if budget < floor:
                    raise ValueError(
                        f"KV pool budget {budget} below the floor {floor} "
                        f"(1 trash + slots x blocks_per_slot) — active "
                        f"requests could deadlock on allocation")
                self.kv_blocks = budget
                heads = mcfg.n_head // self.tp
                shape = (budget, self.kv_block, heads, head_dim)
                # One pool list a shard (its heads of every block, on
                # its device); ``_pools`` (the reference's name) is
                # tp=1's single list.
                self._shard_pools = [
                    [{"k": torch.zeros(shape, dtype=mcfg.dtype, device=d),
                      "v": torch.zeros(shape, dtype=mcfg.dtype, device=d)}
                     for _ in range(n_layer)]
                    for d in self.devices]
                self._pools = self._shard_pools[0] if self.tp == 1 else None
                # Block table: one trailing trash column the programs
                # route invalid positions into (serve/kv/pool.py).
                self._table = np.full(
                    (self.max_slots, self.blocks_per_slot + 1),
                    TRASH_BLOCK, np.int64)
                dt_size = torch.empty((), dtype=mcfg.dtype).element_size()
                self._kv = BlockPool(
                    budget, self.kv_block, self._table, self._copy_block,
                    heads=heads, tp_degree=self.tp,
                    # Per-SHARD bytes of one block: K+V rows for the
                    # H/tp heads a shard holds, across every layer.
                    bytes_per_block=(2 * n_layer * self.kv_block
                                     * heads * head_dim * dt_size))
                self._caches = None
            else:
                self.kv_block = 0
                self.kv_blocks = 0
                self._kv = None
                self._caches = init_kv_cache(mcfg, self.max_slots,
                                             self.max_seq_len, self._dev)
        # Speculative decoding: the drafter and its dense cache.
        self._drafter = None
        self._drafter_caches = None
        self.spec_k = int(spec_k or cfg.serve_spec_k)
        self.spec_verify_steps = 0
        self.spec_accepted_tokens = 0
        if drafter is not None:
            if self.kv_mode != "paged":
                raise ValueError("speculative decoding requires the "
                                 "paged KV cache (HVD_TPU_SERVE_KV=paged)")
            dcfg = drafter.config
            if dcfg.max_seq_len < self.max_seq_len:
                raise ValueError(
                    f"drafter positional table ({dcfg.max_seq_len}) "
                    f"shorter than the serving cache ({self.max_seq_len})")
            if dcfg.vocab_size != mcfg.vocab_size:
                raise ValueError(
                    f"drafter vocabulary ({dcfg.vocab_size}) differs from "
                    f"the model's ({mcfg.vocab_size})")
            if next(drafter.parameters()).device != self._dev:
                raise ValueError("the drafter must live on the model's "
                                 "device (a tensor-parallel replica's "
                                 "first shard device)")
            self._drafter = drafter
            with torch.inference_mode():
                self._drafter_caches = init_kv_cache(
                    dcfg, self.max_slots, self.max_seq_len, self._dev)

    # --- paged-view geometry ------------------------------------------------

    @property
    def _view_len(self) -> int:
        """Gathered per-slot view length: chain blocks + the trash
        column — always > max_seq_len, so invalid positions land in
        trash rows no valid query can see."""
        return (self.blocks_per_slot + 1) * self.kv_block

    def _trace(self, key: str) -> None:
        """Count ``key``'s first call (the port's trace)."""
        if key not in self._seen:
            self._seen.add(key)
            self.trace_counts[key] += 1

    def _tensor(self, a, dtype=torch.int64):
        """A copy of host array ``a`` on the engine's device (a copy on
        the CPU too: the block table changes under handler threads)."""
        return torch.tensor(np.asarray(a), dtype=dtype, device=self._dev)

    def _scalars(self, temp: float, topk: int):
        return (torch.tensor([temp], dtype=torch.float32, device=self._dev),
                torch.tensor([topk], dtype=torch.int64, device=self._dev))

    # --- programs: dense tier ---------------------------------------------

    def _prefill_dense(self, L: int, tokens, length: int, slot: int,
                       temp: float, topk: int) -> int:
        self._trace(f"prefill_{L}")
        model = self._model
        positions = torch.arange(L, device=self._dev)[None]
        row = init_kv_cache(model.config, 1, L, self._dev)
        logits, row = model(tokens, kv_caches=row, positions=positions)
        t, k = self._scalars(temp, topk)
        token = _sample(logits[0, length - 1][None].float(), self._gen,
                        t, k)[0]
        for cache, chunk in zip(self._caches, row):
            cache["k"][slot, :L] = chunk["k"][0]
            cache["v"][slot, :L] = chunk["v"][0]
        return int(token)

    def _decode_dense(self, tokens, positions, temps, topks):
        self._trace("decode")
        logits, _ = self._model(tokens[:, None], kv_caches=self._caches,
                                positions=positions[:, None])
        return _sample(logits[:, -1].float(), self._gen, temps, topks)

    # --- programs: paged tier ---------------------------------------------

    def _paged_caches(self, tables):
        """The model's per-block caches over the pools; under tp each
        block's is a list, one cache a shard (its pools, the table on
        its device)."""
        if self.tp == 1:
            return [{"k_pool": p["k"], "v_pool": p["v"], "table": tables}
                    for p in self._pools]
        shard_tables = [tables.to(d) for d in self.devices]
        return [[{"k_pool": pools[i]["k"], "v_pool": pools[i]["v"],
                  "table": t}
                 for pools, t in zip(self._shard_pools, shard_tables)]
                for i in range(len(self._shard_pools[0]))]

    def _scatter_chunk(self, chunk, blk, off) -> None:
        """Write chunk K/V rows into the pools at ``(blk, off)`` (flat
        index tensors; invalid rows already routed to the trash block).
        Many invalid rows may hit the same trash row: no valid query
        reads it, so the order of those writes does not matter.  Under
        tp each block's chunk is a list, one a shard."""
        for s, (dev, pools) in enumerate(zip(self.devices,
                                             self._shard_pools)):
            b, o = blk.to(dev), off.to(dev)
            for pool, c in zip(pools, chunk):
                c = c if self.tp == 1 else c[s]
                kc = c["k"].reshape((-1,) + c["k"].shape[-2:])
                vc = c["v"].reshape((-1,) + c["v"].shape[-2:])
                pool["k"][b, o] = kc.to(pool["k"].dtype)
                pool["v"][b, o] = vc.to(pool["v"].dtype)

    def _copy_block(self, src: int, dst: int) -> None:
        """Device block copy (COW / partial-prefix admission) — the
        callback :class:`BlockPool` drives; every shard copies its
        heads."""
        self._trace("kv_copy")
        with torch.inference_mode():
            for pools in self._shard_pools:
                for p in pools:
                    p["k"][dst] = p["k"][src]
                    p["v"][dst] = p["v"][src]

    def _prefill_paged(self, L: int, table_row, tokens, start: int,
                       length: int, temp: float, topk: int) -> int:
        """``start`` = resident-prefix length (the suffix's first
        absolute position); ``length`` = real suffix tokens in the
        L-padded chunk."""
        self._trace(f"prefill_{L}")
        B, S, SV = self.kv_block, self.max_seq_len, self._view_len
        idx = torch.arange(L, device=self._dev)
        valid = (idx < length) & (start + idx < S)
        positions = torch.where(valid, start + idx, SV - 1)
        logits, chunk = self._model(
            tokens, kv_caches=self._paged_caches(table_row[None]),
            positions=positions[None])
        t, k = self._scalars(temp, topk)
        token = _sample(logits[0, length - 1][None].float(), self._gen,
                        t, k)[0]
        self._scatter_chunk(chunk, table_row[positions // B], positions % B)
        return int(token)

    def _decode_paged(self, tables, tokens, positions, temps, topks):
        self._trace("decode")
        logits, chunk = self._model(
            tokens[:, None], kv_caches=self._paged_caches(tables),
            positions=positions[:, None])
        nxt = _sample(logits[:, -1].float(), self._gen, temps, topks)
        B = self.kv_block
        col = (positions // B).clamp(max=self.blocks_per_slot)
        blk = tables.gather(1, col[:, None])[:, 0]
        self._scatter_chunk(chunk, blk, positions % B)
        return nxt

    # --- programs: speculative tier ---------------------------------------

    def _draft_prefill(self, L: int, tokens, slot: int) -> None:
        self._trace(f"draft_prefill_{L}")
        drafter = self._drafter
        positions = torch.arange(L, device=self._dev)[None]
        row = init_kv_cache(drafter.config, 1, L, self._dev)
        _, row = drafter(tokens, kv_caches=row, positions=positions)
        for cache, chunk in zip(self._drafter_caches, row):
            cache["k"][slot, :L] = chunk["k"][0]
            cache["v"][slot, :L] = chunk["v"][0]

    def _spec_draft(self, tokens, positions):
        """Greedy-draft ``spec_k`` tokens for every slot with the
        drafter's own dense decode, ``K + 1`` iterations: the extra one
        feeds the last draft token so its K/V lands too (a fully
        accepted draft starts the next step at ``p + K + 1``)."""
        self._trace("spec_draft")
        toks, pos = tokens, positions
        drafts = []
        for _ in range(self.spec_k + 1):
            logits, _ = self._drafter(toks[:, None],
                                      kv_caches=self._drafter_caches,
                                      positions=pos[:, None])
            toks = logits[:, -1].float().argmax(dim=-1)
            drafts.append(toks)
            pos = pos + 1
        # The drafter runs unsharded on the first shard's device, where
        # a tensor-parallel verify reads its draft.
        return torch.stack(drafts[:self.spec_k], dim=1).to(self._dev)

    def _spec_verify(self, tables, tokens, draft, positions, temps, topks,
                     spec_ok):
        """Verify the whole draft in one batched target forward.

        Chunk ``[t0, d1..dK]`` runs at positions ``p..p+K``; the
        accepted prefix is the longest run of drafts matching the
        target's own greedy chain, so the emitted tokens are exactly
        what plain greedy decode would produce.  Only chunk rows
        ``<= accepted`` persist their K/V — rejected rows scatter into
        the trash block.  Rows with ``spec_ok`` false accept nothing and
        emit one plain-sampled token."""
        self._trace("spec_verify")
        K = self.spec_k
        B, S, SV = self.kv_block, self.max_seq_len, self._view_len
        chunk_toks = torch.cat([tokens[:, None], draft], dim=1)
        idx = torch.arange(K + 1, device=self._dev)[None]
        pos = positions[:, None] + idx
        pos_safe = torch.where(pos < S, pos, SV - 1)
        logits, chunk = self._model(
            chunk_toks, kv_caches=self._paged_caches(tables),
            positions=pos_safe)
        logits = logits.float()
        greedy = logits.argmax(dim=-1)
        matches = (draft == greedy[:, :K]).to(torch.int64)
        accepted = torch.cumprod(matches, dim=1).sum(dim=1)
        accepted = torch.where(spec_ok, accepted, 0)
        # The last emitted token needs no K/V write, but every ACCEPTED
        # draft does — cap acceptance at the cache's remaining rows.
        accepted = torch.minimum(accepted,
                                 (S - 1 - positions).clamp_min(0))
        first = _sample(logits[:, 0], self._gen, temps, topks)
        out = greedy.clone()
        out[:, 0] = first
        keep = (idx <= accepted[:, None]) & (pos < S)
        pos_w = torch.where(keep, pos, SV - 1)
        blk = tables.gather(1, pos_w // B)
        self._scatter_chunk(chunk, blk.reshape(-1),
                            (pos_w % B).reshape(-1))
        return out, accepted

    # --- host-side slot API -------------------------------------------------

    def _activity(self, name: str, phase: str, args=None):
        """Timeline span for one serving phase (no-op without an active
        timeline)."""
        from .. import basics

        tl = basics.peek("timeline")   # fail-soft: None pre-init
        if tl is None or not tl.enabled:
            return contextlib.nullcontext()
        return tl.activity(name, phase, args)

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.prefill_buckets:
            if prompt_len <= b:
                return b
        raise PromptTooLongError(
            f"prompt of {prompt_len} tokens exceeds the largest prefill "
            f"bucket ({self.prefill_buckets[-1]})")

    def check_prompt(self, prompt_len: int) -> int:
        """Admission-time validation (the batcher calls this so an
        unservable prompt fails before it costs a queue entry): bucket
        fit AND room to generate.  Returns the bucket."""
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if prompt_len >= self.max_seq_len:
            raise PromptTooLongError(
                f"prompt of {prompt_len} tokens leaves no room to "
                f"generate (cache length {self.max_seq_len})")
        return self.bucket_for(prompt_len)

    def check_prompt_tokens(self, prompt: Sequence[int]) -> int:
        """:meth:`check_prompt` plus token-ID range validation: an
        out-of-vocab id must die at admission, before it can poison the
        shared pool (and torch's embedding would raise on it)."""
        bucket = self.check_prompt(len(prompt))
        vocab = self._model.config.vocab_size
        lo, hi = min(prompt), max(prompt)
        if lo < 0 or hi >= vocab:
            raise ValueError(
                f"prompt token id {lo if lo < 0 else hi} outside the "
                f"model vocabulary [0, {vocab})")
        return bucket

    def free_slots(self) -> List[int]:
        with self._slot_lock:
            return [int(s) for s in np.nonzero(~self._active)[0]]

    def active_slots(self) -> List[int]:
        with self._slot_lock:
            return [int(s) for s in np.nonzero(self._active)[0]]

    def slot_full(self, slot: int) -> bool:
        """True when the next decode would write past the cache."""
        with self._slot_lock:
            return int(self._positions[slot]) >= self.max_seq_len

    def _slot_snapshot(self):
        """Locked copy of the decode-relevant slot arrays: the step
        paths read ONE consistent view instead of racing handler-thread
        release() field by field."""
        with self._slot_lock:
            return (self._active.copy(), self._positions.copy(),
                    self._temps.copy(), self._topks.copy(),
                    self._last_tokens.copy(), self._spec.copy())

    # --- guarded slot-state mutation ----------------------------------------

    def _bind_slot(self, slot: int, n_prompt: int, token: int,
                   sampling: SamplingParams, prefix_hit: int) -> None:
        with self._slot_lock:
            self._active[slot] = True
            self._positions[slot] = n_prompt   # first generated index
            self._temps[slot] = sampling.temperature
            self._topks[slot] = sampling.top_k
            self._last_tokens[slot] = token    # first decode consumes it
            self._spec[slot] = bool(sampling.spec)
            self._prefix_hits[slot] = prefix_hit

    def _advance_slot(self, slot: int, tokens: List[int]) -> None:
        with self._slot_lock:
            if not self._active[slot]:
                return   # released concurrently (cancel): drop
            self._last_tokens[slot] = tokens[-1]
            self._positions[slot] += len(tokens)

    def _clear_slot(self, slot: int) -> None:
        with self._slot_lock:
            self._active[slot] = False
            self._positions[slot] = 0
            self._temps[slot] = 0.0
            self._topks[slot] = 0
            self._spec[slot] = False
            self._prefix_hits[slot] = 0

    # --- prefix sharing -----------------------------------------------------

    def prefix_probe(self, prompt: Sequence[int]) -> int:
        """Resident-prefix length for ``prompt`` right now (no side
        effects); 0 on the dense tier."""
        if self._kv is None:
            return 0
        return self._kv.probe(list(prompt))

    def prefix_hit_tokens(self, slot: int) -> int:
        """Prefix tokens the last ``start()`` on ``slot`` reused."""
        with self._slot_lock:
            return int(self._prefix_hits[slot])

    # --- request lifecycle --------------------------------------------------

    def _padded(self, seq: Sequence[int], L: int):
        padded = np.zeros((1, L), np.int64)
        padded[0, :len(seq)] = np.asarray(seq, np.int64)
        return self._tensor(padded)

    def _prefill_chunk(self, slot: int, seq: List[int], pos: int, ns: int,
                       sampling: SamplingParams) -> int:
        """One paged prefill of ``seq[pos:pos + ns]`` into ``slot``."""
        L = self.bucket_for(ns)
        self._kv.ensure_writable(slot, pos, ns)
        return self._prefill_paged(
            L, self._tensor(self._table[slot]),
            self._padded(seq[pos:pos + ns], L), pos, ns,
            sampling.temperature, sampling.top_k)

    def _drafter_prefill(self, slot: int, seq: List[int]) -> None:
        """The drafter recomputes the whole sequence (its dense cache
        shares nothing) — it is the small model by construction."""
        Lf = self.bucket_for(len(seq))
        self._draft_prefill(Lf, self._padded(seq, Lf), slot)

    def start(self, slot: int, prompt: Sequence[int],
              sampling: SamplingParams) -> int:
        """Prefill ``prompt`` into ``slot``; returns the first sampled
        token.  On the paged tier the bucket covers only the
        non-resident suffix."""
        with self._slot_lock:
            if self._active[slot]:
                raise RuntimeError(f"slot {slot} is already active")
        prompt = [int(t) for t in prompt]
        n = len(prompt)
        self.check_prompt_tokens(prompt)
        with torch.inference_mode():
            if self.kv_mode == "paged":
                hit = self._kv.begin_request(slot, prompt)
                ns = n - hit
                with self._activity(f"serve/slot{slot}", "SERVE_PREFILL",
                                    {"bucket": self.bucket_for(ns),
                                     "prompt_len": n, "prefix_hit": hit}):
                    token = self._prefill_chunk(slot, prompt, hit, ns,
                                                sampling)
                self._kv.index_prompt(slot, prompt)
            else:
                hit = 0
                L = self.bucket_for(n)
                with self._activity(f"serve/slot{slot}", "SERVE_PREFILL",
                                    {"bucket": L, "prompt_len": n}):
                    token = self._prefill_dense(
                        L, self._padded(prompt, L), n, slot,
                        sampling.temperature, sampling.top_k)
            if self._drafter is not None:
                self._drafter_prefill(slot, prompt)
        self._bind_slot(slot, n, token, sampling, hit)
        return token

    def step(self) -> Dict[int, List[int]]:
        """One decode step for every active slot → ``{slot: [tokens]}``
        (one token per slot on the plain path; up to ``spec_k + 1``
        under speculative decoding).  Inactive rows ride along and
        write into the trash block (paged) or their own free row."""
        snap = self._slot_snapshot()
        act, pos, temps, topks, last_tokens, spec = snap
        active = [int(s) for s in np.nonzero(act)[0]]
        if not active:
            return {}
        if self._drafter is not None and any(
                spec[s] and temps[s] <= 0 for s in active):
            return self._step_spec(active, snap)
        positions = np.where(act, pos, 0)
        with torch.inference_mode():
            args = (self._tensor(last_tokens), self._tensor(positions),
                    self._tensor(temps, torch.float32), self._tensor(topks))
            if self.kv_mode == "paged":
                for s in active:
                    self._kv.ensure_writable(s, int(positions[s]), 1)
                with self._activity("serve/decode", "SERVE_DECODE",
                                    {"batch": len(active)}):
                    nxt = self._decode_paged(self._tensor(self._table),
                                             *args).cpu().numpy()
            else:
                with self._activity("serve/decode", "SERVE_DECODE",
                                    {"batch": len(active)}):
                    nxt = self._decode_dense(*args).cpu().numpy()
        out = {}
        for s in active:
            toks = [int(nxt[s])]
            out[s] = toks
            self._advance_slot(s, toks)
        return out

    def _step_spec(self, active: List[int],
                   snap: tuple) -> Dict[int, List[int]]:
        """Draft-then-verify step: each slot emits its accepted prefix
        plus the target's next token (1..K+1 tokens, token-identical to
        plain greedy decode).  ``snap`` is step()'s slot snapshot —
        re-reading here could disagree with ``active``."""
        K = self.spec_k
        act, pos, temps, topks, last_tokens, spec = snap
        positions = np.where(act, pos, 0)
        for s in active:
            p = int(positions[s])
            self._kv.ensure_writable(s, p, min(K + 1, self.max_seq_len - p))
        spec_ok = act & spec & (temps <= 0)
        with torch.inference_mode(), self._activity(
                "serve/decode", "SERVE_DECODE",
                {"batch": len(active), "spec_k": K}):
            tokens_t = self._tensor(last_tokens)
            positions_t = self._tensor(positions)
            draft = self._spec_draft(tokens_t, positions_t)
            out, accepted = self._spec_verify(
                self._tensor(self._table), tokens_t, draft, positions_t,
                self._tensor(temps, torch.float32), self._tensor(topks),
                self._tensor(spec_ok, torch.bool))
            out = out.cpu().numpy()
            accepted = accepted.cpu().numpy()
        result: Dict[int, List[int]] = {}
        spec_emitted = spec_steps = 0
        for s in active:
            toks = [int(t) for t in out[s, :int(accepted[s]) + 1]]
            result[s] = toks
            self._advance_slot(s, toks)
            if spec_ok[s]:
                # Only opted-in greedy slots measure drafter quality.
                spec_steps += 1
                spec_emitted += len(toks)
        self.spec_verify_steps += spec_steps
        self.spec_accepted_tokens += spec_emitted
        from ..obs import instrument as _obs

        _obs.on_spec_accept_ratio(
            self.spec_accepted_tokens / max(1, self.spec_verify_steps))
        return result

    def release(self, slot: int) -> None:
        """Return ``slot`` to the free pool.  Dense tier: cache rows
        are reused (stale keys invisible behind the position mask);
        paged tier: the chain's references drop and unreferenced
        prompt blocks stay resident for future prefix hits until
        evicted.  Host state only: safe from any thread."""
        if self._kv is not None:
            self._kv.release(slot)
        self._clear_slot(slot)

    # --- deadline-aware preemption (serve/qos/) -----------------------------

    def preempt_slot(self, slot: int, prompt: Sequence[int],
                     emitted: Sequence[int]):
        """Evict ``slot``'s generation for later resumption: index the
        computed sequence (prompt + every emitted token whose K/V
        exists) into the prefix cache, release the slot, and return the
        generator's state.  The state is taken BEFORE release so a
        resume restores the stream the uninterrupted run would be on
        (the sole-active-slot contract of :meth:`resume_slot`)."""
        rng = self.export_rng()
        emitted = [int(t) for t in emitted]
        if self._kv is not None and emitted:
            # The last emitted token is pending consumption: its K/V is
            # not written yet.
            seq = [int(t) for t in prompt] + emitted[:-1]
            if seq:
                self._kv.index_prompt(slot, seq)
        self.release(slot)
        return rng

    def can_resume(self, n_prompt: int, n_emitted: int) -> bool:
        """Whether a generation of this shape survives a
        preempt/resume cycle here: the paged tier rebuilds long tails in
        bucket-sized chunks, but a drafter's dense cache is rebuilt by
        one whole-bucket prefill."""
        n = n_prompt + max(0, n_emitted - 1)
        if self._drafter is not None:
            return n <= self.prefill_buckets[-1]
        return 0 < n < self.max_seq_len

    def resume_slot(self, slot: int, prompt: Sequence[int],
                    emitted: Sequence[int], sampling: SamplingParams,
                    rng=None) -> int:
        """Re-admit a preempted generation into ``slot``: rebuild K/V
        for ``prompt + emitted[:-1]`` (the prefix hit covers what
        survived, prefills recompute the rest, their sampled tokens
        discarded), then bind the slot so the next ``step()`` consumes
        ``emitted[-1]``.  Returns the prefix-hit token count.

        ``rng`` (the state :meth:`preempt_slot` returned) is restored
        AFTER the recompute, and only while no other slot is active:
        temperature resumption is then identical to the uninterrupted
        run; with concurrent traffic it stays distributionally correct
        (greedy is deterministic either way)."""
        with self._slot_lock:
            if self._active[slot]:
                raise RuntimeError(f"slot {slot} is already active")
        prompt = [int(t) for t in prompt]
        emitted = [int(t) for t in emitted]
        if not emitted:
            raise ValueError("resume_slot needs at least one emitted "
                             "token (preemption happens post-prefill)")
        self.check_prompt_tokens(prompt)
        seq = prompt + emitted[:-1]
        n = len(seq)
        with torch.inference_mode():
            if self.kv_mode == "paged":
                hit = self._kv.begin_request(slot, seq)
                # Recompute the non-resident tail in bucket-sized
                # chunks: a resumed sequence may outgrow the largest
                # bucket.
                top = self.prefill_buckets[-1]
                pos = hit
                while pos < n:
                    ns = min(n - pos, top)
                    with self._activity(
                            f"serve/slot{slot}", "SERVE_PREFILL",
                            {"bucket": self.bucket_for(ns),
                             "prompt_len": n, "prefix_hit": hit,
                             "resumed": True}):
                        self._prefill_chunk(slot, seq, pos, ns, sampling)
                    pos += ns
                self._kv.index_prompt(slot, seq)
            else:
                hit = 0
                L = self.bucket_for(n)
                with self._activity(f"serve/slot{slot}", "SERVE_PREFILL",
                                    {"bucket": L, "prompt_len": n,
                                     "resumed": True}):
                    self._prefill_dense(L, self._padded(seq, L), n, slot,
                                        sampling.temperature,
                                        sampling.top_k)
            if rng is not None and not self.active_slots():
                self._gen.set_state(torch.as_tensor(rng).clone())
            if self._drafter is not None:
                self._drafter_prefill(slot, seq)
        self._bind_slot(slot, n, emitted[-1], sampling, hit)
        return hit

    # --- staged weights (the swap barrier flips them) -----------------------
    # Staging may run on any thread; the COMMIT runs on the batcher
    # thread only, at the swap barrier, with no active slots.

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The live parameters by name (treat as read-only); a
        tensor-parallel replica's ``qkv``/``up`` kernels reassembled
        whole on the first shard's device."""
        if self.tp == 1:
            return dict(self._model.named_parameters())
        out = {}
        for name in self._param_shapes:
            owner, leaf = self._param_owner(name)
            out[name] = (owner.whole() if isinstance(owner, ColumnShards)
                         else getattr(owner, leaf))
        return out

    def _param_owner(self, name: str):
        """``(module, leaf)`` holding the weight the reference calls
        ``name`` (a :class:`ColumnShards` for a sharded kernel)."""
        path, _, leaf = name.rpartition(".")
        return (self._model.get_submodule(path) if path else self._model,
                leaf)

    @property
    def weights_version(self) -> int:
        with self._slot_lock:
            return self._weights_version

    def stage_params(self, tree: Mapping, version: int) -> None:
        """Stage ``tree`` (``{name: array}``, or the reference's nested
        layout, host or device arrays) as version ``version`` beside
        the live parameters: the tensors land on the device now, so the
        later flip is one reference assignment a leaf.  Replaces any
        previously staged version."""
        from ..ckpt.snapshot import to_tensor

        flat = _flat_tree(tree)
        own = self._param_shapes
        if set(flat) != set(own):
            raise ValueError(
                f"staged tree differs from the model's: missing "
                f"{sorted(set(own) - set(flat))}, extra "
                f"{sorted(set(flat) - set(own))}")
        staged = {}
        for name, shape in own.items():
            t = flat[name]
            if not torch.is_tensor(t):
                # A store's bf16 leaf reads back as its ``V2`` bytes.
                t = to_tensor(t)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: staged shape {tuple(t.shape)} "
                                 f"!= {shape}")
            owner, leaf = self._param_owner(name)
            if isinstance(owner, ColumnShards):
                # The sharded layout the replica runs: a hot swap lands
                # each shard's columns on its device.
                staged[name] = owner.place(
                    t.to(dtype=owner.shards[0].dtype))
            else:
                staged[name] = t.to(device=self._dev,
                                    dtype=getattr(owner, leaf).dtype,
                                    copy=True)
        with self._slot_lock:
            self._staged_params = staged
            self._staged_version = int(version)

    def staged_version(self) -> Optional[int]:
        with self._slot_lock:
            return self._staged_version

    def discard_staged(self) -> None:
        """Drop a staged version: the live parameters were never
        touched."""
        with self._slot_lock:
            self._staged_params = None
            self._staged_version = None

    def commit_staged(self) -> int:
        """THE flip: re-point the model's parameters at the staged
        tensors and flush the prefix cache (resident KV was computed
        under the old weights).  Batcher thread only, at the swap
        barrier, with no active slots.  Returns the new version."""
        with self._slot_lock:
            if self._staged_params is None:
                raise RuntimeError("no staged params to commit")
            if np.count_nonzero(self._active):
                raise RuntimeError(
                    "commit_staged with active slots — the barrier "
                    "must drain in-flight generations first")
            staged = self._staged_params
            version = int(self._staged_version)
            self._staged_params = None
            self._staged_version = None
            self._weights_version = version
        for name, value in staged.items():
            owner, leaf = self._param_owner(name)
            if isinstance(owner, ColumnShards):
                owner.load(value)
            else:
                getattr(owner, leaf).data = value
        if self._kv is not None:
            self._kv.flush_cache()
        from ..obs import instrument as _obs

        _obs.on_weights_version(version)
        return version

    # --- slot KV export/import ---------------------------------------------
    # Batcher thread only, like start()/step().

    def export_slot_kv(self, slot: int):
        """Export ``slot``'s resident KV as ``(chain_len, k, v)``, CPU
        tensors of shape ``[n_layer, n_blocks, block, H, D]`` in the
        pool's dtype — the slot's block table is the manifest: only its
        live, non-trash chain blocks move.  A tensor-parallel replica
        exports every head: the shards' heads concatenated in shard
        order."""
        if self.kv_mode != "paged":
            raise RuntimeError("KV export requires the paged cache "
                               "(HVD_TPU_SERVE_KV=paged)")
        chain = self._kv.chain_blocks(slot)
        if not chain:
            raise RuntimeError(f"slot {slot} has no KV chain to export")
        out = []
        with torch.inference_mode():
            for key in ("k", "v"):
                parts = []
                for dev, pools in zip(self.devices, self._shard_pools):
                    idx = torch.tensor(chain, dtype=torch.int64, device=dev)
                    parts.append(torch.stack([p[key][idx]
                                              for p in pools]).cpu())
                out.append(parts[0] if len(parts) == 1
                           else torch.cat(parts, dim=3))
        return len(chain), out[0], out[1]

    def import_slot_kv(self, slot: int, prompt: Sequence[int],
                       k_blocks, v_blocks, first_token: int,
                       sampling: SamplingParams, rng=None) -> None:
        """Bind received KV blocks (``[n_layer, n_blocks, block, H,
        D]``, tensors or numpy) into this engine's pool and activate
        ``slot`` as if prefill had run here: the next ``step()``
        consumes ``first_token`` at position ``n_prompt``.  ``rng`` (the
        sender's generator state) is adopted only while no other slot
        is active."""
        if self.kv_mode != "paged":
            raise RuntimeError("KV import requires the paged cache "
                               "(HVD_TPU_SERVE_KV=paged)")
        with self._slot_lock:
            if self._active[slot]:
                raise RuntimeError(f"slot {slot} is already active")
        prompt = [int(t) for t in prompt]
        n = len(prompt)
        self.check_prompt_tokens(prompt)
        k_blocks = torch.as_tensor(k_blocks)
        v_blocks = torch.as_tensor(v_blocks)
        nb = int(k_blocks.shape[1])
        expected = -(-n // self.kv_block)
        if nb != expected:
            raise ValueError(
                f"imported chain of {nb} block(s) does not cover the "
                f"{n}-token prompt ({expected} expected at block size "
                f"{self.kv_block})")
        chain = self._kv.bind_imported(slot, nb)
        with torch.inference_mode():
            self._trace("kv_import")
            # Shard s of a tensor-parallel replica takes heads
            # [s·H/tp, (s+1)·H/tp) of every block.
            hs = int(k_blocks.shape[3]) // self.tp
            for s, (dev, pools) in enumerate(zip(self.devices,
                                                 self._shard_pools)):
                heads = slice(s * hs, (s + 1) * hs)
                for i, p in enumerate(pools):
                    for j, blk in enumerate(chain):
                        p["k"][blk] = k_blocks[i, j, :, heads].to(
                            dev, p["k"].dtype)
                        p["v"][blk] = v_blocks[i, j, :, heads].to(
                            dev, p["v"].dtype)
            # The imported prefix is resident here now: index it so
            # later admissions hit it.
            self._kv.index_prompt(slot, prompt)
            if rng is not None and not self.active_slots():
                self._gen.set_state(torch.as_tensor(rng).clone())
            if self._drafter is not None:
                self._drafter_prefill(slot, prompt)
        self._bind_slot(slot, n, int(first_token), sampling, 0)

    def export_rng(self) -> torch.Tensor:
        """The generator's current state (a CPU byte tensor); an idle
        importer or a resumed slot adopting it continues the same
        sampling stream."""
        return self._gen.get_state().clone()

    def drain_evicted_prefixes(self) -> List[tuple]:
        """Leading-block keys evicted since the last drain (for the
        router's prefix directory); empty on the dense tier."""
        if self._kv is None:
            return []
        return self._kv.drain_evicted_keys()

    # --- observability ------------------------------------------------------

    def kv_stats(self) -> Dict:
        """JSON-ready paged-KV + speculative counters (merged into the
        batcher's snapshot)."""
        out: Dict = {}
        if self._kv is not None:
            out.update(self._kv.stats())
        if self._drafter is not None:
            steps = self.spec_verify_steps
            out["spec_verify_steps"] = steps
            out["spec_accepted_tokens"] = self.spec_accepted_tokens
            out["spec_accept_per_verify"] = (
                round(self.spec_accepted_tokens / steps, 4) if steps
                else None)
        return out
