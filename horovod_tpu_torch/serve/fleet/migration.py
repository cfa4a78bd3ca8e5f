"""Live KV migration: prefill→decode block streaming with digests.

Counterpart of ``horovod_tpu/serve/fleet/migration.py``.  The blocks
travel as CPU tensors in the pool's dtype (numpy has no bf16); a block's
digest is taken over its raw bytes (a bf16 block as its 16-bit words),
in the reference's ``[n_layer, n_blocks, block, H, D]`` layout, so the
two packages' digests of the same bytes are equal.

The disaggregated fleet's data handoff: a prefill replica runs the
prompt, then streams the request's paged KV blocks to a decode replica
over the existing HMAC ``BasicService`` wire
(``runner/common/network.py::KvMigrateRequest``).  The slot's block
table is the transfer manifest — only live, non-trash chain blocks
move — and every block carries a sha256 digest computed over its
``[n_layer, block, H, D]`` K and V payload, so the receiver verifies
the transfer before binding anything into its own pool: a corrupted
block fails the digest check and the request finishes on a correct
path (the sender's pristine KV, or a full recompute elsewhere) — never
with wrong tokens.

Chunking: frames stay under ``HVD_TPU_FLEET_MIGRATE_CHUNK`` bytes
(block-granular — a block is the atomic unit of both transfer and
verification), so one migration is a short burst of bounded frames
instead of one giant allocation on both ends.

Fault site ``serve`` modes ``migrate`` / ``migrate-drop`` /
``migrate-delay`` fire here, at the KV-transfer boundary: ``migrate``
corrupts one block AFTER the digests were computed (the
detect-and-recover drill), ``migrate-drop`` fails the transfer on the
wire, ``migrate-delay`` stretches it (a congested DCN link).
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import faults as faults_mod
from ...obs import instrument as _obs
from ...obs import trace as trace_mod
from ...runner.common.network import BasicClient, KvMigrateRequest
from ...utils.logging import get_logger
from ...models.transformer import TP_SERVING_ITEM
from ...utils.retry import RetryPolicy
from ..engine import resolved_config

logger = get_logger(__name__)


class MigrationError(RuntimeError):
    """The KV transfer failed (wire death, digest mismatch, receiver
    refusal) — the sender falls back to decoding locally; the request
    is never lost and never continues from damaged state."""


def _raw(t: torch.Tensor) -> np.ndarray:
    """A host array of ``t``'s raw elements in its own layout (a bf16
    tensor as its 16-bit words: numpy has no bf16)."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel() * t.element_size())


def block_digests(k: torch.Tensor, v: torch.Tensor) -> List[str]:
    """Per-block sha256 over the concatenated K then V bytes of all
    layers (``k``/``v`` are ``[n_layer, n_blocks, block, H, D]``
    tensors) — the digest format docs/serving.md documents."""
    k, v = _raw(k), _raw(v)
    return [hashlib.sha256(np.ascontiguousarray(k[:, j]).tobytes()
                           + np.ascontiguousarray(v[:, j]).tobytes())
            .hexdigest()
            for j in range(k.shape[1])]


def shard_digests(k: torch.Tensor, v: torch.Tensor,
                  tp: int) -> List[List[str]]:
    """Per-shard, per-block digest lists for a tensor-parallel
    migration (docs/tp_serving.md): shard ``s`` owns the contiguous
    head range ``[s*H/tp, (s+1)*H/tp)`` of every block, and its digest
    list covers exactly the bytes its wire stream carries — each stream
    verifies independently, so one damaged shard fails the transfer
    without waiting for the others."""
    hs = k.shape[3] // tp
    return [block_digests(k[:, :, :, s * hs:(s + 1) * hs],
                          v[:, :, :, s * hs:(s + 1) * hs])
            for s in range(tp)]


def _check_digests(digests: List[str], n_blocks, k, v,
                   what: str) -> None:
    if k.shape[1] != n_blocks or len(digests) != k.shape[1]:
        raise MigrationError(
            f"migration shape mismatch: {k.shape[1]} block(s) received "
            f"{what}, manifest declares {n_blocks}")
    got = block_digests(k, v)
    for j, (want, have) in enumerate(zip(digests, got)):
        if want != have:
            raise MigrationError(f"digest_mismatch: block {j} of "
                                 f"{len(digests)} failed verification "
                                 f"{what}")


def verify_digests(manifest: dict, k, v) -> None:
    """Receiver-side transfer verification; raises
    :class:`MigrationError` on any mismatch — nothing unverified ever
    reaches the receiving pool."""
    _check_digests(manifest.get("digests") or [],
                   manifest.get("n_blocks"), k, v, "")


def verify_shard_digests(manifest: dict, shard: int, k, v) -> None:
    """Per-stream verification of one shard's head slice against the
    manifest's ``shard_digests`` entry."""
    per_shard = manifest.get("shard_digests") or []
    if shard >= len(per_shard):
        raise MigrationError(
            f"shard {shard} not covered by the manifest's "
            f"{len(per_shard)} shard digest list(s)")
    _check_digests(per_shard[shard], manifest.get("n_blocks"), k, v,
                   f"(shard {shard})")


def plan_frames(n_blocks: int, per_block_bytes: int,
                chunk_bytes: int) -> List[Tuple[int, int]]:
    """Split ``n_blocks`` into ``[j0, j1)`` frame ranges so each frame
    stays under ``chunk_bytes`` (always >= 1 block per frame)."""
    per = max(1, chunk_bytes // max(1, per_block_bytes))
    return [(j, min(j + per, n_blocks)) for j in range(0, n_blocks, per)]


def migrate_slot(engine, slot: int, req, target, key: bytes, *,
                 chunk_bytes: Optional[int] = None,
                 probe_timeout: float = 5.0,
                 wire_timeout: float = 30.0) -> bool:
    """Export ``slot``'s KV from ``engine`` and stream it to ``target
    = (name, addresses)``.  Returns True once the receiver verified the
    digests and adopted the request; raises :class:`MigrationError` on
    any failure (after best-effort cancelling a partially-adopted copy
    on the receiver, so a local fallback cannot double-execute)."""
    name, addresses = target
    cfg = resolved_config()
    chunk = int(chunk_bytes or cfg.fleet_migrate_chunk)
    t0 = time.monotonic()
    nb, k, v = engine.export_slot_kv(slot)
    s = req.sampling
    manifest = {
        "request_id": req.request_id,
        "prompt": list(req.prompt),
        "tokens": list(req.tokens),
        "block_tokens": engine.kv_block,
        "n_blocks": nb,
        "digests": block_digests(k, v),
        "sampling": {"max_new_tokens": s.max_new_tokens,
                     "temperature": s.temperature, "top_k": s.top_k,
                     "stop_token": s.stop_token, "spec": s.spec},
        "deadline_s": (max(0.1, req.deadline - time.monotonic())
                       if req.deadline is not None else None),
        # Sender's post-prefill PRNG key: an idle importer adopts it so
        # temperature sampling stays bit-identical across the handoff.
        "rng": engine.export_rng(),
        # Weight hot-swap guard (serve/swap.py): the KV was computed
        # under THIS version; a receiver serving different weights must
        # refuse the adoption — decoding v(N) KV under v(N+1) weights
        # would emit silently wrong tokens.  The sender then decodes
        # locally on its own matching weights (economics lost, tokens
        # right).
        "weights_version": engine.weights_version,
        # Multi-tenant QoS (serve/qos/): the flow identity travels with
        # the request so the decode replica's weighted-fair scheduler
        # and per-class stats see the same tenant/class the router
        # admitted.
        "tenant": req.tenant,
        "qos_class": req.qos_class,
    }
    tp = int(getattr(engine, "tp", 1) or 1)
    if tp > 1:
        # Tensor-parallel sender (docs/tp_serving.md): the manifest
        # carries one digest list PER SHARD beside the whole-block
        # list, so each head-sliced wire stream verifies independently
        # on the receiver before heads are concatenated back.
        manifest["tp_degree"] = tp
        manifest["shard_digests"] = shard_digests(k, v, tp)
    nbytes = _nbytes(k) + _nbytes(v)
    mode = (faults_mod.on_serve_migrate()
            if faults_mod._active is not None else None)
    sent = False
    try:
        with trace_mod.span("hvd_tpu_kv_migrate",
                            args={"request_id": req.request_id,
                                  "blocks": nb, "bytes": nbytes,
                                  "target": name}):
            if mode == "migrate-drop":
                raise MigrationError(
                    "injected migrate drop at the KV-transfer boundary")
            if mode == "migrate":
                # Corrupt AFTER digesting: the manifest describes the
                # true content, so the receiver's digest check MUST
                # reject this payload — the wrong-tokens-never drill.
                k = k.clone()
                k.reshape(-1).view(torch.uint8)[:16] ^= 0xFF
            if tp > 1:
                sent = True
                _stream_shards(req.request_id, k, v, tp, manifest,
                               name, addresses, key, nb, chunk,
                               probe_timeout, wire_timeout)
            else:
                client = BasicClient(name, addresses, key,
                                     probe_timeout=probe_timeout,
                                     retry_policy=RetryPolicy(attempts=1))
                per_block = (_nbytes(k[:, :1]) + _nbytes(v[:, :1])
                             if nb else 0)
                frames = plan_frames(nb, per_block, chunk)
                for seq, (j0, j1) in enumerate(frames):
                    sent = True
                    # A frame owns its bytes: a pickled view would carry
                    # the whole export's storage.
                    resp = client.request(
                        KvMigrateRequest(
                            req.request_id, seq, len(frames),
                            k[:, j0:j1].clone(), v[:, j0:j1].clone(),
                            manifest=manifest if seq == 0 else None),
                        idempotent=False, timeout=wire_timeout)
                    err = getattr(resp, "error", None)
                    if err:
                        raise MigrationError(
                            f"decode replica {name}: {err}")
        ms = (time.monotonic() - t0) * 1e3
        _obs.on_fleet_migration(nbytes, True, ms)
        req.migrate_ms = round(ms, 3)
        return True
    except (OSError, MigrationError) as e:
        _obs.on_fleet_migration(nbytes, False, 0.0)
        if sent:
            # The receiver may hold a partial (or even fully adopted)
            # copy; the sender is about to decode locally, so a second
            # live generation of the same request would only burn the
            # decode replica's slots producing an answer nobody reads.
            _cancel_on_target(name, addresses, key, req.request_id)
        logger.warning("KV migration of %s to %s failed: %s",
                       req.request_id, name, e)
        raise MigrationError(str(e)) from e


def _stream_shards(request_id: str, k, v, tp: int, manifest: dict,
                   name, addresses, key: bytes, nb: int, chunk: int,
                   probe_timeout: float, wire_timeout: float) -> None:
    """Stream a tensor-parallel sender's KV shard to shard (one stream a
    head shard): the tensor-parallel slice of the port."""
    raise NotImplementedError(TP_SERVING_ITEM)


def _cancel_on_target(name, addresses, key, request_id) -> None:
    from ..server import CancelRequest  # function-level: server imports us

    try:
        BasicClient(name, addresses, key, probe_timeout=2.0,
                    retry_policy=RetryPolicy(attempts=1)).request(
                        CancelRequest(request_id), idempotent=False,
                        timeout=5.0)
    except OSError:
        pass   # receiver truly gone: nothing left to cancel


class MigrationBuffer:
    """Receiver-side frame assembly: one per serving endpoint.

    Frames of one migration arrive in order on one sender connection
    loop but interleave with other migrations; entries older than
    ``ttl_s`` are garbage-collected on the next ``add`` (a sender that
    died mid-stream must not leak buffered blocks forever).
    """

    def __init__(self, ttl_s: float = 60.0) -> None:
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        self._pending: Dict[str, dict] = {}   # guarded-by: _lock

    def add(self, frame) -> Optional[Tuple[dict, torch.Tensor,
                                           torch.Tensor]]:
        """Buffer one frame; returns the digest-verified ``(manifest,
        k, v)`` when the transfer completed, None while frames are
        still missing.  Raises :class:`MigrationError` (and drops the
        buffer) on digest mismatch.

        Tensor-parallel transfers interleave ``n_shards`` independent
        streams (frames keyed by ``(shard, seq)``): each shard's head
        slice assembles and digest-verifies on its own, then heads
        concatenate back in shard order — so the returned ``k``/``v``
        are always the full-head arrays regardless of the sender's TP
        degree, and a single damaged shard fails the whole transfer
        before anything reaches the pool."""
        now = time.monotonic()
        rid = frame.request_id
        shard = int(getattr(frame, "shard", 0) or 0)
        n_shards = int(getattr(frame, "n_shards", 1) or 1)
        with self._lock:
            for stale in [r for r, e in self._pending.items()
                          if now - e["t0"] > self.ttl_s]:
                del self._pending[stale]
            ent = self._pending.setdefault(
                rid, {"frames": {}, "manifest": None, "t0": now,
                      "totals": {}, "n_shards": n_shards})
            ent["n_shards"] = max(ent["n_shards"], n_shards)
            ent["totals"][shard] = int(frame.total)
            ent["frames"][(shard, int(frame.seq))] = (frame.k_blocks,
                                                      frame.v_blocks)
            if frame.manifest is not None:
                ent["manifest"] = frame.manifest
            done = (ent["manifest"] is not None
                    and len(ent["totals"]) == ent["n_shards"]
                    and all(
                        sum(1 for (s, _) in ent["frames"] if s == sh) >= tot
                        for sh, tot in ent["totals"].items()))
            if not done:
                return None
            del self._pending[rid]
        shards_kv = []
        for sh in range(ent["n_shards"]):
            tot = ent["totals"][sh]
            if tot == 1:
                k_s, v_s = ent["frames"][(sh, 0)]
            else:
                k_s = torch.cat([ent["frames"][(sh, s)][0]
                                 for s in range(tot)], dim=1)
                v_s = torch.cat([ent["frames"][(sh, s)][1]
                                 for s in range(tot)], dim=1)
            shards_kv.append((k_s, v_s))
        if ent["n_shards"] == 1:
            k, v = shards_kv[0]
            verify_digests(ent["manifest"], k, v)
        else:
            for sh, (k_s, v_s) in enumerate(shards_kv):
                verify_shard_digests(ent["manifest"], sh, k_s, v_s)
            k = torch.cat([ks for ks, _ in shards_kv], dim=3)
            v = torch.cat([vs for _, vs in shards_kv], dim=3)
        return ent["manifest"], k, v

    def discard(self, request_id: str) -> None:
        with self._lock:
            self._pending.pop(request_id, None)
