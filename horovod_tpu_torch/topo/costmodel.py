"""Per-tier α–β cost model for two-tier meshes.

Counterpart of ``horovod_tpu/topo/costmodel.py``, pure arithmetic, with
the reference's tier names so that a compiled schedule compares equal to
the reference's: ``ici`` is the intra-pod tier, which in the port is
the intra-node one (NVLink), and ``dcn`` the inter-pod tier, here the
network between nodes.  It extends the flat α–β model of
:mod:`..ops.fusion` (per-hop launch latency α, per-hop bandwidth β) to
the two tiers.  With ``n = P·C`` ranks in ``P`` pods of ``C`` chips:

* **Flat allreduce** is one collective whose ring steps pipeline from
  neighbour to neighbour: a hop launches at the fast tier's α, but every
  ring step moves payload through the links between pods, so the
  transfer runs at the slow tier's β: ``2(n−1)·(α_ici + (b/n)/β_dcn)``
  (a one-pod mesh is all fast tier).
* **Hierarchical** (reduce-scatter inside the pod → cross-pod exchange
  of the ``b/C`` fragment → all-gather inside the pod) pays two fast
  phases on the whole payload and a slow allreduce on the fragment,
  each of whose ``2(P−1)`` hops costs the full α_dcn.

So small buckets, bound by latency, stay flat while ``C·α_ici <
α_dcn``, and large ones go hierarchical because the slow tier moves
``C×`` fewer bytes; the crossover is closed-form
(:func:`hierarchical_crossover_bytes`).

The **online estimator** (:class:`OnlineEstimator`) EWMAs achieved
bytes/µs into the per-tier β.  Each compiled plan notes its per-tier
bytes (:func:`..topo.schedule.record_plans`), and every instrumented
step feeds it its wall time (``obs.instrument.wrap_step`` calls
:meth:`OnlineEstimator.refine_from_step`); each refinement publishes the
per-tier point as the ``hvd_tpu_topo_cost_alpha_us`` and
``hvd_tpu_topo_cost_beta_gbps`` gauges.  ``HVD_TPU_TOPO_COST_FREEZE=1`` pins the parameters.  Refined
parameters reach the compiler only in a world of one process: each
rank is a process here, and ranks with different parameters would
compile different collective programs and deadlock.  None of the
default α/β numbers has been measured on NVLink or a network.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

from ..config import DEFAULT_COST_ALPHA_US, DEFAULT_COST_BETA_GBPS
from .topology import MeshTopology

TIERS = ("ici", "dcn")


@dataclasses.dataclass(frozen=True)
class TierParams:
    """One tier's α–β point: per-hop launch latency (µs) and per-hop
    bandwidth (GB/s)."""

    alpha_us: float
    beta_gbps: float

    @property
    def beta_bytes_per_us(self) -> float:
        return self.beta_gbps * 1e3  # GB/s == 10^3 B/µs


@dataclasses.dataclass(frozen=True)
class TopoCostParams:
    """The model: one :class:`TierParams` per tier (``ici`` inside a
    node, ``dcn`` between nodes)."""

    ici: TierParams
    dcn: TierParams

    def tier(self, name: str) -> TierParams:
        if name == "ici":
            return self.ici
        if name == "dcn":
            return self.dcn
        raise ValueError(f"unknown tier {name!r}; expected one of {TIERS}")


def default_params() -> TopoCostParams:
    """Priors from the live config: the intra-node tier reuses the flat
    model's ``HVD_TPU_COST_ALPHA_US``/``COST_BETA_GBPS``, the inter-node
    tier has its own ``HVD_TPU_TOPO_ALPHA_DCN_US``/``TOPO_BETA_DCN_GBPS``
    (an order of magnitude worse by default).  Before init: the flat
    defaults and ten times worse."""
    from .. import basics

    if basics.is_initialized():
        cfg = basics.config()
        return TopoCostParams(
            ici=TierParams(cfg.cost_alpha_us, cfg.cost_beta_gbps),
            dcn=TierParams(cfg.topo_alpha_dcn_us, cfg.topo_beta_dcn_gbps))
    return TopoCostParams(
        ici=TierParams(DEFAULT_COST_ALPHA_US, DEFAULT_COST_BETA_GBPS),
        dcn=TierParams(DEFAULT_COST_ALPHA_US * 10.0,
                       DEFAULT_COST_BETA_GBPS / 10.0))


def tier_phase_cost_us(nbytes: float, n: int, p: TierParams) -> float:
    """One reduce-scatter or all-gather phase of a ring over ``n``
    participants on one tier (the per-tier ``fusion.phase_cost_us``), in
    the reference's order of operations, so the floats are the same."""
    if n <= 1:
        return 0.0
    return (n - 1) * (p.alpha_us + (nbytes / n) / (p.beta_gbps * 1e3))


def flat_cost_us(nbytes: float, topo: MeshTopology,
                 params: TopoCostParams) -> float:
    """Modeled makespan of one flat allreduce over the whole mesh."""
    n = topo.size
    if n <= 1:
        return 0.0
    if topo.pods > 1:
        return 2.0 * (n - 1) * (
            params.ici.alpha_us
            + (nbytes / n) / (params.dcn.beta_gbps * 1e3))
    return 2.0 * tier_phase_cost_us(nbytes, n, params.ici)


def hierarchical_cost_us(nbytes: float, topo: MeshTopology,
                         params: TopoCostParams) -> float:
    """Modeled makespan of the hierarchical schedule: reduce-scatter and
    all-gather of the whole payload inside the pod, one allreduce of the
    ``b/C`` fragment between pods."""
    if not topo.two_tier:
        return flat_cost_us(nbytes, topo, params)
    intra = 2.0 * tier_phase_cost_us(nbytes, topo.chips_per_pod,
                                     params.ici)
    frag = nbytes / topo.chips_per_pod
    cross = 2.0 * tier_phase_cost_us(frag, topo.pods, params.dcn)
    return intra + cross


def hierarchical_phase_costs_us(nbytes: float, topo: MeshTopology,
                                params: TopoCostParams
                                ) -> Dict[str, float]:
    """Per-phase breakdown ``{rs_intra, xpod, ag_intra}``."""
    if not topo.two_tier:
        return {"rs_intra": 0.0,
                "xpod": flat_cost_us(nbytes, topo, params),
                "ag_intra": 0.0}
    intra = tier_phase_cost_us(nbytes, topo.chips_per_pod, params.ici)
    frag = nbytes / topo.chips_per_pod
    return {"rs_intra": intra,
            "xpod": 2.0 * tier_phase_cost_us(frag, topo.pods, params.dcn),
            "ag_intra": intra}


def hierarchical_crossover_bytes(topo: MeshTopology,
                                 params: TopoCostParams) -> int:
    """Bucket payload at and above which the hierarchical schedule beats
    flat, in closed form (``flat(b) = hier(b)``):

    * latency gap at b→0: ``2(P−1)·(C·α_ici − α_dcn)`` (flat − hier);
    * slope gap: ``2·(C−1)/C · (1/β'_dcn − 1/β'_ici)`` a byte.

    0 when hierarchical wins at every size; ``1 << 62`` when no such
    payload exists, the inverted tiers (``β_dcn ≥ β_ici``) included,
    where hierarchy can only win below a boundary (:func:`choose_algo
    <..topo.schedule.choose_algo>` compares the costs and stays right
    there)."""
    if not topo.two_tier:
        return 1 << 62
    P, C = topo.pods, topo.chips_per_pod
    lat_gap = 2.0 * (P - 1) * (C * params.ici.alpha_us
                               - params.dcn.alpha_us)
    slope_gap = 2.0 * ((C - 1) / C) * (
        1.0 / params.dcn.beta_bytes_per_us
        - 1.0 / params.ici.beta_bytes_per_us)
    if slope_gap <= 0:
        # The slow tier is not the per-byte bottleneck: flat wins more
        # as the payload grows, so there is no threshold above.
        return 1 << 62
    if lat_gap >= 0:
        return 0            # hierarchical wins on latency alone
    return int(-lat_gap / slope_gap) + 1


# --- online estimator --------------------------------------------------------

class OnlineEstimator:
    """EWMA refinement of the per-tier β from observed bytes/µs.

    :meth:`note_plan` records a compiled plan's per-tier wire bytes;
    :meth:`refine_from_step` turns a finished step's wall time into one
    bytes/µs sample a tier.  Step time includes compute, so the sample
    is a floor on the bandwidth: the estimate converges from below and
    is exact on pure-wire signals.  α samples come through
    :meth:`observe_alpha` from latency-bound probes."""

    def __init__(self, prior: Optional[TopoCostParams] = None,
                 decay: float = 0.2) -> None:
        self._lock = threading.Lock()
        self.prior = prior or default_params()
        self.decay = float(decay)
        self._beta: Dict[str, float] = {}     # bytes/µs EWMA; guarded-by: _lock
        self._alpha: Dict[str, float] = {}    # µs EWMA; guarded-by: _lock
        self._plan_bytes: Dict[str, float] = {}  # guarded-by: _lock
        self._samples = 0                     # guarded-by: _lock
        self._frozen: Optional[bool] = None   # guarded-by: _lock

    def frozen(self) -> bool:
        """Pinned by :meth:`freeze`, else ``HVD_TPU_TOPO_COST_FREEZE``."""
        with self._lock:
            if self._frozen is not None:
                return self._frozen
        from .. import basics

        return (basics.config().topo_cost_freeze
                if basics.is_initialized() else False)

    def freeze(self, frozen: bool = True) -> None:
        with self._lock:
            self._frozen = bool(frozen)

    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples

    def note_plan(self, tier_bytes: Dict[str, float]) -> None:
        """The latest compiled plan's per-tier wire bytes a step."""
        with self._lock:
            self._plan_bytes = {t: float(b) for t, b in tier_bytes.items()
                                if b > 0}

    def observe(self, tier: str, nbytes: float, elapsed_us: float) -> None:
        """One achieved-bandwidth sample for a tier."""
        if self.frozen() or nbytes <= 0 or elapsed_us <= 0:
            return
        rate = float(nbytes) / float(elapsed_us)
        with self._lock:
            prev = self._beta.get(tier)
            self._beta[tier] = (rate if prev is None
                                else (1 - self.decay) * prev
                                + self.decay * rate)
            self._samples += 1
        self._publish()

    def observe_alpha(self, tier: str, elapsed_us: float,
                      hops: int) -> None:
        """One latency-bound sample (near-zero payload): per-hop launch
        latency."""
        if self.frozen() or hops <= 0 or elapsed_us <= 0:
            return
        a = float(elapsed_us) / float(hops)
        with self._lock:
            prev = self._alpha.get(tier)
            self._alpha[tier] = (a if prev is None
                                 else (1 - self.decay) * prev
                                 + self.decay * a)
            self._samples += 1
        self._publish()

    def refine_from_step(self, step_time_s: float) -> None:
        """Feed one finished step: the latest noted plan's per-tier bytes
        rode the wire inside this wall time.  Called from
        ``obs.instrument.wrap_step``; a no-op when no plan was noted or
        the estimator is frozen."""
        with self._lock:
            plan = dict(self._plan_bytes)
        if not plan or step_time_s <= 0:
            return
        for tier, nbytes in plan.items():
            self.observe(tier, nbytes, step_time_s * 1e6)

    def params(self) -> TopoCostParams:
        """The current estimate: the prior with the EWMA'd tiers in."""
        with self._lock:
            beta = dict(self._beta)
            alpha = dict(self._alpha)

        def tier(name: str, prior: TierParams) -> TierParams:
            return TierParams(
                alpha_us=alpha.get(name, prior.alpha_us),
                beta_gbps=(beta[name] / 1e3) if name in beta
                else prior.beta_gbps)

        return TopoCostParams(ici=tier("ici", self.prior.ici),
                              dcn=tier("dcn", self.prior.dcn))

    def effective_params(self) -> TopoCostParams:
        """What the schedule compiler uses: the refined values once every
        tier has a β sample, in a world of one process; the priors
        everywhere else.  A one-sided floor would distort the cross-tier
        ratio the choice rides on, and ranks refining on their own
        clocks would compile different programs."""
        with self._lock:
            refined_tiers = set(self._beta)
        if not refined_tiers.issuperset(TIERS):
            return self.prior
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_world_size() > 1:
            return self.prior
        return self.params()


    def _publish(self) -> None:
        from ..obs import instrument

        if not instrument.enabled():
            return
        p = self.params()
        for name in TIERS:
            t = p.tier(name)
            instrument.on_topo_estimator(name, t.alpha_us, t.beta_gbps)


_estimator: Optional[OnlineEstimator] = None   # guarded-by: _est_lock
_est_lock = threading.Lock()


def estimator() -> OnlineEstimator:
    """The process's estimator (priors from the live config at first
    use).  It outlives ``shutdown``: learned bandwidth spans re-inits."""
    global _estimator
    with _est_lock:
        if _estimator is None:
            _estimator = OnlineEstimator()
        return _estimator


def reset_estimator() -> None:
    """Drop the process's estimator (tests)."""
    global _estimator
    with _est_lock:
        _estimator = None
