"""hvdlint on the port: ``horovod_tpu_torch/analysis/``.

Three layers:

* **Parity fixtures** — every fixture of ``tests/test_analysis.py``
  whose check the port keeps (all but the jaxpr, pallas and
  keras-callbacks cases), written as a fixture package
  ``horovod_tpu_torch/`` and run through the port's checker and the
  reference's (``horovod_tpu.analysis``, its AST tier) on the same tree:
  the two findings lists must be equal, and each must be what the
  reference's test asserts.
* **The port's own fixtures** — ``torch.distributed``'s collectives
  under ``dist.get_rank()`` (which the reference's checker misses), the
  lock checker's call resolution (no edge through a receiver nobody can
  type), the kernel wrappers' discipline, and the CLI's exit contract.
* **The gate** — the whole package, linted once for this module, has
  zero unsuppressed findings; the kernel check sees all eight wrappers;
  the catalog agrees with ``docs/lint.md`` for the shared ids and with
  the README's port section for the port's own.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from horovod_tpu.analysis import core as ref_core
from horovod_tpu.analysis import knobs as ref_knobs
from horovod_tpu.analysis import locks as ref_locks
from horovod_tpu.analysis import protocol as ref_protocol
from horovod_tpu.analysis import rank_divergence as ref_rank
from horovod_tpu.analysis import registries as ref_registries
from horovod_tpu.analysis import waits as ref_waits

from horovod_tpu_torch import analysis
from horovod_tpu_torch.analysis import (core, kernels, knobs, locks,
                                        protocol, rank_divergence,
                                        registries, waits)
from horovod_tpu_torch.analysis.__main__ import main as cli_main

pytestmark = pytest.mark.analysis

REPO = Path(__file__).resolve().parent.parent
PKG = "horovod_tpu_torch"

# name -> (the port's checker, the reference's)
CHECKERS = {
    "rank": (rank_divergence.RankDivergenceChecker,
             ref_rank.RankDivergenceChecker),
    "knobs": (knobs.KnobChecker, ref_knobs.KnobChecker),
    "locks": (locks.LockChecker, ref_locks.LockChecker),
    "faults": (registries.FaultSiteChecker, ref_registries.FaultSiteChecker),
    "axes": (registries.MeshAxisChecker, ref_registries.MeshAxisChecker),
    "metrics": (registries.MetricNameChecker,
                ref_registries.MetricNameChecker),
    "spans": (registries.SpanNameChecker, ref_registries.SpanNameChecker),
    "obs": (registries.ObservabilityChecker,
            ref_registries.ObservabilityChecker),
    "protocol": (protocol.ProtocolChecker, ref_protocol.ProtocolChecker),
    "waits": (waits.WaitChecker, ref_waits.WaitChecker),
}

# Minimal config.py for fixture packages (tests/test_analysis.py's).
FIXTURE_CONFIG = '''
import dataclasses, os

PRE_INIT_KNOBS = ("PROCESS_ID",)
FAULT_SITES = ("collective", "rpc")
MESH_AXES = ("data", "fsdp", "hvd")
_NOOP_KNOBS = {"CYCLE_TIME": "no cycle loop here"}


def _env(name, default=None):
    for p in ("HOROVOD_", "HVD_TPU_"):
        v = os.environ.get(p + name)
        if v is not None:
            return v
    return default


def _env_int(name, default):
    v = _env(name)
    return int(v) if v is not None else default


@dataclasses.dataclass(frozen=True)
class Config:
    fusion_threshold: int = 1
    cycle_time_ms: float = 1.0

    @staticmethod
    def from_env():
        return Config(
            fusion_threshold=_env_int("FUSION_THRESHOLD", 1),
            cycle_time_ms=_env_int("CYCLE_TIME", 1),
        )
'''

FIXTURE_ENV_DOC = """
| `HOROVOD_FUSION_THRESHOLD` | 1 | bucket bytes |
| `HOROVOD_CYCLE_TIME` | 1.0 | no-op |
| `HVD_TPU_PROCESS_ID` | unset | rank wiring |
"""

FIXTURE_FAULT_DOC = """
| `collective` | dispatch | raise | boom |
| `rpc` | client | drop | gone |
"""

FIXTURE_CONSUMER = "def use(cfg):\n    return cfg.fusion_threshold\n"


def _materialize(root: Path, files, docs=None, extra=None) -> None:
    pkg = root / PKG
    pkg.mkdir(parents=True, exist_ok=True)
    (pkg / "__init__.py").write_text("")
    for rel, text in files.items():
        p = pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    docdir = root / "docs"
    docdir.mkdir(exist_ok=True)
    for name, text in {"env_vars.md": FIXTURE_ENV_DOC,
                       "fault_injection.md": FIXTURE_FAULT_DOC,
                       "metrics.md": "", **(docs or {})}.items():
        (docdir / name).write_text(text)
    for rel, text in (extra or {}).items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)


def lint(tmp_path, files, checkers, docs=None, select=None, extra=None):
    """The port's checkers over a fixture package."""
    _materialize(tmp_path, files, docs, extra)
    return core.run_checks(core.LintConfig(root=tmp_path, select=select),
                           checker_classes=checkers)


def lint_both(tmp_path, files, names, docs=None, select=None):
    """The port's and the reference's checkers over one fixture tree;
    asserts the two findings lists are equal and returns the port's."""
    _materialize(tmp_path, files, docs)
    port = core.run_checks(
        core.LintConfig(root=tmp_path, select=select),
        checker_classes=[CHECKERS[n][0] for n in names])
    ref = ref_core.run_checks(
        ref_core.LintConfig(root=tmp_path, package=PKG, select=select),
        checker_classes=[CHECKERS[n][1] for n in names])
    assert [_comparable(f) for f in port] == [_comparable(f) for f in ref]
    return port


def _comparable(finding) -> dict:
    """A finding as a dict, with the catalog listing a bad-suppression
    message ends on cut off (the two catalogs differ by design)."""
    d = finding.as_dict()
    d["message"] = re.sub(r"; known ids: \[.*\]$", "", d["message"])
    return d


def checks_of(findings):
    return sorted({f.check for f in findings})


# --- the parity fixtures (tests/test_analysis.py's) --------------------------

BAD_RANK_BRANCH = """
from . import rank, allreduce

def log_and_sync(x):
    if rank() == 0:
        x = allreduce(x)   # only rank 0 reaches the rendezvous
    return x
"""

BAD_RANK_EARLY_EXIT = """
from . import rank, barrier

def save(x):
    r = rank()
    if r != 0:
        return None
    barrier()   # only rank 0 still executing
    return x
"""

GOOD_RANK_BRANCH = """
from . import rank, allreduce

def log_and_sync(x):
    x = allreduce(x)       # every rank participates...
    if rank() == 0:
        print("synced", x)  # ...and only the log is rank-conditioned
    return x
"""

BAD_LOCK = """
import threading

class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []   # guarded-by: _lock

    def ok(self, x):
        with self._lock:
            self._items.append(x)

    def racy(self, x):
        self._items.append(x)   # no lock held
"""

GOOD_LOCK = BAD_LOCK.replace(
    "    def racy(self, x):\n        self._items.append(x)   # no lock held\n",
    "")

LOCK_CYCLE = """
import threading

_la = threading.Lock()
_lb = threading.Lock()

def ab():
    with _la:
        with _lb:
            pass

def ba():
    with _lb:
        with _la:
            pass
"""

CROSS_FN_CYCLE = """
import threading

_la = threading.Lock()
_lb = threading.Lock()

def inner_b():
    with _lb:
        pass

def holds_a():
    with _la:
        inner_b()

def inner_a():
    with _la:
        pass

def holds_b():
    with _lb:
        inner_a()
"""

ONE_LINE_CYCLE = ("import threading\n"
                  "_la = threading.Lock()\n"
                  "_lb = threading.Lock()\n"
                  "def ab():\n"
                  "    with _la, _lb:\n"
                  "        pass\n"
                  "def ba():\n"
                  "    with _lb, _la:\n"
                  "        pass\n")

CLOSURE_LOCK = BAD_LOCK.replace(
    "    def racy(self, x):\n        self._items.append(x)   # no lock held\n",
    "    def spawn(self, x):\n"
    "        def worker():\n"
    "            self._items.append(x)   # closure, no lock held\n"
    "        return worker\n")

WRONG_LOCK = """
import threading

class Box:
    def __init__(self, other):
        self._lock = threading.Lock()
        self._other = other
        self._items = []   # guarded-by: _lock

    def racy(self, x):
        with self._other._lock:
            self._items.append(x)   # wrong lock!
"""

SUPPRESSED_LOCK = BAD_LOCK.replace(
    "self._items.append(x)   # no lock held",
    "self._items.append(x)   # hvdlint: disable=unguarded-mutation "
    "-- fixture: caller holds the lock")

PROTOCOL_FIXTURE = """
class AckResponse:
    pass


class PingRequest:
    pass


class PingResponse:
    pass


class EchoRequest:
    pass


class EchoResponse:
    pass


class BasicService:
    def _handle(self, req, addr):
        if isinstance(req, PingRequest):
            return PingResponse()
        if isinstance(req, EchoRequest):
            return self._echo(req)
        return AckResponse()

    def _echo(self, req):
        return EchoResponse()
"""

PROTOCOL_DOC = "| `PingRequest` | x |\n| `EchoRequest` | x |\n" \
               "| `GhostRequest` | x |\n"

FIXTURE_DETECT = '''
DETECTORS = (
    ("never_shed_interactive", "page"),
    ("stuck_swap", "ticket"),
)
'''

FIXTURE_SLO = '''
def evaluate(clause):
    return {"alert": f"slo_burn:{clause}", "severity": "page"}
'''

FIXTURE_OBS_DOC = """
| alert | severity | meaning |
|---|---|---|
| `never_shed_interactive` | page | interactive lane starved |
| `stuck_swap` | ticket | weights roll wedged |

SLO violations page as `slo_burn:<slo>`.
"""

_KNOB_BASE = {"config.py": FIXTURE_CONFIG, "c.py": FIXTURE_CONSUMER}
_OBS_FILES = {"obs/detect.py": FIXTURE_DETECT, "obs/slo.py": FIXTURE_SLO}

# id: (files, checker names, docs, select, expected check ids (None: any
# superset containing the first id), message fragments, finding count)
PARITY = {
    # rank-divergent collectives
    "rank-branch": ({"m.py": BAD_RANK_BRANCH}, ["rank"], None, None,
                    ["rank-divergent-collective"], ["allreduce"], 1),
    "rank-early-exit": ({"m.py": BAD_RANK_EARLY_EXIT}, ["rank"], None, None,
                        ["rank-divergent-collective"], ["early exit"], 1),
    "rank-logging-clean": ({"m.py": GOOD_RANK_BRANCH}, ["rank"], None, None,
                           [], [], 0),
    # knobs
    "unknown-knob": (dict(_KNOB_BASE, **{
        "m.py": 'import os\nV = os.environ.get("HVD_TPU_MYSTERY")\n'}),
        ["knobs"], None, None, None, ["MYSTERY"], None),
    "raw-env-read": (dict(_KNOB_BASE, **{
        "m.py": 'import os\nV = os.environ.get("HVD_TPU_FUSION_THRESHOLD")\n'}),
        ["knobs"], None, None, None, ["FUSION_THRESHOLD"], None),
    "pre-init-read-ok": (dict(_KNOB_BASE, **{
        "m.py": 'import os\nV = os.environ.get("HVD_TPU_PROCESS_ID")\n'}),
        ["knobs"], None, None, [], [], 0),
    "undocumented-knob": (dict(_KNOB_BASE), ["knobs"], {
        "env_vars.md": "| `HOROVOD_CYCLE_TIME` | 1.0 | x |\n"
                       "| `HVD_TPU_PROCESS_ID` | unset | x |\n"}, None,
        ["undocumented-knob"], ["FUSION_THRESHOLD"], 1),
    "unconsumed-knob": ({"config.py": FIXTURE_CONFIG}, ["knobs"], None, None,
                        ["unconsumed-knob"], ["fusion_threshold"], 1),
    # lock discipline
    "unguarded-mutation": ({"m.py": BAD_LOCK}, ["locks"], None, None,
                           ["unguarded-mutation"], ["_items"], 1),
    "guarded-clean": ({"m.py": GOOD_LOCK}, ["locks"], None, None, [], [], 0),
    "cycle-nested": ({"m.py": LOCK_CYCLE}, ["locks"], None, None,
                     ["lock-order-cycle"], ["_la", "_lb"], 1),
    "cycle-one-line-with": ({"m.py": ONE_LINE_CYCLE}, ["locks"], None, None,
                            ["lock-order-cycle"], [], 1),
    "cycle-through-calls": ({"m.py": CROSS_FN_CYCLE}, ["locks"], None, None,
                            ["lock-order-cycle"], [], 1),
    "no-cycle": ({"m.py": LOCK_CYCLE.replace(
        "with _lb:\n        with _la:", "with _lb:\n        if 1:")},
        ["locks"], None, None, [], [], 0),
    "closure-mutation": ({"m.py": CLOSURE_LOCK}, ["locks"], None, None,
                         ["unguarded-mutation"], [], 1),
    "wrong-lock": ({"m.py": WRONG_LOCK}, ["locks"], None, None,
                   ["unguarded-mutation"], [], 1),
    # suppressions
    "suppression-honored": ({"m.py": SUPPRESSED_LOCK}, ["locks"], None, None,
                            [], [], 0),
    "suppression-expired": ({"m.py": GOOD_LOCK + "\nX = 1  # hvdlint: "
                             "disable=unguarded-mutation -- stale excuse\n"},
                            ["locks"], None, None, ["useless-suppression"],
                            [], 1),
    "suppression-unjustified": (
        {"m.py": "X = 1  # hvdlint: disable=unguarded-mutation\n"},
        ["locks"], None, None, ["bad-suppression"], [], 1),
    "suppression-unknown-id": (
        {"m.py": "X = 1  # hvdlint: disable=not-a-check -- why\n"},
        ["locks"], None, None, ["bad-suppression"], [], 1),
    "suppression-select-scoped": ({"m.py": SUPPRESSED_LOCK}, ["locks"], None,
                                  ["useless-suppression"], [], [], 0),
    "suppression-in-string": (
        {"m.py": 'DOC = "# hvdlint: disable=unguarded-mutation"\n'},
        ["locks"], None, None, [], [], 0),
    # registries
    "unknown-fault-site": (dict(_KNOB_BASE, **{
        "m.py": "from . import faults\n\n"
                "def drill():\n"
                '    with faults.inject("nosite:step=1"):\n'
                "        pass\n"}), ["faults"], None, None,
        ["unknown-fault-site"], ["nosite"], 1),
    "fault-site-doc-drift": (dict(_KNOB_BASE), ["faults"], {
        "fault_injection.md": "| `collective` | x | raise | y |\n"}, None,
        ["fault-site-doc-drift"], ["rpc"], 1),
    "mesh-axis-partition-spec": (dict(_KNOB_BASE, **{
        "m.py": "from .plan import P\n\n"
                "def specs():\n"
                '    ok = P("data", None)\n'
                '    ok2 = P(("data", "fsdp"))\n'
                '    bad = P("dataa", None)\n'
                '    bad2 = P(("data", "fspd"))\n'}), ["axes"], None, None,
        ["unknown-mesh-axis"], ["dataa"], 2),
    "mesh-axis-kwargs-defaults": (dict(_KNOB_BASE, **{
        "m.py": "def reduce(x, collective):\n"
                '    return collective(x, axis_name="hvdd")\n\n'
                'def step(x, dp_axis="dta"):\n'
                "    return x\n"}), ["axes"], None, None,
        ["unknown-mesh-axis"], [], 2),
    "mesh-axes-clean": (dict(_KNOB_BASE, **{
        "m.py": "from .plan import P\n\n"
                'def step(x, collective, axis_name="hvd",\n'
                '         dp_axis="data"):\n'
                '    spec = P(("data", "fsdp"), None)\n'
                "    return collective(x, axis_name=axis_name)\n"}),
        ["axes"], None, None, [], [], 0),
    "metric-naming": ({"m.py": (
        "def instrument(reg):\n"
        '    reg.counter("hvd_tpu_good_total").inc()\n'
        '    reg.counter("hvd_tpu_bad_counter").inc()\n'
        '    reg.gauge("hvd_tpu_bad_gauge_total").set(1)\n')}, ["metrics"],
        {"metrics.md": "hvd_tpu_good_total hvd_tpu_bad_counter "
                       "hvd_tpu_bad_gauge_total"}, None,
        ["metric-name"], [], 2),
    "metric-doc-drift": ({"m.py": 'def f(reg):\n'
                                  '    reg.counter("hvd_tpu_undocumented_total")\n'},
                         ["metrics"], {"metrics.md": "# catalog\n"}, None,
                         ["metric-doc-drift"], [], 1),
    "metric-tenant-cardinality": ({"m.py": (
        "def instrument(reg, exporter, tenant):\n"
        '    reg.counter("hvd_tpu_ok_total").labels(tenant=tenant).inc()\n'
        '    fam = reg.counter("hvd_tpu_fam_total")\n'
        "    fam.labels(tenant=tenant).inc()\n"
        "    exporter.labels(tenant=tenant)\n"
        "    exporter.labels(tenant_id=tenant)\n")}, ["metrics"],
        {"metrics.md": "hvd_tpu_ok_total hvd_tpu_fam_total"}, None,
        ["metric-tenant-cardinality"], ["64-series"], 2),
    "metric-tenant-clean": ({"m.py": (
        "def instrument(reg, exporter):\n"
        '    reg.counter("hvd_tpu_x_total").labels(site="a").inc()\n'
        '    exporter.labels(kind="b")\n')}, ["metrics"],
        {"metrics.md": "hvd_tpu_x_total"}, None, [], [], 0),
    "span-naming": ({"m.py": (
        "from ..obs import trace as trace_mod\n\n"
        "def hop():\n"
        '    with trace_mod.span("hvd_tpu_good"):\n'
        "        pass\n"
        '    trace_mod.instant("bare_name")\n'
        '    trace_mod.record_span("also_bare", parent=None,\n'
        "                          start_us=0.0, dur_us=1.0)\n")}, ["spans"],
        {"tracing.md": "hvd_tpu_good"}, None, ["span-name"], [], 2),
    "span-record-phase": ({"m.py": (
        "class B:\n"
        "    def work(self, req):\n"
        '        self._record_phase(req, "bare_phase", 0.0, 1.0)\n'
        '        self._record_phase(req, "hvd_tpu_phase_ok", 0.0, 1.0)\n')},
        ["spans"], {"tracing.md": "hvd_tpu_phase_ok"}, None,
        ["span-name"], ["bare_phase"], 1),
    "span-doc-drift": ({"m.py": "from ..obs import trace\n\n"
                                "def hop():\n"
                                '    with trace.span("hvd_tpu_undocumented"):\n'
                                "        pass\n"}, ["spans"],
                       {"tracing.md": "# span catalog\n"}, None,
                       ["span-doc-drift"], [], 1),
    "span-non-trace-receiver": ({"m.py": "def f(timeline):\n"
                                         '    timeline.span("free-form name")\n'},
                                ["spans"], {"tracing.md": ""}, None, [], [], 0),
    # wire protocol
    "protocol-clean": ({"net.py": PROTOCOL_FIXTURE}, ["protocol"],
                       {"serving.md": PROTOCOL_DOC}, None, [], [], 0),
    "protocol-unhandled": ({"net.py": PROTOCOL_FIXTURE
                            + "\n\nclass GhostRequest:\n    pass\n"},
                           ["protocol"], {"serving.md": PROTOCOL_DOC}, None,
                           ["unhandled-request-frame"], ["GhostRequest"], 1),
    "protocol-mismatched": ({"net.py": PROTOCOL_FIXTURE.replace(
        "        if isinstance(req, PingRequest):\n"
        "            return PingResponse()",
        "        if isinstance(req, PingRequest):\n"
        "            return AckResponse()")}, ["protocol"],
        {"serving.md": PROTOCOL_DOC}, None, ["mismatched-response"],
        ["PingResponse"], 1),
    "protocol-doc-drift": ({"net.py": PROTOCOL_FIXTURE}, ["protocol"],
                           {"serving.md": "| `PingRequest` | x |\n"}, None,
                           ["protocol-doc-drift"], ["EchoRequest"], 1),
    "protocol-non-service": ({"m.py": "class ServeRequest:\n    pass\n"},
                             ["protocol"], {"serving.md": ""}, None, [], [],
                             0),
    # bounded waits
    "wait-thread-join": ({"m.py": ("import threading\n"
                                   "def f(fn):\n"
                                   "    t = threading.Thread(target=fn)\n"
                                   "    t.start()\n"
                                   "    t.join()\n")}, ["waits"], None, None,
                         ["unbounded-wait"], ["join"], 1),
    "wait-bounded-join": ({"m.py": "def f(self):\n"
                                   "    self._thread.join(timeout=5)\n"},
                          ["waits"], None, None, [], [], 0),
    "wait-str-join": ({"m.py": 'def f(xs):\n'
                               '    return ", ".join(str(x) for x in xs)\n'},
                      ["waits"], None, None, [], [], 0),
    "wait-condition": ({"m.py": ("def f(self):\n"
                                 "    with self._cv:\n"
                                 "        self._cv.wait()\n"
                                 "        self._cv.wait_for(lambda: True)\n")},
                       ["waits"], None, None, ["unbounded-wait"], [], 2),
    "wait-bounded-condition": ({"m.py": (
        "def f(self):\n"
        "    with self._cv:\n"
        "        self._cv.wait(timeout=1.0)\n"
        "        self._cv.wait_for(lambda: True, timeout=2.0)\n")},
        ["waits"], None, None, [], [], 0),
    "wait-queue-and-request": ({"m.py": (
        "def f(self, client):\n"
        "    item = self.task_queue.get()\n"
        "    resp = client.request(PingRequest())\n")}, ["waits"], None, None,
        ["unbounded-wait"], [], 2),
    "wait-bounded-request": ({"m.py": (
        "def f(client):\n"
        "    return client.request(PingRequest(), timeout=30.0)\n")},
        ["waits"], None, None, [], [], 0),
    "wait-handle-exempt": ({"m.py": "def allreduce(tensor, handle):\n"
                                    "    return handle.wait()\n"},
                           ["waits"], None, None, [], [], 0),
    "wait-suppressed": ({"m.py": (
        "def supervise(proc_thread):\n"
        "    proc_thread.join()  # hvdlint: disable=unbounded-wait "
        "-- agent supervises the worker for the job's whole life\n")},
        ["waits"], None, None, [], [], 0),
    # the telemetry plane's alert catalog
    "obs-clean": (dict(_OBS_FILES), ["obs"],
                  {"observability.md": FIXTURE_OBS_DOC}, None, [], [], 0),
    "obs-undocumented-detector": (dict(_OBS_FILES), ["obs"], {
        "observability.md": FIXTURE_OBS_DOC.replace(
            "| `stuck_swap` | ticket | weights roll wedged |\n", "")}, None,
        ["detector-doc-drift"], ["stuck_swap"], 1),
    "obs-bad-severity": ({"obs/detect.py": FIXTURE_DETECT.replace(
        '"ticket"', '"warn"'), "obs/slo.py": FIXTURE_SLO}, ["obs"], {
        "observability.md": FIXTURE_OBS_DOC.replace("| ticket |",
                                                    "| warn |")}, None,
        ["alert-severity"], ["warn"], 1),
    "obs-slo-burn-doc-drift": (dict(_OBS_FILES), ["obs"], {
        "observability.md": FIXTURE_OBS_DOC.replace(
            "SLO violations page as `slo_burn:<slo>`.\n", "")}, None,
        ["detector-doc-drift"], ["slo_burn"], 1),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_fixture_parity_with_the_reference(case, tmp_path):
    files, names, docs, select, expect, fragments, count = PARITY[case]
    fs = lint_both(tmp_path, files, names, docs=docs, select=select)
    if expect is None:
        assert fs, case
    else:
        assert checks_of(fs) == expect, "\n".join(f.format() for f in fs)
    if count is not None:
        assert len(fs) == count, "\n".join(f.format() for f in fs)
    text = " ".join(f.message for f in fs)
    for frag in fragments:
        assert frag in text, (frag, text)


PORT_SPANS = ("from ..obs import trace\n\n"
              "def hop(x):\n"
              '    with trace.span("hvd_tpu_shared"):\n'
              '        trace.layer("hvd_tpu_port_only", x)\n')


@pytest.mark.parametrize("port_doc, count", [
    ("| `hvd_tpu_port_only` | layer range |\n", 0),   # either catalog
    ("", 1),                                         # in neither
])
def test_port_span_catalog_beside_the_shared_one(tmp_path, port_doc, count):
    """``span-doc-drift`` reads ``docs/tracing.md`` and the port's own
    catalog, ``LintConfig.port_tracing_doc``; ``trace.layer``'s literal
    names are spans to both checks."""
    fs = lint(tmp_path, {"m.py": PORT_SPANS}, [registries.SpanNameChecker],
              docs={"tracing.md": "| `hvd_tpu_shared` |\n"},
              extra={"horovod_tpu_torch/obs/spans.md": port_doc})
    assert [f.check for f in fs] == ["span-doc-drift"] * count
    assert all("hvd_tpu_port_only" in f.message for f in fs)
    bare = lint(tmp_path, {"m.py": PORT_SPANS.replace("hvd_tpu_port_only",
                                                      "port_only")},
                [registries.SpanNameChecker])
    assert [f.check for f in bare] == ["span-name"]


def test_select_group_aliases_expand():
    assert core.expand_select(["protocol,waits"]) == [
        "unhandled-request-frame", "mismatched-response",
        "protocol-doc-drift", "unbounded-wait"]
    assert core.expand_select(None) is None
    assert core.expand_select(["unknown-knob"]) == ["unknown-knob"]
    assert core.expand_select(["kernels"]) == ["kernel-dispatch",
                                               "kernel-parity"]
    for group, ids in ref_core.CHECK_GROUPS.items():
        assert core.CHECK_GROUPS[group] == ids


def test_default_checkers_replace_pallas_with_kernels():
    from horovod_tpu_torch.analysis.kernels import KernelChecker

    chosen = analysis.default_checkers()
    assert KernelChecker in chosen
    assert registries.ObservabilityChecker in chosen
    assert len(chosen) == len(__import__(
        "horovod_tpu.analysis", fromlist=["default_checkers"]
    ).default_checkers())


# --- torch.distributed under a rank branch (the reference misses these) ------

TORCH_RANK_BRANCH = """
import torch.distributed as dist

def sync(t):
    if dist.get_rank() == 0:
        dist.all_reduce(t)
    return t

def gather(out, t):
    if dist.get_rank() == 0:
        dist.all_gather_into_tensor(out, t)
    return out
"""

TORCH_RANK_MORE = """
import torch.distributed as dist

def groups(ranks):
    me = dist.get_rank()
    if me != 0:
        return None
    return dist.new_group(ranks)

def single(out, t, group):
    if dist.get_group_rank(group, dist.get_rank()) == 0:
        dist.all_gather_single(out, t, group=group)
        dist.reduce_scatter_tensor(t, out, group=group)
"""


@pytest.mark.parametrize("src, names", [
    (TORCH_RANK_BRANCH, ["all_reduce", "all_gather_into_tensor"]),
    (TORCH_RANK_MORE, ["new_group", "all_gather_single",
                       "reduce_scatter_tensor"]),
])
def test_torch_collectives_under_get_rank_are_findings(src, names, tmp_path):
    port = lint(tmp_path, {"m.py": src},
                [rank_divergence.RankDivergenceChecker])
    assert checks_of(port) == ["rank-divergent-collective"]
    assert len(port) == len(names)
    for f, name in zip(port, names):
        assert f"collective {name}()" in f.message
    ref = ref_core.run_checks(
        ref_core.LintConfig(root=tmp_path, package=PKG),
        checker_classes=[ref_rank.RankDivergenceChecker])
    assert len(ref) < len(port)   # the reference's names miss torch's


def test_torch_collectives_outside_rank_branches_are_clean(tmp_path):
    src = ("import torch.distributed as dist\n\n"
           "def sync(t):\n"
           "    dist.all_reduce(t)\n"
           "    if dist.get_rank() == 0:\n"
           "        print(t)\n"
           "    return t\n")
    assert lint(tmp_path, {"m.py": src},
                [rank_divergence.RankDivergenceChecker]) == []


# --- the lock checker's call resolution --------------------------------------

STEP_FILES = """
import threading
from . import tl


class StepFiles:
    def __init__(self):
        self._lock = threading.Lock()

    def write(self, x):
        with self._lock:
            tl.note(x)
"""

TIMELINE = """
import threading

_lock = threading.Lock()


def note(x):
    with _lock:
        pass


class Timeline:
    def __init__(self, f, flow):
        {init}
        self._flow = flow

    def emit(self, x):
        with _lock:
            {call}
"""


@pytest.mark.parametrize("init, call", [
    ("self._file = f", "self._file.write(x)"),
    ("self._file = f", "self._flow.queue.write(x)"),
    ("self._file = open(f)", "self._file.write(x)"),
])
def test_untyped_receiver_makes_no_lock_edge(init, call, tmp_path):
    """``self._file.write(x)`` under ``tl._lock`` must not resolve to
    ``StepFiles.write`` only because ``write`` is unique in the package
    (the reference's resolution, which reports a cycle here)."""
    files = {"files.py": STEP_FILES,
             "tl.py": TIMELINE.format(init=init, call=call)}
    assert lint(tmp_path, files, [locks.LockChecker]) == []
    ref = ref_core.run_checks(
        ref_core.LintConfig(root=tmp_path, package=PKG),
        checker_classes=[ref_locks.LockChecker])
    assert checks_of(ref) == ["lock-order-cycle"]


@pytest.mark.parametrize("init, call, header", [
    # the attribute's class is known from its constructor
    ("self._file = StepFiles()", "self._file.write(x)",
     "from .files import StepFiles\n"),
    # a parameter annotated with the class
    ("self._file = f", "self.save(x, self._file)",
     "from .files import StepFiles\n"),
])
def test_typed_receiver_keeps_its_lock_edge(init, call, header, tmp_path):
    timeline = header + TIMELINE.format(init=init, call=call) + (
        "\n    def save(self, x, files: StepFiles):\n"
        "        files.write(x)\n")
    files = {"files.py": STEP_FILES, "tl.py": timeline}
    fs = lint(tmp_path, files, [locks.LockChecker])
    assert checks_of(fs) == ["lock-order-cycle"]
    assert "StepFiles._lock" in fs[0].message and "tl._lock" in fs[0].message


def test_inherited_method_resolves_through_the_base(tmp_path):
    src = ("import threading\n"
           "_la = threading.Lock()\n"
           "_lb = threading.Lock()\n\n"
           "class Base:\n"
           "    def take_b(self):\n"
           "        with _lb:\n"
           "            pass\n\n"
           "class Child(Base):\n"
           "    def run(self):\n"
           "        with _la:\n"
           "            self.take_b()\n\n"
           "def other():\n"
           "    with _lb:\n"
           "        with _la:\n"
           "            pass\n")
    fs = lint(tmp_path, {"m.py": src}, [locks.LockChecker])
    assert checks_of(fs) == ["lock-order-cycle"]


# --- the kernel wrappers' discipline -----------------------------------------

KERNEL_OPS = '''
from .kernel_common import kernel, on_card

_signatures = {"hvd_copy": []}


def copy_plain(x):
    return x


@kernel
def copy(x):
    """A wrapper as the port writes them."""
    n = x.numel()
    if not on_card(x):
        return copy_plain(x)
    out = x.clone()
    copy.launches += 1
    return out
'''

KERNEL_COMMON = '''
def on_card(t):
    return t.device.type == "cuda"


def kernel(fn):
    fn.launches = 0
    return fn
'''

KERNEL_CU = '''
#include <cuda_runtime.h>
extern "C" int hvd_copy(const void* x, void* y, int n, void* stream) {
  return 0;
}
'''

_KERNEL_TREE = {
    "ops/kernel_common.py": KERNEL_COMMON,
    "ops/k.py": KERNEL_OPS,
}
_KERNEL_EXTRA = {
    "horovod_tpu_torch/csrc/k.cu": KERNEL_CU,
    "tests/test_torch_port_k.py": "from x import copy_plain\n",
    "chip_smoke.py": "from x import copy\n",
}

# id: (ops/k.py text, extra files over _KERNEL_EXTRA, check, fragment)
KERNEL_DEFECTS = {
    "no-plain-branch": (KERNEL_OPS.replace(
        "    if not on_card(x):\n        return copy_plain(x)\n", ""),
        {}, "kernel-dispatch", "first branch"),
    "branch-not-a-return": (KERNEL_OPS.replace(
        "        return copy_plain(x)", "        x = copy_plain(x)"),
        {}, "kernel-dispatch", "first branch"),
    "try-except-fallback": (KERNEL_OPS.replace(
        "    out = x.clone()\n",
        "    try:\n        out = x.clone()\n"
        "    except RuntimeError:\n        return copy_plain(x)\n"),
        {}, "kernel-dispatch", "quiet fallback"),
    "no-launch-count": (KERNEL_OPS.replace(
        "    copy.launches += 1\n", ""), {}, "kernel-dispatch",
        "launches count"),
    "plain-is-a-kernel": (KERNEL_OPS.replace(
        "def copy_plain(x):", "@kernel\ndef copy_plain(x):"),
        {"chip_smoke.py": "from x import copy, copy_plain\n"},
        "kernel-dispatch", "not a plain function"),
    "plain-not-named-by-tests": (KERNEL_OPS,
                                 {"tests/test_torch_port_k.py": "x = 1\n"},
                                 "kernel-parity", "tests/test_torch_port"),
    "wrapper-not-in-chip-smoke": (KERNEL_OPS, {"chip_smoke.py": "x = 1\n"},
                                  "kernel-parity", "chip_smoke.py"),
    "extern-c-unbound": (KERNEL_OPS.replace('"hvd_copy"', '"hvd_other"'),
                         {}, "kernel-parity", "hvd_copy"),
}


def test_kernel_check_clean_fixture(tmp_path):
    fs = lint(tmp_path, dict(_KERNEL_TREE), [kernels.KernelChecker],
              extra=_KERNEL_EXTRA)
    assert fs == [], "\n".join(f.format() for f in fs)


@pytest.mark.parametrize("case", sorted(KERNEL_DEFECTS))
def test_kernel_check_catches_seeded_defect(case, tmp_path):
    ops, extra, check, fragment = KERNEL_DEFECTS[case]
    fs = lint(tmp_path, dict(_KERNEL_TREE, **{"ops/k.py": ops}),
              [kernels.KernelChecker], extra=dict(_KERNEL_EXTRA, **extra))
    assert checks_of(fs) == [check], "\n".join(f.format() for f in fs)
    assert any(fragment in f.message for f in fs), [f.message for f in fs]


def test_kernel_wrapper_suppression_is_honoured(tmp_path):
    ops = KERNEL_OPS.replace(
        "    copy.launches += 1\n", "").replace(
        "@kernel\ndef copy(x):",
        "@kernel\ndef copy(x):  # hvdlint: disable=kernel-dispatch -- "
        "fixture: counted by its caller")
    fs = lint(tmp_path, dict(_KERNEL_TREE, **{"ops/k.py": ops}),
              [kernels.KernelChecker], extra=_KERNEL_EXTRA)
    assert fs == [], "\n".join(f.format() for f in fs)


# --- the CLI's exit contract ---------------------------------------------------

def _cli_tree(root: Path, bad: bool) -> None:
    files = dict(_KNOB_BASE)
    if bad:
        files["bad.py"] = BAD_RANK_BRANCH
    _materialize(root, files)


def test_cli_exit_contract(tmp_path, capsys):
    """0 clean (with the JSON artifact), 1 on a finding, 2 on an unknown
    check id (named), 3 when nothing was analyzed."""
    clean, bad, empty = (tmp_path / n for n in ("clean", "bad", "empty"))
    _cli_tree(clean, bad=False)
    _cli_tree(bad, bad=True)
    empty.mkdir()
    out = tmp_path / "lint.json"
    assert cli_main(["--root", str(clean), "--json", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert payload["tool"] == "hvdlint" and payload["package"] == PKG
    assert payload["findings"] == [] and payload["counts"] == {}
    assert cli_main(["--root", str(bad), "--json", "-"]) == 1
    text = capsys.readouterr().out
    assert "rank-divergent-collective" in text
    assert '"rank-divergent-collective": 1' in text
    assert cli_main(["--root", str(clean), "--select", "nope,locks"]) == 2
    assert "nope" in capsys.readouterr().err
    assert cli_main(["--root", str(empty)]) == 3
    assert cli_main(["--root", str(bad), "--select", "knobs"]) == 0


def test_cli_module_entry_point_nonzero_on_findings(tmp_path):
    _cli_tree(tmp_path, bad=True)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis",
         "--root", str(tmp_path), "--select", "rank-divergent-collective"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "bad.py" in proc.stdout and "allreduce" in proc.stdout


# --- the catalog ------------------------------------------------------------------

PORT_ONLY = ("kernel-dispatch", "kernel-parity", "step-rank-divergence")


def test_catalog_matches_docs_and_the_readme():
    """Shared ids: the reference's catalog entry and a docs/lint.md row;
    the port's own ids: a row of the README's port table."""
    doc = (REPO / "docs" / "lint.md").read_text()
    readme = (REPO / "README.md").read_text()
    shared = [c for c in core.CHECK_CATALOG if c not in PORT_ONLY]
    assert sorted(set(ref_core.CHECK_CATALOG) - set(shared)) == [
        "jaxpr-rank-divergence", "pallas-interpret-flag"]
    for cid in shared:
        assert core.CHECK_CATALOG[cid][0] == ref_core.CHECK_CATALOG[cid][0]
        assert f"`{cid}`" in doc, f"{cid} missing from docs/lint.md"
    for cid in PORT_ONLY:
        assert re.search(rf"^\|\s*`{cid}`\s*\|", readme, re.MULTILINE), \
            f"{cid} has no row in the README's port section"


def test_lint_findings_metric_recorded(monkeypatch):
    from horovod_tpu_torch.obs import metrics as obs_metrics

    monkeypatch.setattr(obs_metrics, "_default",
                        obs_metrics.MetricsRegistry())
    monkeypatch.setattr(obs_metrics, "_enabled", True)
    analysis.record_findings_metric([
        core.Finding("unknown-knob", "x.py", 1, "m"),
        core.Finding("unknown-knob", "y.py", 2, "m"),
        core.Finding("metric-name", "z.py", 3, "m"),
    ])
    analysis.record_findings_metric([])
    snap = obs_metrics.registry().snapshot()
    series = {tuple(sorted(s["labels"].items())): s["value"]
              for s in snap["hvd_tpu_lint_findings_total"]}
    assert series[(("check", "unknown-knob"),)] == 2
    assert series[(("check", "metric-name"),)] == 1
    assert series[(("check", "none"),)] == 0


# --- the gate ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree_findings():
    """The whole package linted once for this module."""
    return analysis.run(REPO)


def test_repo_tree_is_clean(tree_findings):
    assert tree_findings == [], "\n" + "\n".join(
        f.format() for f in tree_findings)


def test_repo_tree_clean_for_protocol_waits_and_kernels(tree_findings):
    """The three groups' ids, through the --select expansion, are all
    in the catalog and none of them has a finding on the tree."""
    ids = core.expand_select(["protocol", "waits", "kernels"])
    assert len(ids) == 6 and set(ids) <= set(core.CHECK_CATALOG)
    assert [f for f in tree_findings if f.check in ids] == []


def test_kernel_check_sees_every_wrapper():
    from horovod_tpu_torch.ops import launch_counts

    seen = kernels.kernel_wrappers(REPO)
    assert sorted(seen) == sorted(launch_counts()) == sorted([
        "flash_fwd", "flash_bwd", "quantize_blocks", "dequantize_blocks",
        "dequantize_accumulate", "blocked_matmul", "sgd_apply",
        "adam_apply"])
    for name, (path, line, plain) in seen.items():
        assert path.startswith(f"{PKG}/ops/") and plain.endswith("_plain")


def test_pre_init_knobs_are_what_the_port_reads():
    """Every PRE_INIT_KNOBS name is read raw somewhere in the package
    (none is declared only to silence the checker), and the whole tree's
    knob checks pass (the gate above)."""
    import importlib

    config = importlib.import_module("horovod_tpu_torch.config")
    text = "\n".join(p.read_text() for p in (REPO / PKG).rglob("*.py")
                     if p.name != "config.py")
    for name in config.PRE_INIT_KNOBS:
        assert re.search(rf"(HVD_TPU|HOROVOD)_{name}\b", text), name


def test_ast_tier_imports_no_torch():
    """The AST tier and the sanitizer import no torch at module level."""
    code = ("import sys, types\n"
            f"stub = types.ModuleType({PKG!r}); "
            f"stub.__path__ = [{str(REPO / PKG)!r}]\n"
            f"sys.modules[{PKG!r}] = stub\n"
            f"import {PKG}.analysis as a\n"
            f"from {PKG}.analysis import kernels, sanitizer, __main__\n"
            "a.default_checkers()\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "assert not [m for m in sys.modules if m.startswith('jax') "
            "or m.startswith('horovod_tpu.')]\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
