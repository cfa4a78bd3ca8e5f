"""The port's native control plane (``horovod_tpu_torch/native``) against
the reference's (``horovod_tpu/native``).

Mirrors ``tests/test_native.py``, ``tests/test_native_runtime.py`` and
``tests/test_topo.py::TestNativeTwin``.  The port's library is built
here with g++ and must load (no case passes on a Python fallback); the
reference's is loaded only through ``horovod_tpu.native.bindings``, as
its own tests load it.  Parity, bit for bit:

* the wire: the port's ``encode_requests``/``encode_responses`` bytes
  equal the reference's on the same messages, and both C++ round-trip
  hooks give the bytes back;
* the controller: the same response lists, cache hits and missing-rank
  reports as the reference's ``Controller`` on the same submission
  sequences;
* the planners: ``plan_buckets``, the two-phase flags and the two-tier
  choice equal the reference's ``plan_buckets_py``,
  ``plan_two_phase_flags`` and ``choose_algo`` on the exhaustive small
  cases of ``tests/test_native.py`` and on GPT-medium's 197 leaves.

The coordinator runs across 3 processes (one ``World``), where ``init``
has also started the session's cross-process monitor over it.
"""

import ctypes
import json
import os
import tempfile
import threading

import numpy as np
import pytest

from horovod_tpu.native import bindings as jbindings
from horovod_tpu.native import runtime as jrt
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.topo import schedule as jschedule
from horovod_tpu.topo.costmodel import TierParams as JTierParams
from horovod_tpu.topo.costmodel import TopoCostParams as JTopoCostParams
from horovod_tpu.topo.topology import MeshTopology as JMeshTopology

from horovod_tpu_torch import native
from horovod_tpu_torch.native import bindings, build, planner
from horovod_tpu_torch.native import runtime as rt
from horovod_tpu_torch.ops import fusion

from torch_port_workers import World

GPT_MEDIUM = dict(vocab=32000, n_layer=24, d=1024, d_ff=4096, seq=1024)


@pytest.fixture(scope="module", autouse=True)
def built():
    """The port's library, built by g++ from its own sources, and the
    reference's, loaded through its own bindings."""
    assert bindings.available(), build.last_error
    assert bindings.abi_version() == bindings.ABI_VERSION == 3
    assert jbindings.available()


def gpt_medium_leaf_bytes() -> list:
    """The f32 bytes of GPT-medium's 197 leaves, in the port's tree order
    (``fusion.tree_flatten``: names sorted by their dotted parts)."""
    g = GPT_MEDIUM
    d, f = g["d"], g["d_ff"]
    shapes = {"embed.embedding": (g["vocab"], d),
              "lm_head.kernel": (d, g["vocab"]), "ln_f.bias": (d,),
              "ln_f.scale": (d,), "pos_embed": (g["seq"], d)}
    for i in range(g["n_layer"]):
        shapes.update({f"block_{i}.attn.out.kernel": (d, d),
                       f"block_{i}.attn.qkv.kernel": (d, 3 * d),
                       f"block_{i}.ln1.bias": (d,),
                       f"block_{i}.ln1.scale": (d,),
                       f"block_{i}.ln2.bias": (d,),
                       f"block_{i}.ln2.scale": (d,),
                       f"block_{i}.mlp.down.kernel": (f, d),
                       f"block_{i}.mlp.up.kernel": (d, f)})
    names = sorted(shapes, key=lambda n: n.split("."))
    return [4 * int(np.prod(shapes[n])) for n in names]


def test_gpt_medium_has_197_leaves():
    sizes = gpt_medium_leaf_bytes()
    assert len(sizes) == 197 and sum(sizes) == 4 * 368674816


# --- build --------------------------------------------------------------------

def test_library_is_keyed_by_a_hash_of_every_source_and_header(monkeypatch):
    """An edited header moves the library's path (the reference keys by
    mtime); the sources as they stand map to the loaded library."""
    assert build.library_path().name.startswith("libhvdtpu_native-")
    with tempfile.TemporaryDirectory() as tmp:
        for path in build.SRC_DIR.iterdir():
            with open(os.path.join(tmp, path.name), "wb") as f:
                f.write(path.read_bytes())
        monkeypatch.setattr(build, "SRC_DIR", build.Path(tmp))
        same = build.library_path()
        with open(os.path.join(tmp, "common.h"), "a") as f:
            f.write("\n// edited\n")
        assert build.library_path() != same
    monkeypatch.undo()
    assert same == build.library_path()
    assert build.library_path().exists()


def test_copied_sources_exclude_the_xla_adapters():
    """JAX's FFI library has no copy; the TF-XLA adapter's source sits
    beside the control plane's but builds apart (``tensorflow/
    xla_ops.py``), so the library compiles and hashes the rest only."""
    names = sorted(p.name for p in build.SRC_DIR.iterdir())
    assert "ffi_ops.cc" not in names and "tf_xla_ops.cc" in names
    built = sorted(p.name for p in build.sources()) + sorted(
        p.name for p in build.SRC_DIR.glob("*.h"))
    assert "tf_xla_ops.cc" not in built
    assert sorted(built) == sorted(
        ["common.h", "json_util.h", "wire.h", "wire.cc", "tensor_queue.h",
         "group_table.h", "response_cache.h", "stall_inspector.h",
         "controller.h", "controller.cc", "coordinator.h",
         "coordinator.cc", "timeline.h", "timeline.cc", "planner.cc",
         "c_api.cc"])


def test_dtype_codes_are_the_references_under_torch_names():
    import torch

    assert rt.DTYPE_CODES == jrt.DTYPE_CODES
    assert rt.DTYPE_CODES["bfloat16"] == 10
    assert rt.OP_CODES == jrt.OP_CODES and rt.WIRE_VERSION == 1
    names = {str(dt).split(".")[1] for dt in (
        torch.uint8, torch.int8, torch.uint16, torch.int16, torch.int32,
        torch.int64, torch.float16, torch.float32, torch.float64,
        torch.bool, torch.bfloat16)}
    assert names == set(rt.DTYPE_CODES)


# --- the wire codec ------------------------------------------------------------

OPS = ["allreduce", "allgather", "broadcast", "alltoall", "reducescatter",
       "adasum", "barrier", "join"]
DTYPES = sorted(rt.DTYPE_CODES)


def _requests(rng, pkg) -> list:
    return [pkg.Request(rank=int(rng.randint(0, 8)),
                        name=f"t{i}-{rng.randint(99)}-π",
                        op=OPS[int(rng.randint(len(OPS)))],
                        dtype=DTYPES[int(rng.randint(len(DTYPES)))],
                        size_bytes=int(rng.randint(0, 1 << 40)),
                        root_rank=int(rng.randint(-1, 4)),
                        group_id=int(rng.randint(-1, 3)))
            for i in range(int(rng.randint(0, 12)))]


def _responses_of(rng, pkg) -> list:
    return [pkg.Response(op=OPS[int(rng.randint(len(OPS)))],
                         dtype=DTYPES[int(rng.randint(len(DTYPES)))],
                         total_bytes=int(rng.randint(0, 1 << 40)),
                         root_rank=int(rng.randint(-1, 4)),
                         names=tuple(f"n{j}\n|\"" for j in
                                     range(int(rng.randint(0, 5)))))
            for _ in range(int(rng.randint(0, 6)))]


@pytest.mark.parametrize("seed", range(5))
def test_wire_bytes_equal_the_references(seed):
    for case in range(10):
        def rng():
            return np.random.RandomState(seed * 100 + case)

        reqs, jreqs = _requests(rng(), rt), _requests(rng(), jrt)
        data = rt.encode_requests(reqs)
        assert data == jrt.encode_requests(jreqs)
        assert rt.wire_requests_roundtrip_native(data) == data
        assert rt.decode_requests(data) == reqs
        assert jrt.decode_requests(data) == jreqs
        resps, jresps = _responses_of(rng(), rt), _responses_of(rng(), jrt)
        data = rt.encode_responses(resps)
        assert data == jrt.encode_responses(jresps)
        assert rt.wire_responses_roundtrip_native(data) == data
        assert rt.decode_responses(data) == resps


def test_malformed_wire_rejected():
    with pytest.raises(ValueError):
        rt.decode_responses(b"\x07\x00\x00\x00\x00")  # bad version
    assert rt._lib().hvd_wire_requests_roundtrip(
        (ctypes.c_uint8 * 3)(1, 2, 3), 3, None, 0) == -1


# --- the controller ------------------------------------------------------------

def _sub(rank, name, op="allreduce", dtype="float32", size=64, root=-1,
         group=-1):
    return ("submit", dict(rank=rank, name=name, op=op, dtype=dtype,
                           size_bytes=size, root_rank=root, group_id=group))


C = ("compute",)
SCENARIOS = {
    "not_ready_until_all": (3, 1 << 20, [
        _sub(0, "g0"), _sub(1, "g0"), C, _sub(2, "g0"), C, C]),
    "fusion_threshold_and_order": (2, 100, [
        *[_sub(r, n, size=s) for n, s in
          [("a", 40), ("b", 40), ("c", 40), ("d", 200)] for r in (0, 1)],
        C]),
    "fusion_class": (1, 1 << 20, [
        _sub(0, "f32"), _sub(0, "bf16", dtype="bfloat16"),
        _sub(0, "gather", op="allgather"),
        _sub(0, "bcast", op="broadcast", root=0), C]),
    "ready_order": (2, 0, [_sub(0, "x"), _sub(0, "y"), _sub(1, "y"),
                           _sub(1, "x"), C]),
    "metadata_mismatch": (2, 1 << 20, [
        _sub(0, "g"), _sub(1, "g", dtype="bfloat16"), ("error",), C]),
    "cache_steady_state": (2, 1 << 20, [
        *[x for _ in range(5) for x in
          [_sub(r, n) for n in ("g0", "g1", "g2") for r in (0, 1)] + [C]],
        ("stats",)]),
    "group_atomicity": (2, 0, [
        ("register", ["ga", "gb"]), _sub(0, "ga"), _sub(1, "ga"),
        _sub(0, "solo"), _sub(1, "solo"), C, _sub(0, "gb"), _sub(1, "gb"),
        C]),
    "pending_partial": (4, 1 << 20, [_sub(0, "slow"), _sub(2, "slow"),
                                     ("partial",)]),
    "out_of_range": (3, 1 << 20, [_sub(7, "g"), ("error",), _sub(-1, "g"),
                                  ("error",)]),
    "unregistered_group": (1, 1 << 20, [_sub(0, "g", group=42), C]),
    "registration_replans": (1, 0, [
        _sub(0, "ga", size=10), _sub(0, "gb", size=10), C,
        ("register", ["ga", "gb"]), _sub(0, "ga", size=10),
        _sub(0, "gb", size=10), C, ("stats",)]),
    "large_list": (1, 0, [*[_sub(0, f"tensor/{'x' * 60}/{i}")
                            for i in range(2000)], C, C]),
    "awkward_names": (2, 1 << 20, [_sub(0, 'enc|dec/"kernel"\nrow'),
                                   ("partial",)]),
}


def _random_scenario(seed: int):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 5))
    ops = []
    for _ in range(60):
        k = rng.randint(10)
        if k < 7:   # a name's size is fixed: a mismatch has its own case
            t = int(rng.randint(8))
            ops.append(_sub(int(rng.randint(n)), f"t{t}", size=37 * (t + 1)))
        elif k < 9:
            ops.append(C)
        else:
            ops.append(("partial",))
    return n, int(rng.randint(0, 600)), ops + [C, ("stats",)]


def _drive(pkg, world: int, threshold: int, ops: list) -> list:
    """The observable outputs of ``ops`` on ``pkg``'s Controller: each
    computed response list, each error message, stats and reports."""
    ctrl = pkg.Controller(world_size=world, fusion_threshold=threshold)
    out, pending_error = [], None
    try:
        for op in ops:
            if op[0] == "submit":
                try:
                    ctrl.submit(pkg.Request(**op[1]))
                except ValueError as e:
                    pending_error = str(e)
            elif op[0] == "error":
                out.append(("error", pending_error))
                pending_error = None
            elif op[0] == "compute":
                out.append([(r.op, r.dtype, r.total_bytes, r.root_rank,
                             tuple(r.names))
                            for r in ctrl.compute_response_list()])
            elif op[0] == "register":
                out.append(("group", ctrl.register_group(op[1])))
            elif op[0] == "partial":
                out.append(("partial", ctrl.pending_partial()))
            elif op[0] == "stats":
                out.append(("stats", ctrl.cache_stats()))
    finally:
        ctrl.close()
    assert pending_error is None, pending_error
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_decisions_equal_the_references(name):
    world, threshold, ops = SCENARIOS[name]
    got = _drive(rt, world, threshold, ops)
    assert got == _drive(jrt, world, threshold, ops)
    assert any(x for x in got)   # the scenario decided something


@pytest.mark.parametrize("seed", range(6))
def test_controller_random_sequences_equal_the_references(seed):
    world, threshold, ops = _random_scenario(seed)
    assert _drive(rt, world, threshold, ops) == \
        _drive(jrt, world, threshold, ops)


def test_controller_examples():
    """Two of the reference's cases by value, beside the parity."""
    world, threshold, ops = SCENARIOS["fusion_threshold_and_order"]
    (resps,) = _drive(rt, world, threshold, ops)
    assert [r[4] for r in resps] == [("a", "b"), ("c",), ("d",)]
    assert resps[0][2] == 80
    world, threshold, ops = SCENARIOS["pending_partial"]
    assert _drive(rt, world, threshold, ops) == \
        [("partial", [("slow", [1, 3])])]


# --- queue, stall table, timeline writer --------------------------------------

def test_tensor_queue_push_drain_and_concurrent_producers():
    q = native.NativeTensorQueue()
    try:
        for i in range(3):
            q.push(rt.Request(rank=1, name=f"t{i}", op="allgather",
                              dtype="bfloat16", size_bytes=64 * i))
        assert q.size() == 3
        reqs = q.drain()
        assert [r.name for r in reqs] == ["t0", "t1", "t2"]
        assert reqs[2].size_bytes == 128 and reqs[0].op == "allgather"
        assert q.size() == 0 and q.drain() == []

        def produce(k):
            for i in range(50):
                q.push(rt.Request(rank=k, name=f"p{k}.{i}"))

        threads = [threading.Thread(target=produce, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(q.drain()) == 200
    finally:
        q.close()


def test_stall_table_equals_the_references():
    for pkg in (rt, jrt):
        si = pkg.NativeStallInspector(world_size=3, warn_after_s=1.0,
                                      shutdown_after_s=5.0)
        si.submit("g", 0, now_s=100.0)
        si.submit("g", 2, now_s=100.2)
        si.submit('a|b"c\nd', 1, now_s=100.0)
        si.submit("done", 0, now_s=100.0)
        si.complete("done")
        reports = (si.report(now_s=100.5), si.report(now_s=102.0),
                   si.should_shutdown(now_s=104.0),
                   si.should_shutdown(now_s=106.0))
        si.close()
        if pkg is rt:
            got = reports
    assert got == reports
    assert got[0] == [] and got[2] is False and got[3] is True
    assert sorted(n for n, _, _ in got[1]) == ['a|b"c\nd', "g"]


def test_native_timeline_writes_the_references_events(tmp_path):
    files = {}
    for label, pkg in (("port", rt), ("ref", jrt)):
        path = str(tmp_path / f"{label}.json")
        tl = pkg.NativeTimeline(path, mark_cycles=True)
        tl.record("grad/w0", "NEGOTIATE", 0.0, 10.0)
        tl.record("grad/w0", "EXECUTE", 10.0, 25.0, '"op": "sum"')
        tl.record('weird"name\n', "QUEUE", 1.0, 2.0)
        tl.counter("train", 5.0, '"step_time_ms": 3.5')
        tl.flow("rpc", "s", "abc", 6.0)
        tl.mark_cycle(40.0)
        tl.close()
        files[label] = [{k: v for k, v in e.items() if k != "pid"}
                        for e in json.load(open(path))]
    assert files["port"] == files["ref"]
    assert len(files["port"]) == 6
    assert files["port"][1]["args"] == {"tensor": "grad/w0", "op": "sum"}


# --- the planners -------------------------------------------------------------

@pytest.mark.parametrize("trial", range(50))
def test_plan_buckets_equals_the_references_exhaustive(trial):
    rng = np.random.RandomState(0)
    for _ in range(trial + 1):   # the reference test's stream, case `trial`
        n = rng.randint(0, 40)
        sizes = rng.randint(0, 300, size=n).tolist()
        threshold = int(rng.randint(1, 400))
    want = jfusion.plan_buckets_py(sizes, threshold)
    assert planner.plan_buckets(sizes, threshold) == want
    assert fusion.plan_buckets(sizes, threshold) == want


def test_plan_buckets_edges():
    assert planner.plan_buckets([1000], 10) == [[0]]
    assert planner.plan_buckets([], 10) == []
    with pytest.raises(ValueError):
        planner.plan_buckets([-1], 10)


@pytest.mark.parametrize("threshold", [1 << 20, 16 << 20, 64 << 20,
                                       1 << 30])
def test_gpt_medium_plans_equal_the_references(threshold):
    sizes = gpt_medium_leaf_bytes()
    plan = planner.plan_buckets(sizes, threshold)
    assert plan == jfusion.plan_buckets_py(sizes, threshold)
    payloads = [sum(sizes[i] for i in b) for b in plan]
    for n, alpha, beta in ((2, 10.0, 100.0), (4, 1.0, 10.0),
                           (8, 100.0, 400.0)):
        assert planner.plan_two_phase_flags(payloads, n, alpha, beta) == \
            jfusion.plan_two_phase_flags(payloads, n, alpha, beta)
    for pods, chips in ((1, 2), (2, 2), (4, 8)):
        topo = JMeshTopology(pods, chips)
        params = JTopoCostParams(ici=JTierParams(10.0, 100.0),
                                 dcn=JTierParams(100.0, 10.0))
        assert planner.plan_hierarchical(
            payloads + sizes, pods, chips, 10.0, 100.0, 100.0, 10.0) == \
            [jschedule.choose_algo(b, topo, params)
             for b in payloads + sizes]


@pytest.mark.parametrize("seed", range(8))
def test_two_phase_flags_equal_the_references(seed):
    rng = np.random.RandomState(seed)
    payloads = rng.randint(0, 1 << 30, size=int(rng.randint(0, 30))).tolist()
    n = int(rng.randint(1, 64))
    alpha, beta = float(rng.uniform(0, 50)), float(rng.uniform(0.5, 900))
    want = jfusion.plan_two_phase_flags(payloads, n, alpha, beta)
    assert planner.plan_two_phase_flags(payloads, n, alpha, beta) == want
    assert fusion._dispatch_two_phase_flags(payloads, n, alpha, beta) == want


PARAM_GRID = [
    ((10.0, 100.0), (100.0, 10.0)),
    ((10.0, 100.0), (5.0, 10.0)),      # crossover 0
    ((10.0, 100.0), (100.0, 100.0)),   # never wins
    ((0.0, 50.0), (1.0, 5.0)),
]


@pytest.mark.parametrize("pods,chips", [(2, 4), (4, 2), (1, 8), (8, 1),
                                        (2, 2)])
def test_plan_hierarchical_equals_choose_algo(pods, chips):
    from horovod_tpu.topo.costmodel import hierarchical_crossover_bytes

    from horovod_tpu_torch.topo import schedule
    from horovod_tpu_torch.topo.costmodel import TierParams, TopoCostParams
    from horovod_tpu_torch.topo.topology import MeshTopology

    for ici, dcn in PARAM_GRID:
        jparams = JTopoCostParams(ici=JTierParams(*ici),
                                  dcn=JTierParams(*dcn))
        jtopo = JMeshTopology(pods, chips)
        xb = hierarchical_crossover_bytes(jtopo, jparams)
        sizes = [0, 1, 1 << 10, 1 << 20, 1 << 26, 1 << 30]
        if 0 < xb < 1 << 62:
            sizes += [xb - 1, xb, xb + 1]
        want = [jschedule.choose_algo(b, jtopo, jparams) for b in sizes]
        assert planner.plan_hierarchical(sizes, pods, chips, *ici,
                                         *dcn) == want
        params = TopoCostParams(ici=TierParams(*ici), dcn=TierParams(*dcn))
        topo = MeshTopology(pods, chips)
        assert [schedule._dispatch_algo(b, topo, params)
                for b in sizes] == want


def test_plan_hierarchical_rejects_invalid_input():
    with pytest.raises(ValueError, match="Invalid"):
        planner.plan_hierarchical([1024], 0, 4, 10.0, 100.0, 100.0, 10.0)


def test_knob_off_selects_the_python_twins(monkeypatch):
    """``HVD_TPU_USE_NATIVE_PLANNER=0``: the dispatchers never reach the
    native planner (made to raise here) and plan as the twins do."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.topo import schedule
    from horovod_tpu_torch.topo.costmodel import default_params
    from horovod_tpu_torch.topo.topology import MeshTopology

    def refuse(*args, **kwargs):
        raise AssertionError("the native planner was asked")

    monkeypatch.setenv("HVD_TPU_USE_NATIVE_PLANNER", "0")
    hvd.init(device="cpu")
    try:
        assert hvd.config().use_native_planner is False
        for name in ("plan_buckets", "plan_two_phase_flags",
                     "plan_hierarchical"):
            monkeypatch.setattr(planner, name, refuse)
        assert fusion.plan_buckets([5, 5, 5], 8) == [[0], [1], [2]]
        assert fusion._dispatch_two_phase_flags([1 << 30], 2, 10.0,
                                                100.0) == [True]
        assert schedule._dispatch_algo(1 << 30, MeshTopology(2, 2),
                                       default_params()) == \
            schedule.choose_algo(1 << 30, MeshTopology(2, 2),
                                 default_params())
    finally:
        hvd.shutdown()


def test_knob_on_asks_the_native_planner(monkeypatch):
    calls = []
    real = planner.plan_buckets
    monkeypatch.setattr(planner, "plan_buckets",
                        lambda s, t: calls.append(len(s)) or real(s, t))
    assert fusion.plan_buckets([5, 5, 5], 8) == [[0], [1], [2]]
    assert calls == [3]


# --- the coordinator across 3 processes ----------------------------------------

@pytest.fixture(scope="module")
def world():
    with tempfile.TemporaryDirectory() as tmp:
        w = World(3, os.path.join(tmp, "store"))
        try:
            yield w
        finally:
            w.close()


def test_session_monitor_runs_over_the_native_coordinator(world):
    for state in world.run("monitor_state"):
        assert state["running"] and state["cycles"] >= 2
        assert state["failure"] is None


def test_coordinator_negotiates_across_processes(world):
    res = world.run("native_coordinator", scenario="negotiate")
    for r in res:
        assert r[0] == []
        assert [x[4] for x in r[1]] == [["g0"]]
    assert res[0] == res[1] == res[2]


def test_coordinator_fuses_and_caches_across_processes(world):
    res = world.run("native_coordinator", scenario="fusion")
    for r in res:
        assert [[x[4] for x in cycle] for cycle in r[:4]] == \
            [[["grad0", "grad1", "grad2"]]] * 4
    assert res[0][4] == 3 and res[1][4] == res[2][4] == -1


def test_coordinator_barrier_and_mismatch_across_processes(world):
    waits = world.run("native_coordinator", scenario="barrier")
    assert waits[0][0] >= 0.25 and waits[2][0] >= 0.25
    res = world.run("native_coordinator", scenario="mismatch")
    assert res[0] == ["error"]
