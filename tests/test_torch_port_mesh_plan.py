"""The port's MeshPlan (``horovod_tpu_torch/plan``) against the reference's
(``horovod_tpu/plan``), mirroring ``tests/test_mesh_plan.py``.

* Derivations and rejections are pure arithmetic, held equal field for
  field (and message for message) to the reference's plans over the 8
  virtual CPU devices.
* The session's plan runs on one 4-rank gloo world spawned for the
  module (``tests/torch_port_workers.py``): the default plan wraps the
  global mesh; a declared plan registers one process set per axis group
  and hands ``make_train_step`` its reduce group; ``data × fsdp``
  declares the topology's tiers.
* Legacy equivalence: a step under the default plan and a step with no
  plan issue the same collectives and give the same bits (DP and ZeRO);
  the 2-D ``data × fsdp`` wire trains as the 1-D one (the reference
  test's rtol 1e-6 on losses, rtol 1e-5 / atol 1e-6 on parameters), and
  every run within rtol 1e-5 / atol 1e-6 of the reference's step on the
  same toy problem (8 devices there, 4 ranks here: the same global
  mean).
* Rank invariance: a planner-built step issues the same collective
  sequence on every rank (the reference checks its jaxpr).

The FSDP, pipeline, MoE and layout-autotune cases are in
``tests/test_torch_port_{fsdp,pipeline,moe,autotune}.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import horovod_tpu as jhvd
from horovod_tpu.config import Config as JaxConfig
from horovod_tpu.config import parse_mesh_plan as jax_parse_mesh_plan
from horovod_tpu.optim.zero import make_zero_train_step as jax_zero_step
from horovod_tpu.parallel import make_mesh as jax_make_mesh
from horovod_tpu.plan import MeshPlan as JaxMeshPlan
from horovod_tpu.plan import mesh_plan as jax_plan_mod
from horovod_tpu.plan import resolve_plan as jax_resolve_plan

from horovod_tpu_torch.config import Config, parse_mesh_plan
from horovod_tpu_torch.parallel import make_mesh
from horovod_tpu_torch.plan import (MeshPlan, build_device_mesh,
                                    fsdp_param_spec, layout_lattice,
                                    resolve_plan, tp_owned_slice,
                                    tp_param_spec)

import torch_port_workers as workers
from test_mesh_plan import _session_plan as jax_session_plan
from test_mesh_plan import _toy_problem

N = 4
SPECS = ["hvd=8", "data=8", "data=4,fsdp=2", "data=2,fsdp=4",
         "data=2,tensor=4", "dp=2,sp=2,tp=2", "sp=8", "tensor=8",
         "data=2,fsdp=2,tensor=2", "fsdp=8"]
SHAPES = [(), (7,), (8,), (3, 8, 4), (16, 16), (64, 6), (5, 5), (2, 4, 8)]


def _spec(s):
    return tuple(s)


def _derived(plan, torch_side: bool):
    """Every derivation of ``plan`` as plain values."""
    zeros = ((lambda s: np.zeros(s)) if torch_side
             else (lambda s: jnp.zeros(s)))
    try:
        reduce_axis = plan.reduce_axis()
    except ValueError as e:
        reduce_axis = str(e)
    return {
        "axes": tuple(plan.axes), "axis_names": plan.axis_names,
        "world_size": plan.world_size, "describe": plan.describe(),
        "reduce_axes": plan.reduce_axes(), "reduce_axis": reduce_axis,
        "reduce_width": plan.reduce_width(),
        "batch_spec": _spec(plan.batch_spec()),
        "shard_axis": plan.shard_axis(),
        "param_spec": [_spec(plan.param_spec(zeros(s))) for s in SHAPES],
        "axis_groups": {n: plan.axis_groups(n) for n in plan.axis_names},
        "topo_tiers": (None if plan.topo_tiers() is None else
                       (plan.topo_tiers().pods,
                        plan.topo_tiers().chips_per_pod)),
        "wire": [plan.modeled_wire_bytes(b) for b in (1024, 1000, 7)],
        "has": [plan.has_axis(n) for n in ("data", "fsdp", "tp", "sp")],
    }


class TestDerivations:
    @pytest.mark.parametrize("spec", SPECS)
    def test_derivations_match_the_reference(self, spec):
        ref = JaxMeshPlan.from_spec(spec, devices=jax.devices()[:8])
        got = MeshPlan.from_spec(spec, world=8)
        assert _derived(got, True) == _derived(ref, False)

    def test_2d_reduce_wire(self):
        plan = MeshPlan.from_spec("data=4,fsdp=2", world=8)
        assert plan.reduce_axes() == ("data", "fsdp")
        assert plan.reduce_axis() == ("data", "fsdp")
        assert plan.reduce_width() == 8
        assert plan.batch_spec() == (("data", "fsdp"),)

    def test_model_axes_excluded_from_reduce(self):
        plan = MeshPlan.from_spec("data=4,tensor=2", world=8)
        assert plan.reduce_axis() == "data"
        assert plan.axis_size("tensor") == 2
        wire = plan.modeled_wire_bytes(1024)
        assert wire["tensor"] == 0 and wire["data"] > 0
        assert plan.batch_axes() == ("data",)
        assert MeshPlan.from_spec("dp=2,sp=2,tp=2",
                                  world=8).batch_axes() == ("dp", "sp")

    def test_axis_groups_partition_the_world(self):
        plan = MeshPlan.from_spec("data=4,fsdp=2", world=8)
        data_groups = plan.axis_groups("data")
        fsdp_groups = plan.axis_groups("fsdp")
        assert sorted(sum(data_groups, [])) == list(range(8))
        assert sorted(sum(fsdp_groups, [])) == list(range(8))
        assert fsdp_groups[0] == [0, 1]
        assert data_groups[0][:2] == [0, 2]
        # Several axes at once: their product, the others pinned.
        assert plan.mesh.groups(("data", "fsdp")) == [list(range(8))]
        three = MeshPlan.from_spec("dp=2,sp=2,tp=2", world=8)
        assert three.mesh.groups(("dp", "sp")) == [[0, 2, 4, 6],
                                                   [1, 3, 5, 7]]

    def test_from_mesh_wraps_legacy_mesh(self):
        mesh = make_mesh({"dp": 4, "tp": 2}, world=8)
        plan = MeshPlan.from_mesh(mesh)
        ref = JaxMeshPlan.from_mesh(jax_make_mesh({"dp": 4, "tp": 2}))
        assert plan.mesh is mesh
        assert plan.axes == ref.axes == (("dp", 4), ("tp", 2))
        assert plan.reduce_axis() == ref.reduce_axis() == "dp"

    def test_resolve_plan_precedence(self):
        explicit = MeshPlan.from_spec("data=8", world=8)
        assert resolve_plan(None, explicit) is explicit
        mesh = build_device_mesh({"dp": 8}, world=8)
        assert resolve_plan(mesh, None).mesh is mesh
        ref_mesh = jax_make_mesh({"dp": 8})
        assert (resolve_plan(mesh, None).axes
                == jax_resolve_plan(ref_mesh, None).axes)

    @pytest.mark.parametrize("world", [1, 2, 3, 4, 6, 8, 12, 16, 64])
    def test_layout_lattice_factors_world(self, world):
        layouts = layout_lattice(world)
        assert layouts == jax_plan_mod.layout_lattice(world)
        for spec in layouts:
            sizes = parse_mesh_plan(spec, world_size=world)
            assert np.prod(list(sizes.values())) == world

    @pytest.mark.parametrize("path", ["block_0/attn/qkv/kernel",
                                      "block_0/mlp/up/kernel",
                                      "block_0/mlp/up/bias",
                                      "block_0/attn/out/kernel", "embed"])
    def test_tp_and_fsdp_rules(self, path):
        for shape in SHAPES + [(64, 192), (192,)]:
            for n in (1, 2, 4):
                got = (_spec(tp_param_spec(path, np.zeros(shape), n)),
                       tp_owned_slice(path, shape, n, n - 1),
                       _spec(fsdp_param_spec(np.zeros(shape), n, "fsdp")))
                ref = (_spec(jax_plan_mod.tp_param_spec(
                           path, jnp.zeros(shape), n)),
                       jax_plan_mod.tp_owned_slice(path, shape, n, n - 1),
                       _spec(jax_plan_mod.fsdp_param_spec(
                           jnp.zeros(shape), n, "fsdp")))
                assert got == ref, (shape, n)


class TestSpecRejection:
    @pytest.mark.parametrize("spec,match", [
        ("bogus=8", "unknown axis"),
        ("data", "axis=size"),
        ("data=", "axis=size"),
        ("=8", "axis=size"),
        ("data=x", "bad size"),
        ("data=0", "must be >= 1"),
        ("data=-2", "must be >= 1"),
        ("data=2,data=4", "appears twice"),
        ("", "empty spec"),
        (",", "empty spec"),
    ])
    def test_rejection_matrix(self, spec, match):
        with pytest.raises(ValueError, match=match) as got:
            parse_mesh_plan(spec)
        with pytest.raises(ValueError) as ref:
            jax_parse_mesh_plan(spec)
        assert str(got.value) == str(ref.value)

    def test_world_size_must_factor_exactly(self):
        with pytest.raises(ValueError, match="factor the device count") as e:
            parse_mesh_plan("data=3", world_size=8)
        with pytest.raises(ValueError) as ref:
            jax_parse_mesh_plan("data=3", world_size=8)
        assert str(e.value) == str(ref.value)
        with pytest.raises(ValueError, match="factor the device count"):
            MeshPlan.from_spec("data=8,fsdp=2", world=8)
        with pytest.raises(ValueError, match="unknown axis"):
            MeshPlan.from_axes({"banana": 2}, world=8)
        with pytest.raises(ValueError, match="needs 16 devices"):
            build_device_mesh({"dp": 16}, world=8)

    def test_config_env_knob_validates(self, monkeypatch):
        for val, want in (("data=4,fsdp=2", "data=4,fsdp=2"), ("", None)):
            monkeypatch.setenv("HVD_TPU_MESH_PLAN", val)
            assert Config.from_env().mesh_plan == want
            assert JaxConfig.from_env().mesh_plan == want
        monkeypatch.setenv("HVD_TPU_MESH_PLAN", "data=4,banana=2")
        with pytest.raises(ValueError, match="unknown axis"):
            Config.from_env()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


class TestSessionPlan:
    def test_default_plan_wraps_the_global_mesh(self, world):
        for r, out in enumerate(world.run("plan_view", spec=None)):
            assert out["axes"] == [("hvd", N)]
            assert out["is_global_mesh"] and out["resolved_is_session"]
            assert out["sets"] == {} and out["reduce_width"] == N
            assert out["coords"] == {"hvd": r}
            assert out["topology"] == [1, N]

    def test_declared_plan(self, world):
        """``data=2,fsdp=2``: one process set per axis group (found, not
        duplicated, when registered again), the reduce group the whole
        world, the tiers 2x2; the default restored after."""
        ref = JaxMeshPlan.from_spec("data=2,fsdp=2",
                                    devices=jax.devices()[:N])
        for r, out in enumerate(world.run("plan_view",
                                          spec="data=2,fsdp=2")):
            assert out["sets"] == {n: ref.axis_groups(n)
                                   for n in ref.axis_names}
            assert out["sets_found"]
            assert out["reduce_width"] == N
            assert out["topology"] == [2, 2]
            assert out["config_plan"] == "data=2,fsdp=2"
            assert out["restored"] == f"hvd={N}"
            for n in ref.axis_names:
                assert out["groups"][n] == next(
                    g for g in ref.axis_groups(n) if r in g)

    def test_model_axis_plan_reduces_over_the_data_group(self, world):
        for r, out in enumerate(world.run("plan_view",
                                          spec="data=2,tensor=2")):
            assert out["reduce_width"] == 2
            assert out["groups"]["data"] == [r % 2, r % 2 + 2]
            assert out["topology"] == [1, N]

    def test_plan_from_the_environment(self, world):
        out = world.run("plan_from_env", spec="data=2,fsdp=2")
        for o in out:
            assert o["plan"] == "data=2,fsdp=2"
            assert o["sets"] == [[0, 1], [0, 1, 2, 3], [0, 2], [1, 3],
                                 [2, 3]]
        for o in world.run("plan_from_env", spec="data=3"):
            assert "factor the device count" in o["error"]
            assert not o["initialized"]


def _toy_numpy():
    loss_fn, params, (x, y) = _toy_problem()
    return (loss_fn, params, {"w": np.asarray(params["w"]),
                              "b": np.asarray(params["b"]),
                              "x": np.asarray(x), "y": np.asarray(y)})


def _reference(kind, spec):
    loss_fn, params, _ = _toy_problem()
    batch = _toy_problem()[2]
    with jax_session_plan(spec):
        if kind == "zero":
            init_z, step_z = jax_zero_step(
                loss_fn, optax.sgd(0.1, momentum=0.9))
            p = jax.tree.map(jnp.copy, params)
            s = init_z(params)
            losses = []
            for _ in range(3):
                p, s, loss = step_z(p, s, batch)
                losses.append(float(loss))
        else:
            tx = jhvd.DistributedOptimizer(optax.sgd(0.1))
            step = jhvd.make_train_step(loss_fn, tx, donate=False)
            p = jax.tree.map(jnp.copy, params)
            s = tx.init(p)
            losses = []
            for _ in range(3):
                p, s, loss = step(p, s, batch)
                losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in p.items()}


def _close_to_reference(out, ref):
    losses, params = ref
    for o in out:
        np.testing.assert_allclose(o["losses"], losses, rtol=1e-5,
                                   atol=1e-6)
        for k, v in params.items():
            np.testing.assert_allclose(o["params"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def _bitwise(a, b):
    for x, y in zip(a, b):
        assert x["losses"] == y["losses"]
        assert x["calls"] == y["calls"]
        for k in x["params"]:
            np.testing.assert_array_equal(x["params"][k], y["params"][k])


class TestPlanLegacyEquivalence:
    @pytest.mark.parametrize("kind", ["dp", "zero"])
    def test_default_plan_is_the_legacy_wire(self, world, kind):
        """The default plan and no plan at all: the same collectives
        and the same bits (the reference's ``test_dp_step`` and
        ``test_zero_step``), within tolerance of the reference's step."""
        _, _, arrays = _toy_numpy()
        legacy = world.run("plan_toy_steps", spec="off", kind=kind,
                           steps=3, **arrays)
        planned = world.run("plan_toy_steps", spec=None, kind=kind,
                            steps=3, **arrays)
        _bitwise(legacy, planned)
        assert planned[0]["calls"]
        _close_to_reference(planned, _reference(kind, None))

    def test_2d_plan_matches_1d_numerics(self, world):
        _, _, arrays = _toy_numpy()
        one = world.run("plan_toy_steps", spec=None, kind="dp", steps=3,
                        **arrays)
        two = world.run("plan_toy_steps", spec="data=2,fsdp=2", kind="dp",
                        steps=3, **arrays)
        for a, b in zip(one, two):
            np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-6)
            for k in a["params"]:
                np.testing.assert_allclose(b["params"][k], a["params"][k],
                                           rtol=1e-5, atol=1e-6)
        _close_to_reference(two, _reference("dp", "data=4,fsdp=2"))

    def test_model_axis_plan_matches_the_pair_sets(self, world):
        """``data=2,tensor=2``: the step reduces over each data group
        ({0, 2} and {1, 3}), bit for bit the process-set step over the
        same pairs; the two groups' replicas differ."""
        _, _, arrays = _toy_numpy()
        planned = world.run("plan_toy_steps", spec="data=2,tensor=2",
                            kind="dp", steps=3, **arrays)
        pairs = world.run("plan_toy_steps", spec=None, kind="dp", steps=3,
                          pair=True, **arrays)
        for a, b in zip(planned, pairs):
            assert a["losses"] == b["losses"]
            for k in a["params"]:
                np.testing.assert_array_equal(a["params"][k],
                                              b["params"][k])
        assert all(w == 2 for _, w in planned[0]["calls"])
        np.testing.assert_array_equal(planned[0]["params"]["w"],
                                      planned[2]["params"]["w"])
        assert not np.array_equal(planned[0]["params"]["w"],
                                  planned[1]["params"]["w"])


class TestRankInvariance:
    @pytest.mark.parametrize("spec", ["data=2,fsdp=2", "data=2,tensor=2"])
    def test_planner_step_rank_invariant(self, world, spec):
        """A planner-built step issues the same collectives, in the same
        order and widths, on every rank."""
        _, _, arrays = _toy_numpy()
        out = world.run("plan_toy_steps", spec=spec, kind="dp", steps=2,
                        **arrays)
        assert out[0]["calls"]
        for o in out[1:]:
            assert o["calls"] == out[0]["calls"]
