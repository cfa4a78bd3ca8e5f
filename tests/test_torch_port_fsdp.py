"""The port's FSDP / HSDP (``horovod_tpu_torch/optim/fsdp.py``) and ZeRO
on a plan's reduce group (``optim/zero.py``) against the reference's,
mirroring ``tests/test_fsdp.py`` in full and ``tests/test_mesh_plan.py``'s
``test_fsdp_step`` and ``test_zero_step``.

The reference runs in this process over the 8 CPU devices; the port in
one 4-rank gloo world (``tests/torch_port_workers.py``), each rank on its
rows of the same global batch (so both compute the same global mean).
The toy problem is ``tests/test_fsdp.py``'s at four ranks (d = 16, 32
rows), made from a numpy seed.

Tolerances (the reference test's): losses within rtol 1e-4 and
parameters within rtol 2e-4 / atol 1e-6 of the reference's plain DP
step, FSDP's and HSDP's alike, global-norm clipping included; the
default plan against no plan, and HSDP from the session plan against
HSDP on an explicit mesh, bit for bit.  ZeRO under ``data=2,tensor=2``
(its reduce group the rank's data pair) against the reference's ZeRO
under ``data=4,tensor=2``: losses within rtol 1e-6, parameters within
rtol 1e-5 / atol 1e-6 (``test_2d_plan_matches_1d_numerics``'s).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.optim.fsdp import fsdp_spec as jax_fsdp_spec
from horovod_tpu.optim.fsdp import make_fsdp_train_step as jax_fsdp_step
from horovod_tpu.optim.zero import make_zero_train_step as jax_zero_step

import horovod_tpu_torch as thvd
from horovod_tpu_torch.optim import fsdp_spec, make_fsdp_train_step
from horovod_tpu_torch.parallel import make_mesh

import torch_port_workers as workers
from test_fsdp import _toy
from test_mesh_plan import _session_plan as jax_session_plan
from test_mesh_plan import _toy_problem

N = 4
STEPS = 5


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _ref_steps(build, params, batch, steps):
    """``steps`` steps of a reference step built by ``build(tx)``."""
    step, state = build
    p, losses = params, []
    for _ in range(steps):
        p, state, loss = step(p, state, batch)
        losses.append(float(loss))
    return losses, _flat(_np(p))


def _ref_dp(tx, params, batch, steps=STEPS):
    step = jhvd.make_train_step(_toy(N)[1], tx, donate=False)
    return _ref_steps((step, tx.init(params)), params, batch, steps)


def _ref_fsdp(tx, params, batch, steps=STEPS):
    shard, step = jax_fsdp_step(_toy(N)[1], tx, donate=False)
    p, s = shard(params)
    return _ref_steps((step, s), p, batch, steps)


def _ref_zero():
    loss_fn, params, batch = _toy_problem()
    tx = optax.sgd(0.1, momentum=0.9)
    with jax_session_plan("data=4,tensor=2"):
        init, step = jax_zero_step(loss_fn, tx)
        p, s = jax.tree.map(jnp.copy, params), init(params)
        losses = []
        for _ in range(3):
            p, s, loss = step(p, s, batch)
            losses.append(float(loss))
    return losses, _flat(_np(p))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params, _, (x, y) = _toy(N)
    p_np, x, y = _np(params), np.asarray(x), np.asarray(y)
    params2, _, (x2, y2) = _toy(N, seed=2)
    params1, _, (x1, y1) = _toy(N, seed=1)
    _, zp, (zx, zy) = _toy_problem()
    cases = {
        "dp": dict(kind="dp"),
        "fsdp": dict(kind="fsdp"),
        "off": dict(kind="off"),
        "hsdp": dict(kind="hsdp"),
        "plan_hsdp": dict(kind="plan_hsdp"),
        "aux": dict(kind="aux", optimizer="sgd", lr=1e-3, steps=1),
        "clip": dict(kind="fsdp", optimizer="adam", max_grad_norm=0.1,
                     params=_np(params2), x=np.asarray(x2),
                     y=np.asarray(y2)),
        "trains": dict(kind="fsdp", steps=60, params=_np(params1),
                       x=np.asarray(x1), y=np.asarray(y1)),
    }
    world = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    try:
        for case in cases.values():
            world.submit("fsdp_toy", **{"params": p_np, "x": x, "y": y,
                                        "steps": STEPS, **case})
        world.submit("zero_plan", spec="data=2,tensor=2",
                     w=np.asarray(zp["w"]), b=np.asarray(zp["b"]),
                     x=np.asarray(zx), y=np.asarray(zy), steps=3)
        ref = {
            "dp": _ref_dp(optax.adamw(1e-2), params, (jnp.asarray(x),
                                                      jnp.asarray(y))),
            "fsdp": _ref_fsdp(optax.adamw(1e-2), params,
                              (jnp.asarray(x), jnp.asarray(y))),
            "clip": _ref_dp(optax.chain(optax.clip_by_global_norm(0.1),
                                        optax.adam(1e-2)), params2,
                            (x2, y2)),
            "zero": _ref_zero(),
        }
        port = {name: world.collect(name) for name in cases}
        port["zero"] = world.collect("zero")
    finally:
        world.close()
    return port, ref


def _close(port_out, ref_run):
    losses, params = ref_run
    np.testing.assert_allclose(port_out["losses"], losses, rtol=1e-4)
    assert set(port_out["params"]) == set(params)
    for name, value in params.items():
        np.testing.assert_allclose(port_out["params"][name], value,
                                   rtol=2e-4, atol=1e-6, err_msg=name)


def test_fsdp_spec_picks_largest_divisible_axis():
    n = N
    for shape in [(3, 2 * n, 5 * n), (3,), (), (16, 16), (6, 8), (5, 5)]:
        want = tuple(jax_fsdp_spec(jnp.zeros(shape), n, "hvd"))
        assert tuple(fsdp_spec(torch.zeros(shape), n, "hvd")) == want, shape
    assert tuple(fsdp_spec(torch.zeros(3, 2 * n, 5 * n), n, "hvd")) == (
        None, None, "hvd")


def test_params_and_state_physically_sharded(runs):
    """Each rank holds 1/n of each matrix (split on its largest dim) and
    of each vector; Adam's moments have the slices' shapes."""
    port, _ = runs
    for out in port["fsdp"]:
        assert out["local_shapes"] == {"dense.kernel": [16, 4],
                                       "dense.bias": [4], "out": [4]}
        for key, shape in out["state_shapes"].items():
            name = key.rsplit(".", 1)[0]
            assert shape == out["local_shapes"][name], key


def test_matches_plain_dp(runs):
    port, ref = runs
    for out in port["fsdp"]:
        _close(out, ref["dp"])
        _close(out, ref["fsdp"])
    for out in port["dp"]:
        _close(out, ref["dp"])


def test_hsdp_multi_slice_matches_dp(runs):
    """Slices cut over ``ici`` only (2 of 4 ranks: half a matrix each),
    the same on both ``dcn`` ranks; the steps match DP."""
    port, ref = runs
    for r, out in enumerate(port["hsdp"]):
        assert out["local_shapes"]["dense.kernel"] == [16, 8]
        assert (out["axis"], out["dp_axis"]) == ("ici", "dcn")
        _close(out, ref["dp"])


def test_hsdp_from_the_session_plan(runs):
    """``data=2,fsdp=2``: the step derives HSDP (shard over ``fsdp``,
    replicate over ``data``) and computes the explicit mesh's bits."""
    port, _ = runs
    for a, b in zip(port["plan_hsdp"], port["hsdp"]):
        assert (a["axis"], a["dp_axis"]) == ("fsdp", "data")
        assert a["losses"] == b["losses"]
        for name in a["params"]:
            np.testing.assert_array_equal(a["params"][name],
                                          b["params"][name])


def test_fsdp_step(runs):
    """The default plan is the legacy wiring: bit for bit the step with
    no session plan (``tests/test_mesh_plan.py::test_fsdp_step``)."""
    port, _ = runs
    for a, b in zip(port["off"], port["fsdp"]):
        assert a["losses"] == b["losses"]
        for name in a["params"]:
            np.testing.assert_array_equal(a["params"][name],
                                          b["params"][name])


def test_trains(runs):
    port, _ = runs
    for out in port["trains"]:
        assert out["losses"][-1] < out["losses"][0] * 0.3, (
            out["losses"][0], out["losses"][-1])


def test_has_aux(runs):
    """The aux is this rank's (its loss on its rows); the loss returned is
    their mean over the ranks."""
    port, _ = runs
    auxes = [out["aux"][0] for out in port["aux"]]
    for out in port["aux"]:
        np.testing.assert_allclose(out["losses"][0], np.mean(auxes),
                                   rtol=1e-6)


def test_global_norm_clipping_matches_dp(runs):
    """The norm is over every shard: clip_by_global_norm(0.1) + Adam as
    the reference's DP step does it."""
    port, ref = runs
    for out in port["clip"]:
        _close(out, ref["clip"])


def test_zero_on_the_plans_reduce_group(runs):
    """``make_zero_train_step`` under ``data=2,tensor=2`` reduces over the
    rank's data pair (each collective two wide; a shard is half a
    leaf), as the reference's reduces over its plan's data axis."""
    port, ref = runs
    losses, params = ref["zero"]
    for out in port["zero"]:
        assert {width for _, width in out["calls"]} == {2}
        assert out["shards"] == {"w": 128, "b": 8}
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-6)
        for name, value in params.items():
            np.testing.assert_allclose(out["params"][name], value, rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    for out in port["zero"][1:]:
        for name in params:
            np.testing.assert_array_equal(out["params"][name],
                                          port["zero"][0]["params"][name])


def test_hsdp_rejects_unknown_axis():
    params, _, _ = _toy(N)
    thvd.init(device="cpu")
    try:
        with pytest.raises(ValueError, match="dp_axis"):
            make_fsdp_train_step(workers._toy_loss,
                                 lambda ps: torch.optim.AdamW(ps, lr=1e-3),
                                 dp_axis="nope")
        with pytest.raises(ValueError, match="must differ"):
            make_fsdp_train_step(workers._toy_loss,
                                 lambda ps: torch.optim.AdamW(ps, lr=1e-3),
                                 dp_axis="hvd")
    finally:
        thvd.shutdown()


def test_noop_flags_warn(caplog):
    mesh = make_mesh({"hvd": 1}, world=1)
    with caplog.at_level(logging.WARNING):
        make_fsdp_train_step(workers._toy_loss, torch.optim.SGD, mesh=mesh,
                             two_phase=False, error_feedback=True)
    assert "two_phase=False" in caplog.text
    assert "error_feedback=True" in caplog.text
