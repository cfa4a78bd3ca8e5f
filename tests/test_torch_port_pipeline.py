"""The port's GPipe (``horovod_tpu_torch/parallel/pipeline.py``,
``models/pipeline_gpt.py``) against the reference's, mirroring
``tests/test_pipeline.py`` and ``tests/test_mesh_plan.py::
test_pipeline_planner_axes_match_legacy``.

The reference runs in this process on the first four CPU devices; the
port in one 4-rank gloo world (``tests/torch_port_workers.py``), each
rank holding its stage and its ``dp`` rows.  The inputs are made from a
seed with numpy.

Tolerances: the toy stage's output within 1e-5 of the reference's and of
the serial composition (the reference test's), its gradients within
1e-4 (ditto); the planner's pipe/data wiring bit for bit the legacy
pp/dp one.  The pipelined GPT (4 layers, d_model 32, f32): logits within
2e-4 of the reference's pipelined and non-pipelined GPT (the reference
test's), the loss within 1e-5 and the gradients within 1e-5 + 1e-4 of
each leaf's largest value of the reference's (summed over ``dp``);
three AdamW steps at ``{dp: 2, pp: 2}`` within 1e-5 of the reference's
losses and at most 0.1% of the parameters more than 2e-6 from its (none
more than lr), the replicated leaves bit for bit alike on both pp ranks;
remat the same loss (1e-6) and gradients (1e-5 / 1e-7) as without.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from horovod_tpu.models.pipeline_gpt import PipelinedGPT as JaxPipelinedGPT
from horovod_tpu.models.pipeline_gpt import (
    pipelined_lm_loss_fn as jax_pipelined_loss)
from horovod_tpu.models.transformer import GPT as JaxGPT
from horovod_tpu.models.transformer import GPTConfig as JaxGPTConfig
from horovod_tpu.models.transformer import lm_loss_fn as jax_lm_loss_fn
from horovod_tpu.parallel import make_mesh as jax_make_mesh
from horovod_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from horovod_tpu.parallel.pipeline import (
    shard_stage_params as jax_shard_stages)
from horovod_tpu.parallel.train import init_opt_state as jax_init_opt_state
from horovod_tpu.parallel.train import (
    make_spmd_train_step as jax_spmd_step)
from horovod_tpu.parallel.train import shard_batch as jax_shard_batch
from jax.sharding import PartitionSpec as JP

from horovod_tpu_torch.models import GPTConfig, PipelinedGPT
from horovod_tpu_torch.parallel import (make_mesh, pipeline_apply,
                                        stack_stage_params,
                                        stage_param_shardings)
from horovod_tpu_torch.parallel.pipeline import pipeline_axes
from horovod_tpu_torch.plan import MeshPlan, P

import torch
import torch_port_workers as workers
from test_pipeline import _make_stages, _serial, _stage_fn

N = 4
CFG = dict(vocab_size=64, n_layer=4, n_head=4, d_model=32, d_ff=64,
           max_seq_len=16, attention="full")
GPT_LAYOUT = {"dp": 2, "pp": 2}
STEPS = 3


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _ref_pipeline(stacked, x, layout, n_micro):
    mesh = jax_make_mesh(layout, devices=jax.devices()[:N])
    stacked = jax_shard_stages(stacked, mesh)
    return np.asarray(jax_pipeline(_stage_fn, stacked, jnp.asarray(x),
                                   mesh=mesh, n_micro=n_micro))


def _ref_grads(stacked, x):
    mesh = jax_make_mesh({"pp": 4}, devices=jax.devices()[:N])

    def loss(params, xs):
        return jnp.sum(jax_pipeline(_stage_fn, params, xs, mesh=mesh,
                                    n_micro=2) ** 2)

    g, dx = jax.grad(loss, argnums=(0, 1))(
        jax_shard_stages(stacked, mesh), jnp.asarray(x))
    return _np(g), np.asarray(dx)


def _ref_gpt(tokens):
    """The reference's pipelined GPT at GPT_LAYOUT: its params, logits,
    loss and gradients, the plain GPT's on the reassembled tree, and
    STEPS AdamW steps of its spmd step."""
    cfg = JaxGPTConfig(**CFG, dtype=jnp.float32)
    mesh = jax_make_mesh(GPT_LAYOUT, devices=jax.devices()[:N])
    model = JaxPipelinedGPT(cfg, mesh, n_micro=2)
    inputs, targets = jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:])
    params = model.init(jax.random.PRNGKey(0), inputs)
    out = {"params": _np(params),
           "logits": np.asarray(model.apply(params, inputs))}
    loss, grads = jax.value_and_grad(jax_pipelined_loss(model))(
        params, (inputs, targets))
    out["loss"], out["grads"] = float(loss), _np(grads)
    flat = dict(params["embed"])
    bps = CFG["n_layer"] // GPT_LAYOUT["pp"]
    for s in range(GPT_LAYOUT["pp"]):
        stage = jax.tree.map(lambda p: p[s], params["stages"])
        for b in range(bps):
            flat[f"block_{s * bps + b}"] = stage[f"block_{b}"]
    flat.update(params["head"])
    plain = JaxGPT(cfg)
    out["plain_logits"] = np.asarray(plain.apply({"params": flat}, inputs))
    plain_loss, plain_grads = jax.value_and_grad(
        lambda p: jax_lm_loss_fn(plain)(p, (inputs, targets)))(flat)
    out["plain_loss"], out["plain_grads"] = (float(plain_loss),
                                             _np(plain_grads))
    tx = optax.adamw(3e-4, weight_decay=1e-4)
    state = jax_init_opt_state(tx, params)
    step = jax_spmd_step(jax_pipelined_loss(model), tx, donate=False)
    batch = jax_shard_batch((inputs, targets), mesh, JP("dp", None))
    losses, p = [], params
    for _ in range(STEPS):
        p, state, loss = step(p, state, batch)
        losses.append(float(loss))
    out["losses"], out["final"] = losses, _np(p)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _stage_leaf(flat_tree, name, stage):
    """The reference's leaf for the port's ``name`` on ``stage``."""
    return flat_tree[name][stage] if name.startswith("stages.") \
        else flat_tree[name]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    toy = _make_stages(4, d=8)
    x8 = np.random.RandomState(1).randn(8, 8).astype(np.float32)
    stacked2, _ = _make_stages(2, d=8)
    x_dp = np.random.RandomState(2).randn(8, 8).astype(np.float32)
    stacked6, _ = _make_stages(4, d=6)
    x6 = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    rng = np.random.RandomState(0)
    w = (rng.randn(4, 8, 8) * 0.1).astype(np.float32)
    xp = rng.randn(8, 8).astype(np.float32)
    tokens = np.random.RandomState(1).randint(0, 64, (8, 17)).astype(np.int32)
    cfg = {**CFG, "dtype": "float32"}

    world = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    try:
        for m in (1, 2, 4):
            world.submit("pipeline_toy", stacked=_np(toy[0]), x=x8,
                         layout={"pp": 4}, n_micro=m)
        world.submit("pipeline_toy", stacked=_np(stacked2), x=x_dp,
                     layout={"dp": 2, "pp": 2}, n_micro=2)
        for remat in (False, True):
            world.submit("pipeline_toy", stacked=_np(stacked6), x=x6,
                         layout={"pp": 4}, n_micro=2, grads=True, remat=remat)
        world.submit("pipeline_planner", w=w, x=xp, n_micro=2)
        world.submit("pipelined_gpt_errors", config=cfg, layout={"pp": 4},
                     n_layer=6, batch_rows=6, n_micro=4)
        ref_gpt = _ref_gpt(tokens)
        world.submit("pipelined_gpt", config=cfg, layout=GPT_LAYOUT,
                     params=ref_gpt["params"], tokens=tokens, steps=STEPS)
        ref = {
            "micro": {m: (_ref_pipeline(toy[0], x8, {"pp": 4}, m),
                          np.asarray(_serial(toy[1], jnp.asarray(x8))))
                      for m in (1, 2, 4)},
            "dp_pp": _ref_pipeline(stacked2, x_dp, {"dp": 2, "pp": 2}, 2),
            "grads": _ref_grads(stacked6, x6),
            "planner": np.asarray(jax_pipeline(
                lambda p, a: jnp.tanh(a @ p), jnp.asarray(w),
                jnp.asarray(xp), mesh=jax_make_mesh(
                    {"dp": 1, "pp": 4}, devices=jax.devices()[:N]),
                n_micro=2, pp_axis="pp", dp_axis="dp")),
            "gpt": ref_gpt,
        }
        port = {"micro": {m: world.collect(f"micro {m}") for m in (1, 2, 4)},
                "dp_pp": world.collect("dp_pp"),
                "grads": world.collect("grads"),
                "grads_remat": world.collect("grads remat"),
                "planner": world.collect("planner"),
                "errors": world.collect("errors"),
                "gpt": world.collect("gpt")}
    finally:
        world.close()
    return port, ref


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_matches_serial(runs, n_micro):
    port, ref = runs
    want, serial = ref["micro"][n_micro]
    np.testing.assert_allclose(want, serial, rtol=1e-5, atol=1e-5)
    for out in port["micro"][n_micro]:
        np.testing.assert_allclose(out["out"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["out"], serial, rtol=1e-5, atol=1e-5)


def test_dp_pp_mesh(runs):
    """``{dp: 2, pp: 2}``: each rank's rows are its dp shard's rows of the
    reference's output, the same on both pp ranks."""
    port, ref = runs
    mesh = make_mesh({"dp": 2, "pp": 2}, world=N)
    for r, out in enumerate(port["dp_pp"]):
        dp = mesh.coords(r)["dp"]
        np.testing.assert_allclose(out["out"], ref["dp_pp"][dp * 4:dp * 4 + 4],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["grads", "grads_remat"])
def test_grads_match_serial(runs, kind):
    """Each rank's stage gradient is the reference's row for that stage
    (1×, not pp×: the output's sum over pp has the identity backward),
    and every rank holds the input's whole gradient."""
    port, ref = runs
    g_ref, dx_ref = ref["grads"]
    for r, out in enumerate(port[kind]):
        for key in ("w1", "b1", "w2"):
            np.testing.assert_allclose(out["grads"][key], g_ref[key][r],
                                       rtol=1e-4, atol=1e-4, err_msg=key)
        np.testing.assert_allclose(out["dx"], dx_ref, rtol=1e-4, atol=1e-4)


def test_pipeline_planner_axes_match_legacy(runs):
    port, ref = runs
    for out in port["planner"]:
        np.testing.assert_array_equal(out["legacy"], out["planned"])
        np.testing.assert_allclose(out["legacy"], ref["planner"], rtol=1e-5,
                                   atol=1e-5)


def test_matches_nonpipelined(runs):
    """Same weights: the port's pipelined logits against the reference's
    pipelined and plain GPT's, rank by rank (its dp rows)."""
    port, ref = runs
    g = ref["gpt"]
    np.testing.assert_allclose(g["logits"], g["plain_logits"], rtol=2e-4,
                               atol=2e-4)
    mesh = make_mesh(GPT_LAYOUT, world=N)
    for r, out in enumerate(port["gpt"]):
        dp = mesh.coords(r)["dp"]
        rows = slice(dp * 4, dp * 4 + 4)
        np.testing.assert_allclose(out["logits"], g["logits"][rows],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out["logits"], g["plain_logits"][rows],
                                   rtol=2e-4, atol=2e-4)


def test_grads_match_the_reference(runs):
    """One forward and backward: the global loss on every rank, and each
    stage's gradients (summed over dp) the reference's pipelined and
    non-pipelined gradients of those blocks; the embedding's and head's
    whole on every rank."""
    port, ref = runs
    g = ref["gpt"]
    grads = _flat(g["grads"])
    plain = _flat(g["plain_grads"])
    bps = CFG["n_layer"] // GPT_LAYOUT["pp"]
    summed = {}
    for out in port["gpt"]:
        loss, local = out["remat"][0]
        np.testing.assert_allclose(loss, g["loss"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(loss, g["plain_loss"], rtol=0, atol=1e-5)
        for name, value in local.items():
            key = (out["stage"], name)
            summed[key] = summed.get(key, 0) + value
    for (stage, name), value in summed.items():
        want = _stage_leaf(grads, name, stage)
        tol = 1e-5 + 1e-4 * float(np.abs(want).max())
        np.testing.assert_allclose(value, want, rtol=0, atol=tol,
                                   err_msg=name)
        if name.startswith("stages."):
            _, block, rest = name.split(".", 2)
            i = stage * bps + int(block.split("_")[1])
            want = plain[f"block_{i}.{rest}"]
        else:
            want = plain[name.split(".", 1)[1]]
        np.testing.assert_allclose(value, want, rtol=0, atol=tol,
                                   err_msg=name)


def test_dp_pp_training_matches_the_reference(runs):
    port, ref = runs
    g = ref["gpt"]
    final = _flat(g["final"])
    lr = 3e-4
    diffs = []
    for out in port["gpt"]:
        np.testing.assert_allclose(out["losses"], g["losses"], rtol=0,
                                   atol=1e-5)
        for name, value in out["params"].items():
            diffs.append(np.abs(value - _stage_leaf(final, name,
                                                    out["stage"])).ravel())
    diffs = np.concatenate(diffs)
    assert np.mean(diffs > 2e-6) <= 1e-3, np.mean(diffs > 2e-6)
    assert diffs.max() <= lr, diffs.max()
    assert g["losses"][-1] < g["losses"][0]
    # The leaves outside the pipeline are the same bits on both pp ranks
    # of a dp group, and across dp too (the gradients are summed over dp).
    outs = port["gpt"]
    for name in outs[0]["params"]:
        if not name.startswith("stages."):
            for o in outs[1:]:
                np.testing.assert_array_equal(o["params"][name],
                                              outs[0]["params"][name],
                                              err_msg=name)
        else:
            for o in outs:
                if o["stage"] == outs[0]["stage"]:
                    np.testing.assert_array_equal(o["params"][name],
                                                  outs[0]["params"][name])


def test_remat_matches_non_remat(runs):
    port, _ = runs
    for out in port["gpt"]:
        (loss, grads), (loss_r, grads_r) = out["remat"]
        np.testing.assert_allclose(loss_r, loss, rtol=1e-6)
        for name in grads:
            np.testing.assert_allclose(grads_r[name], grads[name], rtol=1e-5,
                                       atol=1e-7, err_msg=name)


def test_layer_stage_mismatch_and_bad_split(runs):
    port, _ = runs
    for out in port["errors"]:
        assert "n_layer" in out["layers"]
        assert "divisible" in out["micro"]


def test_bad_microbatch_split():
    mesh = make_mesh({"pp": 4}, world=N)
    with pytest.raises(ValueError, match="divisible"):
        pipeline_apply(workers._toy_stage, None, torch.ones(6, 8),
                       mesh=mesh, n_micro=4)


def test_missing_axis():
    mesh = make_mesh({"dp": 8}, world=8)
    with pytest.raises(ValueError, match="no axis"):
        pipeline_apply(workers._toy_stage, None, torch.ones(4, 8), mesh=mesh,
                       n_micro=2)


def test_layer_stage_mismatch_rejected():
    cfg = GPTConfig(**{**CFG, "n_layer": 6}, dtype=torch.float32)
    with pytest.raises(ValueError, match="n_layer"):
        PipelinedGPT(cfg, make_mesh({"pp": 4}, world=N), device="cpu")
    with pytest.raises(ValueError, match="attention"):
        PipelinedGPT(GPTConfig(**{**CFG, "attention": "ring"}),
                     make_mesh({"pp": 4}, world=N), device="cpu")


def test_pipelined_gpt_takes_dp_axis():
    """F7: ``PipelinedGPT(dp_axis=)`` and ``pipeline_apply(dp_axis=)``, as
    the reference's take them.  On a world of one over ``{'dp': 1, 'pp':
    1}`` the pipelined model with ``dp_axis='dp'`` resolves the axes as
    :func:`pipeline_axes` does and gives ``GPT``'s logits from the same
    seed (one stage, one microbatch path), within 1e-5."""
    from horovod_tpu_torch import init, shutdown
    from horovod_tpu_torch.models import GPT

    cfg = GPTConfig(**CFG, dtype=torch.float32)
    init(device="cpu")
    try:
        mesh = make_mesh({"dp": 1, "pp": 1})
        model = PipelinedGPT(cfg, mesh, dp_axis="dp", n_micro=2,
                             device="cpu", seed=3)
        assert (model.pp_axis, model.dp_axis) == ("pp", "dp")
        tokens = torch.from_numpy(np.random.RandomState(0).randint(
            0, CFG["vocab_size"], (2, 8)))
        want = GPT(cfg, device="cpu", seed=3)(tokens)
        np.testing.assert_allclose(model(tokens).detach().numpy(),
                                   want.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        x = torch.arange(32.0).reshape(4, 8)
        out = pipeline_apply(lambda _, h: 2 * h, None, x, mesh=mesh,
                             n_micro=2, dp_axis="dp")
        np.testing.assert_array_equal(out.numpy(), 2 * x.numpy())
    finally:
        shutdown()


def test_stack_and_placement():
    """``stack_stage_params`` stacks leaf by leaf (the reference's
    ``jnp.stack``), and every stacked leaf is placed ``P(pp)``."""
    _, per_stage = _make_stages(4, d=3)
    per = [{k: torch.from_numpy(np.array(v)) for k, v in s.items()}
           for s in per_stage]
    stacked = stack_stage_params(per)
    ref = _np(_make_stages(4, d=3)[0])
    for k in ("w1", "b1", "w2"):
        np.testing.assert_array_equal(stacked[k].numpy(), ref[k])
    specs = stage_param_shardings(make_mesh({"pp": 4}, world=N))(stacked)
    assert specs == {k: P("pp") for k in stacked}


@pytest.mark.parametrize("spec,dp_axis,want", [
    ("dp=2,pp=2", "dp", ("pp", "dp")),
    ("data=2,pipe=2", "dp", ("pipe", "data")),
    ("data=2,pipe=2", None, ("pipe", "data")),
    ("data=1,fsdp=2,pipe=2", "dp", ("pipe", ("data", "fsdp"))),
    ("pp=4", "dp", ("pp", None)),
])
def test_axis_resolution(spec, dp_axis, want):
    """The reference's resolution (``pipeline.py:61-76``): ``pipe`` when
    declared, else ``pp``; ``dp`` when declared, else the plan's reduce
    axes without the pipeline's."""
    plan = MeshPlan.from_spec(spec, world=4)
    assert pipeline_axes(plan, dp_axis=dp_axis) == want
