"""The port's mixture of experts (``horovod_tpu_torch/parallel/moe.py``,
GPT's ``moe_*`` fields) against the reference's, mirroring
``tests/test_moe.py`` and ``tests/test_mesh_plan.py::
test_moe_planner_axes_match_legacy``.

The layer cases run in this process against flax's ``MoEMlp`` on the
same numpy-seeded weights and inputs: output and aux loss within 1e-6
(f32; 2e-2 of the output's scale in bf16, one bf16 step), the gradients
of ``sum(out²) + aux`` within 1e-5 + 1e-4 of each one's largest value.

The GPT cases run in one 4-rank gloo world (``tests/
torch_port_workers.py``) at ``{dp: 2, ep: 2}`` and ``{ep: 2, tp: 2}``
(2 layers, d_model 32, 4 experts, top-2, capacity factor 0.5 so that
tokens overflow), against the reference's MoE GPT run on the whole
batch on one device: each rank's logits within 1e-4 of its rows of the
reference's, the aux loss within 1e-6 relative, the loss within 1e-5,
and one AdamW step's gathered parameters at most 0.1% more than 2e-6
from the reference's and none more than lr (the contract of
``test_torch_port_spmd.py``), with ``lm_loss_fn`` alone and with the aux
loss added.  Routing is global, so the dp shards keep and drop the
tokens the whole batch does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models.transformer import GPT as JaxGPT
from horovod_tpu.models.transformer import GPTConfig as JaxGPTConfig
from horovod_tpu.parallel import make_mesh as jax_make_mesh
from horovod_tpu.parallel.moe import MoEMlp as JaxMoEMlp
from horovod_tpu.parallel.moe import moe_aux_loss as jax_moe_aux_loss
from horovod_tpu.parallel.sharding import (
    param_shardings as jax_param_shardings)

from horovod_tpu_torch.models import GPT, GPTConfig
from horovod_tpu_torch.models.layers import Init
from horovod_tpu_torch.parallel import (MoEMlp, make_mesh, moe_aux_loss,
                                        param_shardings)
from horovod_tpu_torch.plan import P

import torch_port_workers as workers

N = 4
CFG = dict(vocab_size=64, n_layer=2, n_head=4, d_model=32, d_ff=64,
           max_seq_len=16, attention="full", moe_experts=4, moe_top_k=2,
           moe_every=2, moe_capacity_factor=0.5)
LAYOUTS = {"dp2_ep2": {"dp": 2, "ep": 2}, "ep2_tp2": {"ep": 2, "tp": 2}}
AUX_WEIGHT = 1e-2
LR = 3e-4


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


def _layer(E, K, cf, dtype, d_model=16, d_ff=32, seed=1):
    """The flax layer, its numpy params and the port's layer with them."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    layer = JaxMoEMlp(d_model=d_model, d_ff=d_ff, n_experts=E, top_k=K,
                      capacity_factor=cf, dtype=jdt)
    x = np.random.RandomState(0).randn(2, 16, d_model).astype(np.float32)
    variables = layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = _np(variables["params"])
    port = MoEMlp(d_model, d_ff, E, init=Init(torch.float32, "cpu", 0),
                  top_k=K, capacity_factor=cf, dtype=getattr(torch, dtype))
    _load_layer(port, params)
    return layer, variables, params, port, x


def _load_layer(port, params):
    with torch.no_grad():
        port.router.kernel.copy_(torch.from_numpy(params["router"]["kernel"]))
        port.w_up.copy_(torch.from_numpy(params["w_up"]))
        port.w_down.copy_(torch.from_numpy(params["w_down"]))


def _ref_layer(layer, variables, x):
    def f(v, xs):
        out, inter = layer.apply(v, xs, mutable=["intermediates"])
        aux = jax_moe_aux_loss(inter, weight=1.0)
        return jnp.sum(out.astype(jnp.float32) ** 2) + aux, (out, aux)

    (_, (out, aux)), (gv, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables, jnp.asarray(x))
    return (np.asarray(out, np.float32), float(aux),
            _np(gv["params"]), np.asarray(gx, np.float32))


@pytest.mark.parametrize("E,K,cf,dtype", [
    (4, 2, 1.25, "float32"), (4, 2, 0.5, "float32"), (2, 1, 0.1, "float32"),
    (1, 1, 2.0, "float32"), (4, 2, 0.5, "bfloat16")])
def test_layer_matches_the_reference(E, K, cf, dtype):
    layer, variables, params, port, x = _layer(E, K, cf, dtype)
    out_ref, aux_ref, g_ref, gx_ref = _ref_layer(layer, variables, x)
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt)
    aux = moe_aux_loss(port, weight=1.0)
    ((out.to(torch.float32) ** 2).sum() + aux).backward()
    got = out.detach().to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, out_ref, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, out_ref, rtol=0,
                                   atol=2e-2 * np.abs(out_ref).max())
    np.testing.assert_allclose(float(aux), aux_ref, rtol=1e-6)
    if dtype != "float32":
        return
    grads = {"router.kernel": port.router.kernel.grad, "w_up": port.w_up.grad,
             "w_down": port.w_down.grad}
    for name, g in grads.items():
        want = _flat(g_ref)[name]
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(want).max(),
                                   err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), gx_ref, rtol=0,
                               atol=1e-5 + 1e-4 * np.abs(gx_ref).max())


def test_shapes_and_finite():
    _, _, _, port, x = _layer(4, 2, 1.25, "float32")
    out = port(torch.from_numpy(x))
    assert out.shape == x.shape and bool(out.isfinite().all())
    aux = moe_aux_loss(port)
    assert np.isfinite(float(aux)) and float(aux) > 0


def test_single_expert_equals_dense():
    """One expert, top-1, ample capacity: every token goes to it with
    weight 1, so the layer is the plain FFN with its weights."""
    _, _, params, port, x = _layer(1, 1, 2.0, "float32", d_model=8, d_ff=16)
    xt = torch.from_numpy(x[..., :8].copy())
    out = port(xt)
    up, down = (torch.from_numpy(params[k][0]) for k in ("w_up", "w_down"))
    ref = torch.nn.functional.gelu(xt @ up, approximate="tanh") @ down
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_routing_weights_normalized():
    """With capacity for every route and four identical experts, the
    output is the one FFN's times the sum of a token's route weights:
    the FFN itself when the top-k gates are normalised."""
    _, _, params, port, x = _layer(4, 2, 4.0, "float32")
    with torch.no_grad():
        port.w_up.copy_(port.w_up[:1].expand_as(port.w_up))
        port.w_down.copy_(port.w_down[:1].expand_as(port.w_down))
    xt = torch.from_numpy(x)
    out = port(xt)
    ref = torch.nn.functional.gelu(xt @ port.w_up[0],
                                   approximate="tanh") @ port.w_down[0]
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-6)


def test_capacity_drops_overflow():
    """A tiny capacity drops most routes without NaNs: a dropped token's
    output row is zero, as the reference's."""
    layer, variables, _, port, x = _layer(2, 1, 0.1, "float32")
    out = port(torch.from_numpy(x)).detach().numpy()
    ref = np.asarray(layer.apply(variables, jnp.asarray(x)))
    assert np.isfinite(out).all()
    dropped = np.all(ref == 0, axis=-1)
    assert dropped.mean() > 0.5
    np.testing.assert_array_equal(np.all(out == 0, axis=-1), dropped)


def test_moe_blocks_present():
    model = GPT(GPTConfig(**{**CFG, "moe_capacity_factor": 1.25},
                          dtype=torch.float32), device="cpu")
    names = dict(model.named_parameters())
    assert "block_1.moe.w_up" in names and "block_0.mlp.up.kernel" in names
    assert not any(n.startswith("block_0.moe") for n in names)
    assert tuple(names["block_1.moe.w_up"].shape) == (4, 32, 64)
    assert tuple(names["block_1.moe.router.kernel"].shape) == (32, 4)


def test_param_shardings_match_the_reference():
    """The rule table's spec of every MoE GPT leaf, entry for entry: the
    experts over ``ep``, their FFN over ``tp``, the router whole."""
    model = JaxGPT(JaxGPTConfig(**CFG, dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((2, 16), jnp.int32))["params"]
    layout = {"dp": 2, "ep": 2, "tp": 2}
    ref = jax_param_shardings(params, jax_make_mesh(layout))
    ref = {".".join(str(k.key) for k in path): tuple(s.spec)
           for path, s in jax.tree_util.tree_leaves_with_path(ref)}
    flat = _flat(_np(params))
    got = param_shardings(flat, make_mesh(layout, world=8))
    assert {n: tuple(s) for n, s in got.items()} == ref
    assert got["block_1.moe.w_up"] == P("ep", None, "tp")
    assert got["block_1.moe.w_down"] == P("ep", "tp", None)


def _ref_gpt(tokens):
    """The reference's MoE GPT on the whole batch, one device: params,
    logits, aux loss, and one AdamW step with and without the aux loss
    (its loss and the updated params)."""
    model = JaxGPT(JaxGPTConfig(**CFG, dtype=jnp.float32))
    inputs, targets = jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:])
    params = model.init(jax.random.PRNGKey(0), inputs)["params"]
    logits, inter = model.apply({"params": params}, inputs,
                                mutable=["intermediates"])
    out = {"params": _np(params), "logits": np.asarray(logits),
           "aux": float(jax_moe_aux_loss(inter, weight=1.0))}

    def loss_fn(p, weight):
        lg, it = model.apply({"params": p}, inputs, mutable=["intermediates"])
        logp = jax.nn.log_softmax(lg.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
        return jnp.mean(nll) + jax_moe_aux_loss(it, weight=weight)

    tx = optax.adamw(LR, weight_decay=1e-4)
    for key, weight in (("lm", 0.0), ("lm_aux", AUX_WEIGHT)):
        loss, grads = jax.value_and_grad(loss_fn)(params, weight)
        updates, _ = tx.update(grads, tx.init(params), params)
        out[key] = (float(loss), _flat(_np(optax.apply_updates(params,
                                                              updates))))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tokens = np.random.RandomState(0).randint(0, 64, (8, 17)).astype(np.int32)
    layer_cfg = dict(d_model=16, d_ff=32, n_experts=N, top_k=2)
    layer, variables, layer_params, _, x = _layer(N, 2, 1.25, "float32")
    world = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    try:
        world.submit("moe_planner", config=layer_cfg, params=layer_params,
                     x=x)
        ref = _ref_gpt(tokens)
        cfg = {**CFG, "dtype": "float32"}
        for name, layout in LAYOUTS.items():
            world.submit("moe_gpt", config=cfg, layout=layout,
                         params=ref["params"], tokens=tokens, steps=1)
        world.submit("moe_gpt", config=cfg, layout=LAYOUTS["dp2_ep2"],
                     params=ref["params"], tokens=tokens, steps=1,
                     aux_weight=AUX_WEIGHT)
        ref["planner"] = np.asarray(layer.apply(variables, jnp.asarray(x)))
        port = {"planner": world.collect("planner")}
        for name in LAYOUTS:
            port[name] = world.collect(name)
        port["aux_step"] = world.collect("aux step")
    finally:
        world.close()
    return port, ref


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_moe_gpt_matches_the_unsharded_reference(runs, name):
    port, ref = runs
    layout = LAYOUTS[name]
    mesh = make_mesh(layout, world=N)
    dp = layout.get("dp", 1)
    rows = ref["logits"].shape[0] // dp
    for r, out in enumerate(port[name]):
        index = mesh.coords(r).get("dp", 0)
        np.testing.assert_allclose(
            out["logits"], ref["logits"][index * rows:(index + 1) * rows],
            rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out["aux"], ref["aux"], rtol=1e-6)
    _check_step(port[name], ref["lm"], mesh)


def test_moe_gpt_with_the_aux_loss(runs):
    """A caller adds ``moe_aux_loss`` to its loss: the router's gradient
    takes the load-balancing term from every dp shard."""
    port, ref = runs
    _check_step(port["aux_step"], ref["lm_aux"],
                make_mesh(LAYOUTS["dp2_ep2"], world=N))


def _check_step(outs, ref_step, mesh):
    loss, final = ref_step
    for o in outs:
        np.testing.assert_allclose(o["losses"][0], loss, rtol=0, atol=1e-5)
        assert set(o["full"]) == set(final)
        for leaf, value in o["full"].items():
            np.testing.assert_array_equal(value, outs[0]["full"][leaf],
                                          err_msg=leaf)
    diffs = np.concatenate([np.abs(outs[0]["full"][n] - final[n]).ravel()
                            for n in final])
    assert np.mean(diffs > 2e-6) <= 1e-3, np.mean(diffs > 2e-6)
    assert diffs.max() <= LR, diffs.max()
    # Each rank holds its experts and, under tp, its FFN columns.
    for r, o in enumerate(outs):
        shape = o["local"]["block_1.moe.w_up"].shape
        assert shape == (4 // mesh.shape.get("ep", 1), 32,
                         64 // mesh.shape.get("tp", 1)), shape


def test_moe_planner_axes_match_legacy(runs):
    port, ref = runs
    for out in port["planner"]:
        np.testing.assert_array_equal(out["legacy"], out["planned"])
        np.testing.assert_allclose(out["legacy"], ref["planner"], rtol=1e-6,
                                   atol=1e-6)
        assert [tuple(s) for s in out["shapes"]] == [(1, 16, 32), (4, 16, 32)]
