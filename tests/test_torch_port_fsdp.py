"""The port's FSDP / HSDP (``horovod_tpu_torch/optim/fsdp.py``) and ZeRO
on a plan's reduce group (``optim/zero.py``) against the reference's,
mirroring ``tests/test_fsdp.py`` in full and ``tests/test_mesh_plan.py``'s
``test_fsdp_step`` and ``test_zero_step``.

The reference runs in this process over the 8 CPU devices; the port in
one 4-rank gloo world (``tests/torch_port_workers.py``), each rank on its
rows of the same global batch (so both compute the same global mean).
The toy problem is ``tests/test_fsdp.py``'s at four ranks (d = 16, 32
rows), made from a numpy seed.

The block-wise step (a unit gathered around its forward and again for
its backward) runs on a 4-layer GPT (d_model 32, full attention) from
the reference's flax weights, dense and chunked heads, HSDP and
clipping, against the reference's ``make_fsdp_train_step``, and on a toy
of two blocks with a tied embedding and head and a bias the two blocks
share; each rank's ``peak_gathered_bytes`` is held to the root unit's
bytes plus twice the largest block's and below half the whole model's,
and every rank's recorded collectives are the same: the root gathered
once, every block twice (forward, backward).

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
from horovod_tpu.models.transformer import GPT as JaxGPT
from horovod_tpu.models.transformer import GPTConfig as JaxGPTConfig
from horovod_tpu.models.transformer import lm_loss_fn as jax_lm_loss_fn
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
GPT_CFG = dict(vocab_size=64, n_layer=4, n_head=4, d_model=32, d_ff=64,
               max_seq_len=16, attention="full")
GPT_STEPS = 3
# Clipping under SGD(0.1): Adam divides out the clip's scale, and with
# the gradients scaled down its epsilon turns f32 rounding into
# parameter differences.
GPT_CASES = {"dense": {}, "chunked": dict(chunk=16),
             "hsdp": dict(kind="hsdp"),
             "clip": dict(max_grad_norm=0.1, sgd=True)}


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


def _ref_gpt(tokens):
    """The reference's GPT: its flax params and, for each of GPT_CASES,
    GPT_STEPS AdamW(1e-2) (or SGD(0.1)) steps of its
    ``make_fsdp_train_step`` on the whole batch (HSDP's numbers are
    FSDP's)."""
    model = JaxGPT(JaxGPTConfig(**GPT_CFG, dtype=jnp.float32))
    batch = (jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:]))
    params = model.init(jax.random.PRNGKey(0), batch[0])["params"]
    out = {"params": _np(params)}
    for name, case in GPT_CASES.items():
        tx = optax.sgd(0.1) if case.get("sgd") else optax.adamw(1e-2)
        if "max_grad_norm" in case:
            tx = optax.chain(optax.clip_by_global_norm(case["max_grad_norm"]),
                             tx)
        shard, step = jax_fsdp_step(
            jax_lm_loss_fn(model, vocab_chunk_size=case.get("chunk", 0)), tx,
            donate=False)
        p, state = shard(params)
        out[name] = _ref_steps((step, state), p, batch, GPT_STEPS)
    return out


def _tied_leaves():
    rng = np.random.RandomState(5)
    leaves = {"emb.weight": rng.randn(16, 8), "block_0.lin.weight":
              rng.randn(8, 8) * 0.3, "block_0.lin.bias": rng.randn(8) * 0.1,
              "block_0.scale": 1 + rng.randn(8) * 0.1,
              "block_1.lin.weight": rng.randn(8, 8) * 0.3,
              "block_1.scale": 1 + rng.randn(8) * 0.1}
    tokens = rng.randint(0, 16, (8, 6))
    targets = rng.randint(0, 16, (8, 6))
    return ({k: v.astype(np.float32) for k, v in leaves.items()},
            tokens.astype(np.int32), targets.astype(np.int32))


def _ref_tied(leaves, tokens, targets):
    """``workers._TiedBlocks`` in jnp (one embedding for the input and the
    head, one bias for both blocks) through the reference's
    ``make_fsdp_train_step`` with Adam(1e-2)."""
    def loss_fn(p, batch):
        tok, tgt = batch
        h = p["emb.weight"][tok]
        for i in range(2):
            lin = h @ p[f"block_{i}.lin.weight"].T + p["block_0.lin.bias"]
            h = h + jnp.tanh(lin) * p[f"block_{i}.scale"]
        logp = jax.nn.log_softmax(h @ p["emb.weight"].T, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None],
                                             axis=-1))

    shard, step = jax_fsdp_step(loss_fn, optax.adam(1e-2), donate=False)
    p, state = shard({k: jnp.asarray(v) for k, v in leaves.items()})
    return _ref_steps((step, state), p, (jnp.asarray(tokens),
                                         jnp.asarray(targets)), STEPS)


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
        tokens = np.random.RandomState(3).randint(0, 64, (8, 17)).astype(
            np.int32)
        gpt = _ref_gpt(tokens)
        for case in GPT_CASES.values():
            world.submit("fsdp_gpt", config={**GPT_CFG, "dtype": "float32"},
                         params=gpt["params"], tokens=tokens,
                         steps=GPT_STEPS, **case)
        tied = _tied_leaves()
        world.submit("fsdp_tied_blocks", leaves=tied[0], tokens=tied[1],
                     targets=tied[2], steps=STEPS)
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
        ref.update({f"gpt_{name}": gpt[name] for name in GPT_CASES},
                   tied=_ref_tied(*tied))
        port = {name: world.collect(name) for name in cases}
        port["zero"] = world.collect("zero")
        for name in GPT_CASES:
            port[f"gpt_{name}"] = world.collect(f"gpt {name}")
        port["tied"] = world.collect("tied")
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


BLOCKS = [f"block_{i}" for i in range(GPT_CFG["n_layer"])]


@pytest.mark.parametrize("case", list(GPT_CASES))
def test_gpt_block_units_match_the_reference(runs, case):
    """The block-wise step on GPT against the reference's
    ``make_fsdp_train_step``: the dense and chunked heads, HSDP
    (``{dcn: 2, ici: 2}``) and clipping by the global norm."""
    port, ref = runs
    want = ref["gpt_dense" if case == "hsdp" else f"gpt_{case}"]
    for out in port[f"gpt_{case}"]:
        _close(out, want)


def test_gpt_units(runs):
    """Each block is a unit; the embeddings, ``ln_f`` and ``lm_head``
    (which the chunked head reads without running it) are the root."""
    port, _ = runs
    for case in GPT_CASES:
        for out in port[f"gpt_{case}"]:
            assert out["root"] == ["embed.embedding", "lm_head.kernel",
                                   "ln_f.bias", "ln_f.scale", "pos_embed"]
            assert [b for b, _ in out["blocks"]] == BLOCKS
            for block, names in out["blocks"]:
                assert names and all(n.startswith(block + ".")
                                     for n in names)


def _unit_bytes(out):
    """(root bytes, each block's bytes, the whole model's bytes)."""
    size = {n: v.nbytes for n, v in out["params"].items()}
    blocks = [sum(size[n] for n in names) for _, names in out["blocks"]]
    return sum(size[n] for n in out["root"]), blocks, sum(size.values())


@pytest.mark.parametrize("case", list(GPT_CASES))
def test_peak_gathered_bytes(runs, case):
    """At most the root unit plus twice the largest block, and below
    half the whole model, on every rank and step."""
    port, _ = runs
    for out in port[f"gpt_{case}"]:
        root, blocks, whole = _unit_bytes(out)
        for peak in out["peaks"]:
            assert root + max(blocks) <= peak <= root + 2 * max(blocks)
            assert peak < whole / 2, (peak, whole)


@pytest.mark.parametrize("case", list(GPT_CASES) + ["tied"])
def test_collective_sequence(runs, case):
    """Every rank records the same collectives in a step, and the
    whole parameters are gathered once for the root and twice for each
    block (its forward, then its backward), each split leaf one
    all-gather."""
    port, _ = runs
    outs = port[case if case == "tied" else f"gpt_{case}"]
    for out in outs[1:]:
        assert out["seq"] == outs[0]["seq"]
    out = outs[0]
    split = {n for n, dim in out["split"].items() if dim is not None}
    in_blocks = [n for _, names in out["blocks"] for n in names]
    gathers = sum(1 for e in out["seq"] if e[0] == "all_gather_into_tensor")
    assert gathers == (len(split & set(out["root"]))
                       + 2 * len(split & set(in_blocks)))


def test_tied_and_shared_leaves_in_the_root(runs):
    """F8 through the block path: the embedding tied to the head and the
    bias both blocks share are root leaves, the blocks keep the rest; the
    steps match the reference's ``make_fsdp_train_step``."""
    port, ref = runs
    for out in port["tied"]:
        assert out["root"] == ["block_0.lin.bias", "emb.weight"]
        assert out["blocks"] == [
            ["block_0", ["block_0.lin.weight", "block_0.scale"]],
            ["block_1", ["block_1.lin.weight", "block_1.scale"]]]
        _close(out, ref["tied"])


def test_step_frees_the_model(runs):
    """Nothing of a step (a whole leaf's hook, a unit) keeps the model
    alive once the caller drops it: with the collector off, the last
    reference going frees it."""
    port, _ = runs
    for case in GPT_CASES:
        assert all(out["model_freed"] for out in port[f"gpt_{case}"]), case
