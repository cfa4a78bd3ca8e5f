"""The port's ``make_spmd_train_step`` (``horovod_tpu_torch/parallel``)
against the reference's, mirroring ``examples/gpt_long_context.py``: a
small GPT (2 layers, d_model 64, 4 heads, seq 64, f32) trained 3 AdamW
steps on four layouts of a 4-rank world, ``{'sp': 4}``, ``{'dp': 2,
'sp': 2}``, ``{'sp': 2, 'tp': 2}`` (ring attention; the last on the
flash engine, and once with Ulysses) and ``{'dp': 2, 'tp': 2}`` (full
attention), and ``{'dp': 2, 'sp': 2}`` once more with two microbatches
(and an aux output) against the reference's two. The reference runs its
own step on the same layout over the first four CPU devices, from the
same flax weights and tokens (compiled at backend optimization level 0,
ROADMAP R1); the port's gloo world is spawned once for the module
(``tests/torch_port_workers.py``) and runs while the reference compiles.

Tolerances (those of ``test_torch_port_train.py``'s GPT steps, but for
the largest difference): the losses within 1e-5; at most 0.1% of the
gathered parameters more than 2e-6 from the reference's, and none more
than one step's lr, 3e-4. Adam's first steps move almost every element
by ~lr whatever the rounding; an element whose gradient is near Adam's
eps moves by a rounding-dependent fraction of lr instead (here one
``lm_head`` element of 8192, by up to ~1e-4 over the three steps).
Within the port the losses and every gathered parameter agree bit for
bit on all ranks, every replicated leaf's local copy too, and each
rank's slices are its part of the gathered whole (``qkv`` by heads).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from horovod_tpu.models.transformer import GPT as JaxGPT
from horovod_tpu.models.transformer import GPTConfig as JaxGPTConfig
from horovod_tpu.models.transformer import lm_loss_fn as jax_lm_loss_fn
from horovod_tpu.parallel import init_opt_state as jax_init_opt_state
from horovod_tpu.parallel import make_mesh as jax_make_mesh
from horovod_tpu.parallel import make_spmd_train_step as jax_spmd_step
from horovod_tpu.parallel import param_shardings as jax_param_shardings
from horovod_tpu.parallel import shard_batch as jax_shard_batch
from horovod_tpu.parallel import shard_params as jax_shard_params

from horovod_tpu_torch.parallel import make_mesh, param_shardings
from horovod_tpu_torch.parallel.sharding import _local_slice

import torch_port_workers as workers

N = 4
CFG = dict(vocab_size=128, n_layer=2, n_head=4, d_model=64, d_ff=128,
           max_seq_len=64)
B, T, STEPS = 4, 64, 3
RUNS = {
    "sp4": ({"sp": 4}, "ring", "xla"),
    "dp2_sp2": ({"dp": 2, "sp": 2}, "ring", "xla"),
    "sp2_tp2_flash": ({"sp": 2, "tp": 2}, "ring", "flash"),
    "sp2_tp2_ulysses": ({"sp": 2, "tp": 2}, "ulysses", "xla"),
    "dp2_tp2": ({"dp": 2, "tp": 2}, "full", "xla"),
    "dp2_sp2_mb2": ({"dp": 2, "sp": 2}, "ring", "xla", 2),
}


def _start():
    """(the flax params as numpy, the global batch's tokens)."""
    tokens = np.random.RandomState(7).randint(
        0, CFG["vocab_size"], (B, T + 1)).astype(np.int32)
    model = JaxGPT(JaxGPTConfig(**CFG, dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(3),
                        jnp.asarray(tokens[:1, :-1]))["params"]
    return jax.tree.map(np.asarray, params), tokens


def _reference(layout, attention, engine, params, tokens, microbatches=1):
    mesh = jax_make_mesh(layout, devices=jax.devices()[:N])
    model = JaxGPT(JaxGPTConfig(**CFG, attention=attention,
                                attention_engine=engine, dtype=jnp.float32),
                   mesh=mesh)
    p = jax_shard_params(jax.tree.map(jnp.asarray, params), mesh)
    tx = optax.adamw(3e-4, weight_decay=1e-4)
    s = jax_init_opt_state(tx, p)
    data = jax_shard_batch((jnp.asarray(tokens[:, :-1]),
                            jnp.asarray(tokens[:, 1:])), mesh,
                           JP("dp", "sp"))
    step = jax_spmd_step(jax_lm_loss_fn(model), tx, donate=False,
                         microbatches=microbatches)
    step = getattr(step, "__wrapped__", step).lower(p, s, data).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    shardings = step.input_shardings[0][:2]
    losses = []
    for _ in range(STEPS):
        p, s = jax.device_put((p, s), shardings)
        p, s, loss = step(p, s, data)
        losses.append(float(loss))
    final = {".".join(str(k.key) for k in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_leaves_with_path(p)}
    return losses, final


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every layout's port run (submitted first, so the world trains
    while the reference compiles) and reference run."""
    params, tokens = _start()
    world = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    try:
        for name, (layout, attention, engine, *mb) in RUNS.items():
            world.submit("spmd_gpt", config={
                **CFG, "attention": attention, "attention_engine": engine,
                "dtype": "float32"}, layout=layout, params=params,
                tokens=tokens, steps=STEPS, microbatches=mb[0] if mb else None)
        world.submit("spmd_gpt", config={
            **CFG, "attention": "ring", "dtype": "float32"},
            layout=RUNS["dp2_sp2"][0], params=params, tokens=tokens,
            steps=1, local=True)
        ref = {name: _reference(*spec[:3], params, tokens, *spec[3:])
               for name, spec in RUNS.items()}
        port = {name: world.collect(name, timeout=120) for name in RUNS}
        port["local"] = world.collect("local", timeout=120)
    finally:
        world.close()
    return port, ref


@pytest.mark.parametrize("name", list(RUNS))
def test_spmd_steps_match_the_reference(runs, name):
    port, ref = runs
    out, (ref_losses, ref_params) = port[name], ref[name]
    layout = RUNS[name][0]
    for o in out[1:]:
        assert o["losses"] == out[0]["losses"]
        for leaf, value in out[0]["full"].items():
            np.testing.assert_array_equal(o["full"][leaf], value,
                                          err_msg=leaf)
    # A leaf the rule table leaves whole is the same bits on every rank,
    # and every rank's slice is its part of the gathered leaf.
    mesh = make_mesh(layout, world=N)
    specs = param_shardings(out[0]["local"], mesh)
    for leaf, spec in specs.items():
        for r, o in enumerate(out):
            if not any(spec):
                np.testing.assert_array_equal(o["local"][leaf],
                                              out[0]["local"][leaf])
            want = _local_slice(leaf, torch.from_numpy(out[0]["full"][leaf]),
                                spec, mesh, mesh.coords(r))
            np.testing.assert_array_equal(o["local"][leaf], want.numpy())
    losses = np.asarray(out[0]["losses"])
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-5)
    assert set(out[0]["full"]) == set(ref_params)
    diffs = np.concatenate([
        np.abs(out[0]["full"][n] - ref_params[n]).ravel()
        for n in ref_params])
    assert np.mean(diffs > 2e-6) <= 1e-3, np.mean(diffs > 2e-6)
    assert diffs.max() <= 3e-4, diffs.max()
    assert losses[-1] < losses[0]


def test_microbatches_and_aux(runs):
    """``microbatches=2`` with ``has_aux``: the aux comes back stacked,
    one local token count a microbatch (B / dp / 2 rows of T / sp)."""
    port, _ = runs
    for o in port["dp2_sp2_mb2"]:
        assert o["aux"] == [[T // 2, T // 2]] * STEPS


def test_shard_batch_local_rows(runs):
    """``shard_batch(local=True)`` from each rank's own dp rows gives the
    step the same slices as the global batch: step 1 bit for bit."""
    port, _ = runs
    for a, b in zip(port["local"], port["dp2_sp2"]):
        assert a["losses"] == b["losses"][:1]


@pytest.mark.parametrize("layout", [{"dp": 2, "sp": 2, "tp": 2},
                                    {"tp": 8}, {"dp": 8}, {"sp": 4, "dp": 2}])
def test_param_shardings_match_the_reference(layout):
    """The rule table's spec of every GPT leaf, entry for entry."""
    params, _ = _start()
    ref = jax_param_shardings(params, jax_make_mesh(layout))
    ref = {".".join(str(k.key) for k in path): tuple(s.spec)
           for path, s in jax.tree_util.tree_leaves_with_path(ref)}
    flat = {".".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    got = param_shardings(flat, make_mesh(layout, world=8))
    assert {n: tuple(s) for n, s in got.items()} == ref
