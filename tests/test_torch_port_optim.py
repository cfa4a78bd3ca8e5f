"""The PyTorch port's DistributedOptimizer arguments of the collective
slice against JAX ``make_train_step``: three AdamW steps of a 2-layer
narrow GPT on 4 ranks with ``op=Adasum``, with ``process_set`` on the
int8 wire with error feedback, and with ``backward_passes_per_step=2``.

The port runs on a 4-rank gloo world spawned once for the module
(``tests/torch_port_workers.py``); the reference runs here on the first
four devices of the CPU mesh, each rank on its row of the global batch.
Tolerances are those of ``tests/test_torch_port_train.py``, whose
docstring gives the reasons.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import horovod_tpu as jhvd
from horovod_tpu.models.transformer import GPT as JaxGPT
from horovod_tpu.models.transformer import GPTConfig as JaxGPTConfig
from horovod_tpu.models.transformer import lm_loss_fn as jax_lm_loss_fn
from horovod_tpu.ops.compression import Compression as JaxCompression
from horovod_tpu.optim.distributed_optimizer import (
    DistributedOptimizer as JaxDistributedOptimizer,
    make_train_step as jax_make_train_step,
)

import horovod_tpu_torch as thvd
import torch_port_workers as workers

N = 4
CFG = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, d_ff=256,
           max_seq_len=128, attention="flash")
T, STEPS = 64, 3
PAIRS = [[0, 2], [1, 3]]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


def _start():
    """(flax model, its initial params, the global batch's tokens)."""
    model = JaxGPT(JaxGPTConfig(**CFG, dtype=jnp.float32))
    tokens = np.random.RandomState(11).randint(
        0, CFG["vocab_size"], (N, T + 1)).astype(np.int32)
    params = model.init(jax.random.PRNGKey(5),
                        jnp.asarray(tokens[:1, :-1]))["params"]
    return model, params, tokens


def _reference_set(ranks):
    """The reference's process set of ``ranks`` on a 4-slot axis.  The
    session's table spans all 8 CPU devices, so the set is attached to a
    4-wide axis directly instead of registered there: its
    ``axis_index_groups`` are then ``[ranks, the other two]``, and the
    step returns slot 0's set."""
    ps = jhvd.ProcessSet(ranks)
    ps._attach(1, N)
    return ps


def _jax_train(**kwargs):
    """STEPS reference steps; ``kwargs`` go to DistributedOptimizer, and
    ``op``/``process_set`` to make_train_step too."""
    model, params, tokens = _start()
    params0 = jax.tree.map(lambda a: np.array(a, copy=True), params)
    tx = JaxDistributedOptimizer(optax.adamw(3e-4), **kwargs)
    step = jax_make_train_step(
        jax_lm_loss_fn(model), tx, mesh=Mesh(np.array(jax.devices()[:N]),
                                             ("hvd",)),
        donate=False, op=kwargs.get("op", "average"),
        process_set=kwargs.get("process_set"))
    opt_state = tx.init(params)
    batch = (jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:]))
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    final = {".".join(str(k.key) for k in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    return params0, tokens, losses, final


def _port_train(world, params0, tokens, **kwargs):
    return world.run(
        "train_gpt", config={**CFG, "dtype": "float32"}, params=params0,
        tokens=tokens, steps=STEPS, **{"compression": "none",
                                       "error_feedback": False, **kwargs})


def _diffs(params, ref):
    assert set(params) == set(ref)
    return np.concatenate([np.abs(params[n] - ref[n]).ravel() for n in ref])


def _same_replicas(out, ranks):
    for r in ranks[1:]:
        assert out[r]["losses"] == out[ranks[0]]["losses"]
        for name, p in out[ranks[0]]["params"].items():
            np.testing.assert_array_equal(out[r]["params"][name], p)


def _exact_wire_within_tolerance(out, ref_losses, ref_params):
    diffs = _diffs(out["params"], ref_params)
    np.testing.assert_allclose(out["losses"], ref_losses, rtol=0, atol=1e-5)
    assert np.mean(diffs > 2e-6) <= 1e-3, np.mean(diffs > 2e-6)
    assert diffs.max() <= 1e-4, diffs.max()


def test_adasum_steps_match_jax(world):
    """op=Adasum: every gradient combined leaf by leaf over the 4 ranks'
    distance-doubling tree, on the exact wire."""
    params0, tokens, ref_losses, ref_params = _jax_train(op="adasum")
    out = _port_train(world, params0, tokens, op="adasum")
    _same_replicas(out, list(range(N)))
    _exact_wire_within_tolerance(out[0], ref_losses, ref_params)
    assert out[0]["losses"][-1] < out[0]["losses"][0]


def test_process_set_int8_ef_steps_match_jax(world):
    """process_set={0, 2} on the int8 wire with error feedback, while
    {1, 3} trains in a set of its own at the same time: the set's ranks
    track the reference's set (its wire blocks follow the set's 2
    members); the two sets saw different rows, so they differ."""
    params0, tokens, ref_losses, ref_params = _jax_train(
        compression=JaxCompression.int8, error_feedback=True,
        process_set=_reference_set([0, 2]))
    out = _port_train(world, params0, tokens, compression="int8",
                      error_feedback=True, sets=PAIRS)
    _same_replicas(out, [0, 2])
    _same_replicas(out, [1, 3])
    diffs = _diffs(out[0]["params"], ref_params)
    np.testing.assert_allclose(out[0]["losses"], ref_losses, rtol=0,
                               atol=1e-4)
    assert np.mean(diffs > 2e-6) <= 1e-3, np.mean(diffs > 2e-6)
    assert diffs.max() <= STEPS * 3e-4, diffs.max()
    assert out[0]["losses"] != out[1]["losses"]


def test_backward_passes_per_step_2_matches_jax(world):
    """backward_passes_per_step=2: call 1 only accumulates (the wrapped
    optimizer is not stepped, the parameters keep their bits), call 2
    averages the two calls' gradients, reduces and steps, call 3
    accumulates again."""
    params0, tokens, ref_losses, ref_params = _jax_train(
        backward_passes_per_step=2)
    out = _port_train(world, params0, tokens, backward_passes_per_step=2)
    _same_replicas(out, list(range(N)))
    assert out[0]["moved"] == [False, True, False]
    _exact_wire_within_tolerance(out[0], ref_losses, ref_params)


def test_adasum_refuses_explicit_compression_and_ignores_the_knob(
        monkeypatch, caplog):
    """An explicit compression with op=Adasum raises; a tier from
    HVD_TPU_COMPRESSION is ignored with one warning, and the step runs
    the exact wire (in a world of one Adasum returns the gradient)."""
    import horovod_tpu_torch.optim.distributed_optimizer as port_opt

    w = torch.nn.Parameter(torch.ones(3))
    with pytest.raises(ValueError, match="compression is not supported"):
        thvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1), op="adasum",
                                  compression=thvd.Compression.int8)
    monkeypatch.setenv("HVD_TPU_COMPRESSION", "int8")
    monkeypatch.setattr(port_opt, "_adasum_comp_warned", False)
    thvd.init(device="cpu")
    try:
        opt = thvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.5),
                                        op="adasum",
                                        named_parameters=[("w", w)])
        for _ in range(2):
            w.grad = torch.tensor([0.1, -0.3, 1e-4])
            with caplog.at_level(logging.WARNING):
                opt.step()
        assert caplog.text.count("HVD_TPU_COMPRESSION is ignored") == 1
        np.testing.assert_array_equal(
            w.detach().numpy(),
            np.float32(1) - 2 * np.float32(0.5) * np.float32([0.1, -0.3,
                                                              1e-4]))
        # Microbatches with Adasum: accumulated locally (no overlap
        # wire), then the one Adasum reduction of their mean.
        model = torch.nn.Module()
        model.v = torch.nn.Parameter(torch.ones(3))
        step = thvd.make_train_step(
            lambda m, b: (m.v * b).sum(), torch.optim.SGD([model.v], lr=0.5),
            op="adasum", microbatches=2)
        step(model, torch.tensor([[1.0, 2.0, 3.0], [3.0, 2.0, 1.0]]))
        np.testing.assert_array_equal(model.v.detach().numpy(),
                                      np.zeros(3, np.float32))
    finally:
        thvd.shutdown()
