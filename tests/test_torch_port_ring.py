"""The port's sequence-parallel attention (``horovod_tpu_torch/parallel``:
ring attention on both engines, Ulysses) against the reference's,
mirroring ``tests/test_ring_attention.py`` on a 4-rank gloo world
(``tests/torch_port_workers.py``, spawned once for the module).

Each rank computes on its shards (batch over ``dp``, sequence over
``sp``, heads over ``tp``); the shards are put back together here and
held to the reference's ``ring_self_attention`` / ``ulysses_attention``
over the first four CPU devices, on the same seeded inputs.  On the CPU
the port's flash engine runs B1's plain version, the reference's the
Pallas kernel in interpret mode.  Tolerance: rtol 1e-4, atol 1e-5 (the
reference test's), outputs and gradients alike; the gradients of
``sum(o * o)`` are held to the reference's ``'xla'`` engine, its own
oracle for the flash engine's (``test_flash_engine_grads``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu.parallel import full_attention as jax_full_attention
from horovod_tpu.parallel import make_mesh as jax_make_mesh
from horovod_tpu.parallel import ring_self_attention as jax_ring
from horovod_tpu.parallel.ulysses import ulysses_attention as jax_ulysses

from horovod_tpu_torch.mesh import Mesh
from horovod_tpu_torch.parallel import make_mesh, ring_self_attention

import torch_port_workers as workers

N = 4
TOL = dict(rtol=1e-4, atol=1e-5)


def _qkv(b=2, t=16, h=4, d=8, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, t, h, d).astype(np.float32) * 0.3
                 for _ in range(3))


# (kind, layout, causal, engine, shape, grads)
CASES = {
    "ring_sp4": ("ring", {"sp": 4}, False, "xla", {}, False),
    "ring_sp4_causal": ("ring", {"sp": 4}, True, "xla", {}, False),
    "flash_sp4": ("ring", {"sp": 4}, False, "flash", {}, False),
    "flash_sp4_causal": ("ring", {"sp": 4}, True, "flash", {}, False),
    "flash_grads": ("ring", {"sp": 4}, True, "flash", {}, True),
    "xla_grads": ("ring", {"sp": 4}, True, "xla", {}, True),
    "ring_dp_sp": ("ring", {"dp": 2, "sp": 2}, False, "xla",
                   {"b": 4, "t": 8}, False),
    "ring_dp_sp_causal": ("ring", {"dp": 2, "sp": 2}, True, "xla",
                          {"b": 4, "t": 8}, False),
    "ring_dp_sp_tp": ("ring", {"dp": 1, "sp": 2, "tp": 2}, True, "xla",
                      {"b": 2, "t": 8}, False),
    "flash_sp_tp_grads": ("ring", {"sp": 2, "tp": 2}, True, "flash", {},
                          True),
    "ulysses_sp4": ("ulysses", {"sp": 4}, False, "xla", {"b": 4, "t": 8},
                    False),
    "ulysses_sp4_causal": ("ulysses", {"sp": 4}, True, "xla",
                           {"b": 4, "t": 8}, False),
    "ulysses_dp_sp_causal": ("ulysses", {"dp": 2, "sp": 2}, True, "xla",
                             {"b": 4, "t": 8}, True),
    "ulysses_heads": ("ulysses", {"sp": 4}, False, "xla", {"h": 2}, False),
}


def _reference(kind, layout, causal, engine, shape, grads):
    q, k, v = (jnp.asarray(a) for a in _qkv(**shape))
    mesh = jax_make_mesh(layout, devices=jax.devices()[:N])

    def attend(q, k, v, engine=engine):
        if kind == "ring":
            return jax_ring(q, k, v, mesh=mesh, causal=causal, engine=engine)
        return jax_ulysses(q, k, v, mesh=mesh, causal=causal)

    try:
        out = {"o": np.asarray(attend(q, k, v))}
    except ValueError as e:
        return {"error": str(e)}
    if grads:
        g = jax.jit(jax.grad(
            lambda q, k, v: jnp.sum(attend(q, k, v, "xla") ** 2),
            argnums=(0, 1, 2))).lower(q, k, v).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        out.update({f"d{n}": np.asarray(a)
                    for n, a in zip("qkv", g(q, k, v))})
    return out


def _assemble(outs, layout, key, shape):
    """The global ``[B, T, H, D]`` array from every rank's shard."""
    mesh = Mesh(tuple(layout), tuple(layout.values()))
    full = np.zeros(shape, np.float32)
    for r, o in enumerate(outs):
        c = mesh.coords(r)
        idx = []
        for dim, axis in enumerate(("dp", "sp", "tp")):
            n = layout.get(axis, 1)
            span = shape[dim] // n
            idx.append(slice(c.get(axis, 0) * span,
                             (c.get(axis, 0) + 1) * span))
        full[tuple(idx)] = o[key]
    return full


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on the world (submitted first) and in the reference."""
    world = workers.World(N, str(tmp_path_factory.mktemp("gloo") / "store"))
    try:
        for kind, layout, causal, engine, shape, grads in CASES.values():
            q, k, v = _qkv(**shape)
            world.submit("seq_attention", kind=kind, layout=layout, q=q, k=k,
                         v=v, causal=causal, engine=engine, grads=grads)
        ref = {name: _reference(*case) for name, case in CASES.items()}
        port = {name: world.collect(name, timeout=120) for name in CASES}
    finally:
        world.close()
    return port, ref


@pytest.mark.parametrize("name", [n for n in CASES if n != "ulysses_heads"])
def test_matches_the_reference(runs, name):
    port, ref = runs
    kind, layout, causal, engine, shape, grads = CASES[name]
    full_shape = _qkv(**shape)[0].shape
    keys = ["o"] + (["dq", "dk", "dv"] if grads else [])
    for key in keys:
        np.testing.assert_allclose(
            _assemble(port[name], layout, key, full_shape), ref[name][key],
            err_msg=key, **TOL)


def test_heads_not_divisible_raises(runs):
    """Ulysses with 2 heads over sp=4: the reference's error, word for
    word, on every rank."""
    port, ref = runs
    assert "divisible" in ref["ulysses_heads"]["error"]
    for out in port["ulysses_heads"]:
        assert out == {"error": ref["ulysses_heads"]["error"]}


def test_missing_axis_raises():
    q, k, v = (a for a in _qkv())
    with pytest.raises(ValueError, match="no axis"):
        ring_self_attention(q, k, v, mesh=make_mesh({"sp": 4}, world=N),
                            sp_axis="nope")
    with pytest.raises(ValueError, match="unknown ring attention engine"):
        from horovod_tpu_torch.parallel import ring_attention_local

        ring_attention_local(q, k, v, axis=None, engine="bogus")


@pytest.mark.parametrize("shape", [(1, 32, 4, 8), (2, 32, 1, 8),
                                   (1, 16, 1, 16), (2, 16, 4, 8)])
def test_flash_packs_contiguous_rows(monkeypatch, shape):
    """The flash kernel (B1) takes contiguous ``[BH, T, D]`` rows.  With a
    batch of one (a rank's share of a ``{'dp': 2, 'sp': 2}`` batch of 2)
    or one head, packing ``[B, T, H, D]`` was a view, not a copy, and the
    wrapper raised on the card; every packed operand must be
    contiguous, and the result the same."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    seen = []
    kernel = fa.flash_fwd

    def spy(q3, k3, v3, scale, causal):
        seen.append(all(t.is_contiguous() for t in (q3, k3, v3)))
        return kernel(q3, k3, v3, scale, causal)

    monkeypatch.setattr(fa, "flash_fwd", spy)
    q, k, v = (torch.from_numpy(a) for a in _qkv(*shape))
    o, _ = fa.flash_attention_with_lse(q, k, v, causal=True)
    assert seen == [True]
    ref = jax_full_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                             causal=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), **TOL)
