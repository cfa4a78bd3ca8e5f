"""The port's torch binding (``horovod_tpu_torch/torch/``) against the
reference's (``horovod_tpu.torch``; ``tests/test_torch_api.py``).

At one worker, in-process: both bindings drive the same ``nn.Module``
from the same weights on the same inputs (numpy, from a seed), and the
results are compared bit for bit: the collective API, the state
broadcasts, the hook-driven ``DistributedOptimizer`` after three steps
(SGD and Adam; none and fp16; ``num_groups`` 0 and 4;
``backward_passes_per_step=2``; ``gradient_predivide_factor=2.0``;
sparse gradients, densified and not) on a toy MLP, an embedding model
and a 2-layer narrow GPT (flash attention on B1's plain version), and
``SyncBatchNorm``.  On a 2-rank gloo world
(``tests/torch_port_workers.py``): the hook route against the core's
fused ``make_train_step`` on the narrow GPT, bit for bit; the recorded
collective sequences of both ranks under hooks with ``num_groups=4``;
``SyncBatchNorm`` against the reference's on the concatenated batch.
"""

import copy
import inspect

import numpy as np
import pytest
import torch

import horovod_tpu.torch as ref
import horovod_tpu_torch as core
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.analysis import step_check as sc

import torch_port_workers as workers

GPT_SMALL = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_ff=64,
                 max_seq_len=16, attention="flash", dtype="bfloat16")
BINDINGS = {"ref": ref, "port": hvd}


@pytest.fixture(scope="module")
def session():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """Two ranks, spawned first so that their start-up overlaps the
    in-process tests."""
    w = workers.World(2, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield w
    w.close()


def _same(a, b):
    """Bit for bit: dtype, shape and every element."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
    assert torch.equal(a, b), (a, b)


def _both(fn):
    """``fn(binding)`` on the reference's and on the port's binding."""
    return fn(ref), fn(hvd)


# --- the collective API -------------------------------------------------------

@pytest.mark.usefixtures("session")
class TestSingleWorkerOps:
    def test_world(self):
        assert hvd.size() == ref.size() == 1
        assert hvd.rank() == ref.rank() == 0
        assert (hvd.cross_rank(), hvd.cross_size()) == (0, 1)

    @pytest.mark.parametrize("op", [hvd.Average, hvd.Sum, hvd.Min, hvd.Max,
                                    hvd.Product, hvd.Adasum])
    def test_allreduce_identity(self, op):
        t = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 1
        _same(*_both(lambda b: b.allreduce(t, op=op)))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                       torch.float16, torch.bfloat16,
                                       torch.int32, torch.int64])
    def test_allreduce_dtypes(self, dtype):
        t = (torch.arange(4) + 1).to(dtype)
        _same(*_both(lambda b: b.allreduce(t, op=b.Sum)))
        _same(*_both(lambda b: b.allreduce(t, op=b.Average)))

    def test_allreduce_scalar(self):
        got, want = _both(lambda b: b.allreduce(torch.tensor(3.0)))
        _same(got, want)
        assert got.dim() == 0

    def test_allreduce_inplace(self):
        t = torch.ones(3)
        assert hvd.allreduce_(t, op=hvd.Sum) is t
        h = hvd.allreduce_async_(t, op=hvd.Sum)
        assert hvd.synchronize(h) is t

    def test_allreduce_async_poll(self):
        t = torch.linspace(-1.0, 1.0, 4)
        h = hvd.allreduce_async(t)
        out = hvd.synchronize(h)
        assert hvd.poll(h)
        _same(out, ref.allreduce(t))

    def test_allreduce_scales(self):
        t = torch.full((3,), 2.0)
        _same(*_both(lambda b: b.allreduce(
            t, op=b.Sum, prescale_factor=0.5, postscale_factor=10.0)))

    def test_allreduce_fp16_compression(self):
        t = torch.from_numpy(np.random.RandomState(0).randn(5)
                             .astype(np.float32))
        got, want = _both(lambda b: b.allreduce(
            t, op=b.Sum, compression=b.Compression.fp16))
        _same(got, want)
        assert got.dtype == torch.float32
        assert not torch.equal(got, t)     # rounded through float16

    def test_grouped_allreduce(self):
        ts = [torch.ones(3), torch.full((2, 2), 2.0)]
        _same(*_both(lambda b: b.grouped_allreduce(ts, op=b.Sum)))
        _same(*_both(lambda b: b.grouped_allreduce(
            ts, compression=b.Compression.fp16, postscale_factor=0.5)))
        us = [t.clone() for t in ts]
        outs = hvd.grouped_allreduce_(us, op=hvd.Sum)
        assert all(o is u for o, u in zip(outs, us))

    def test_allgather(self):
        t = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        _same(*_both(lambda b: b.allgather(t)))
        _same(*_both(lambda b: b.grouped_allgather([t, t[:1]])))

    def test_broadcast(self):
        t = torch.arange(4, dtype=torch.float32)
        _same(*_both(lambda b: b.broadcast(t, root_rank=0)))
        t2 = torch.zeros(4)
        assert hvd.broadcast_(t2, root_rank=0) is t2

    def test_alltoall(self):
        t = torch.arange(4, dtype=torch.float32)
        _same(*_both(lambda b: b.alltoall(t)))

    def test_alltoall_splits(self):
        t = torch.arange(3, dtype=torch.float32)
        (out, rs), (rout, rrs) = _both(
            lambda b: b.alltoall(t, torch.tensor([3])))
        _same(out, rout)
        _same(rs, rrs)

    def test_reducescatter(self):
        t = torch.arange(4, dtype=torch.float32)
        _same(*_both(lambda b: b.reducescatter(t)))

    def test_grouped_reducescatter(self):
        ts = [torch.arange(4, dtype=torch.float32), torch.ones(2, 3)]
        _same(*_both(lambda b: b.grouped_reducescatter(ts)))

    def test_barrier_and_join(self):
        hvd.barrier()
        # The last rank to join; the reference's counts slots (7 of its
        # 8-device mesh), the port's ranks are processes.
        assert hvd.join() == hvd.size() - 1 == 0
        assert ref.join() >= 0

    def test_broadcast_object(self):
        assert hvd.broadcast_object({"a": 1}) == {"a": 1}
        assert hvd.allgather_object(7) == [7]


def _public(module) -> dict:
    """The names a module defines for its users (not its imports of
    modules or typing helpers)."""
    out = {}
    for name, value in vars(module).items():
        if name.startswith("_") or inspect.ismodule(value):
            continue
        if getattr(value, "__module__", None) == "typing":
            continue
        out[name] = value
    return out


def test_mpi_ops_names_and_keyword_signatures():
    """Every public name of the reference's ``mpi_ops`` is in the port's
    (its numpy/ml_dtypes bridge helpers are private), and each function
    has the reference's parameters: names, kinds and defaults."""
    import horovod_tpu.torch.mpi_ops as ref_ops
    import horovod_tpu_torch.torch.mpi_ops as ops

    want, got = _public(ref_ops), _public(ops)
    for name in ("np", "ml_dtypes", "torch", "H"):
        want.pop(name, None)
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for name, fn in want.items():
        if isinstance(fn, str):
            assert got[name] == fn, name
        elif inspect.isfunction(fn):
            assert inspect.signature(got[name]).parameters.keys() == \
                inspect.signature(fn).parameters.keys(), name
            for pname, p in inspect.signature(fn).parameters.items():
                q = inspect.signature(got[name]).parameters[pname]
                assert (q.kind, q.default) == (p.kind, p.default), \
                    (name, pname)
    assert not any(n in vars(ops) for n in ("np", "ml_dtypes"))


def test_package_exports_match_the_reference():
    import horovod_tpu.torch as r

    missing = {n for n in _public(r)} - set(dir(hvd)) - {"jax"}
    assert not missing, sorted(missing)
    assert hvd.Compression.none is core.Compression.none
    assert hvd.Compression.fp16 is core.Compression.fp16
    assert not hasattr(hvd.Compression, "int8")


# --- state broadcasts ---------------------------------------------------------

@pytest.mark.usefixtures("session")
class TestBroadcastState:
    def test_broadcast_parameters_state_dict(self):
        torch.manual_seed(0)
        model = torch.nn.BatchNorm1d(3)
        model.register_buffer("flag", torch.tensor([True, False]))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd.broadcast_parameters(model.named_parameters(), root_rank=0)
        for k, v in model.state_dict().items():
            _same(v, before[k])

    @pytest.mark.parametrize("kind", ["adam", "hook"])
    def test_broadcast_optimizer_state_materializes(self, kind):
        """A lazy optimizer gets its state from the zero-lr step on both
        bindings, the hook optimizer (a subclass made on the fly)
        included; the entries equal the reference's."""
        torch.manual_seed(0)
        states = {}
        for name, b in BINDINGS.items():
            torch.manual_seed(0)
            model = torch.nn.Linear(4, 2)
            opt = torch.optim.Adam(model.parameters(), lr=0.01)
            if kind == "hook":
                opt = b.DistributedOptimizer(
                    opt, named_parameters=model.named_parameters())
            b.broadcast_optimizer_state(opt, root_rank=0)
            assert opt.state_dict()["state"], name
            assert opt.param_groups[0]["lr"] == 0.01
            states[name] = opt.state_dict()["state"]
        for pid, entries in states["ref"].items():
            for key, val in entries.items():
                _same(states["port"][pid][key], val)

    def test_hook_optimizer_state_after_steps(self):
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 2)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=0.01),
            named_parameters=model.named_parameters())
        for _ in range(2):
            opt.zero_grad()
            model(torch.ones(3, 4)).sum().backward()
            opt.step()
        want = copy.deepcopy(opt.state_dict())
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        for pid, entries in want["state"].items():
            for key, val in entries.items():
                _same(opt.state_dict()["state"][pid][key], val)

    def test_rejects_positional_params_and_lbfgs(self):
        model = torch.nn.Linear(2, 2)
        for b in BINDINGS.values():
            with pytest.raises(ValueError):
                b.broadcast_parameters(list(model.parameters()))
            with pytest.raises(ValueError, match="LBFGS"):
                b.broadcast_optimizer_state(
                    torch.optim.LBFGS(model.parameters()))


# --- the hook-driven DistributedOptimizer -------------------------------------

class _Emb(torch.nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.emb = torch.nn.Embedding(10, 4, sparse=True)
        self.head = torch.nn.Linear(4, 1)

    def forward(self, idx):
        return self.head(self.emb(idx))


def _problem(kind: str, seed: int = 0):
    """``(model, batches, loss)``: a seeded model and numpy-made batches
    of ``kind`` (mlp, emb, gpt)."""
    rng = np.random.RandomState(seed)
    torch.manual_seed(seed)
    if kind == "mlp":
        model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                    torch.nn.Linear(8, 2))
        batches = [torch.from_numpy(rng.randn(8, 4).astype(np.float32))
                   for _ in range(6)]
        return model, batches, lambda m, x: m(x).pow(2).mean()
    if kind == "emb":
        batches = [torch.from_numpy(rng.randint(0, 10, (6,)))
                   for _ in range(6)]
        return _Emb(), batches, lambda m, i: m(i).pow(2).mean()
    model = workers._binding_gpt(GPT_SMALL)
    batches = [torch.from_numpy(rng.randint(0, 64, (2, 17)))
               for _ in range(6)]
    loss_fn = core.models.lm_loss_fn(model)
    return model, batches, lambda m, t: loss_fn(m, (t[:, :-1], t[:, 1:]))


_OPTS = {"sgd": lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
         "adam": lambda ps: torch.optim.Adam(ps, lr=1e-2)}

# (model, optimizer, compression, num_groups, backward_passes_per_step,
#  gradient_predivide_factor, sparse_as_dense)
_CASES = {
    "mlp-sgd": ("mlp", "sgd", "none", 0, 1, 1.0, False),
    "mlp-adam": ("mlp", "adam", "none", 0, 1, 1.0, False),
    "mlp-sgd-fp16": ("mlp", "sgd", "fp16", 0, 1, 1.0, False),
    "mlp-adam-fp16": ("mlp", "adam", "fp16", 0, 1, 1.0, False),
    "mlp-sgd-groups4": ("mlp", "sgd", "none", 4, 1, 1.0, False),
    "mlp-adam-fp16-groups4": ("mlp", "adam", "fp16", 4, 1, 1.0, False),
    "mlp-sgd-bpps2": ("mlp", "sgd", "none", 0, 2, 1.0, False),
    "mlp-adam-predivide2": ("mlp", "adam", "none", 0, 1, 2.0, False),
    "mlp-sgd-bpps2-groups4-predivide2": ("mlp", "sgd", "none", 4, 2, 2.0,
                                         False),
    "emb-sgd-sparse": ("emb", "sgd", "none", 0, 1, 1.0, False),
    "emb-sgd-sparse-bpps2": ("emb", "sgd", "none", 0, 2, 1.0, False),
    "emb-sgd-sparse-as-dense": ("emb", "sgd", "none", 0, 1, 1.0, True),
    "emb-adam-sparse-as-dense-groups4": ("emb", "adam", "none", 4, 1, 1.0,
                                         True),
    "gpt-adam": ("gpt", "adam", "none", 0, 1, 1.0, False),
    "gpt-adam-fp16": ("gpt", "adam", "fp16", 0, 1, 1.0, False),
    "gpt-adam-groups4": ("gpt", "adam", "none", 4, 1, 1.0, False),
    "gpt-sgd-fp16-groups4": ("gpt", "sgd", "fp16", 4, 1, 1.0, False),
    "gpt-sgd-bpps2": ("gpt", "sgd", "none", 0, 2, 1.0, False),
    "gpt-adam-predivide2": ("gpt", "adam", "none", 0, 1, 2.0, False),
}


def _train(b, model, opt_name, batches, loss, *, compression, num_groups,
           bpps, predivide, sparse_as_dense, steps=3):
    opt = b.DistributedOptimizer(
        _OPTS[opt_name](model.parameters()),
        named_parameters=model.named_parameters(),
        compression=getattr(b.Compression, compression),
        backward_passes_per_step=bpps,
        gradient_predivide_factor=predivide,
        sparse_as_dense=sparse_as_dense, num_groups=num_groups)
    for s in range(steps):
        opt.zero_grad()
        for x in batches[s * bpps:(s + 1) * bpps]:
            loss(model, x).backward()
        opt.step()
    return opt


@pytest.mark.usefixtures("session")
class TestDistributedOptimizer:
    @pytest.mark.parametrize("case", sorted(_CASES))
    def test_parameters_bitwise_after_three_steps(self, case):
        kind, opt_name, comp, groups, bpps, pre, dense = _CASES[case]
        model, batches, loss = _problem(kind)
        twin = copy.deepcopy(model)
        start = copy.deepcopy(model.state_dict())
        kwargs = dict(compression=comp, num_groups=groups, bpps=bpps,
                      predivide=pre, sparse_as_dense=dense)
        _train(ref, twin, opt_name, batches, loss, **kwargs)
        opt = _train(hvd, model, opt_name, batches, loss, **kwargs)
        assert isinstance(opt, {"sgd": torch.optim.SGD,
                                "adam": torch.optim.Adam}[opt_name])
        moved = False
        for (n, p), (_, q) in zip(model.named_parameters(),
                                  twin.named_parameters()):
            _same(p.detach(), q.detach())
            moved |= not torch.equal(p, start[n])
        assert moved

    def test_subclass_keeps_schedulers(self):
        model, batches, loss = _problem("mlp")
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        assert isinstance(opt, torch.optim.AdamW)
        sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=0.5)
        loss(model, batches[0]).backward()
        opt.step()
        sched.step()
        assert opt.param_groups[0]["lr"] == pytest.approx(0.05)

    def test_one_hook_per_trainable_parameter(self):
        model = workers._binding_gpt(GPT_SMALL)
        next(model.parameters()).requires_grad_(False)
        trainable = [p for p in model.parameters() if p.requires_grad]
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        assert len(opt._hook_handles) == len(trainable)

    def test_tied_weight_gets_one_hook_and_one_reduction(self):
        """A weight used twice in the forward (an embedding tied to the
        output projection) is one parameter: one hook, one allreduce of
        its summed gradient."""
        torch.manual_seed(0)
        emb = torch.nn.Embedding(8, 4)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(emb.parameters(), lr=0.1),
            named_parameters=emb.named_parameters())
        assert len(opt._hook_handles) == 1
        idx = torch.tensor([1, 2, 3])
        with sc.record_collectives() as seq:
            (emb(idx) @ emb.weight.t()).pow(2).mean().backward()
        assert [e[0] for e in seq] == ["all_reduce"]
        assert seq[0][2] == emb.weight.numel()
        opt.step()

    def test_dispatch_during_backward(self):
        """Handles are in flight before ``backward()`` returns: the input's
        gradient, the last one the engine computes, sees them."""
        model, batches, loss = _problem("mlp")
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        seen = []
        x = batches[0].clone().requires_grad_(True)
        x.register_hook(lambda g: seen.append(
            [type(h).__name__ for h in opt._handles.values()]))
        loss(model, x).backward()
        assert seen and len(seen[0]) >= 2, seen
        assert all(k == "Handle" for k in seen[0])
        opt.step()

    def test_num_groups_dispatches_group_when_full(self):
        model, batches, loss = _problem("mlp")
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(), num_groups=1)
        loss(model, batches[0]).backward()
        assert {h[0] for h in opt._handles.values()} == {"group"}
        opt.step()

    def test_partial_group_swept_at_synchronize(self):
        """A member whose hook never fires (a gradient set by hand) is
        reduced at synchronize, its group dispatched partial."""
        for b in BINDINGS.values():
            model, batches, loss = _problem("mlp")
            opt = b.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1),
                named_parameters=model.named_parameters(), num_groups=2)
            model[0].weight.grad = torch.ones_like(model[0].weight)
            opt.synchronize()
            assert not opt._handles and not opt._group_ready
            _same(model[0].weight.grad, torch.ones_like(model[0].weight))

    def test_grouped_double_backward_raises(self):
        for b in BINDINGS.values():
            model, batches, loss = _problem("mlp")
            b.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1),
                named_parameters=model.named_parameters(), num_groups=1)
            loss(model, batches[0]).backward()
            with pytest.raises(AssertionError, match="computed twice"):
                loss(model, batches[0]).backward()

    def test_num_groups_caps_and_validates(self):
        model, batches, loss = _problem("mlp")
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(), num_groups=99)
        assert len(set(opt._param_group.values())) == 4
        loss(model, batches[0]).backward()
        opt.step()
        with pytest.raises(ValueError, match="num_groups"):
            hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1), num_groups=-1)
        with pytest.raises(ValueError, match="predivide"):
            hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1), op=hvd.Sum,
                gradient_predivide_factor=2.0)
        with pytest.raises(ValueError, match="named_parameters"):
            hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1),
                named_parameters=list(model.parameters()))

    def test_zero_grad_race_guard(self):
        model, batches, loss = _problem("mlp")
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        loss(model, batches[0]).backward()
        with pytest.raises(AssertionError, match="race condition"):
            opt.zero_grad()
        opt.synchronize()
        opt.zero_grad()

    def test_synchronize_then_skip(self):
        """Gradients clipped between ``synchronize()`` and a ``step()``
        under ``skip_synchronize()``, on both bindings alike."""
        params = {}
        for name, b in BINDINGS.items():
            model, batches, loss = _problem("mlp")
            opt = b.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1),
                named_parameters=model.named_parameters())
            loss(model, batches[0]).backward()
            opt.synchronize()
            torch.nn.utils.clip_grad_norm_(model.parameters(), 0.01)
            with opt.skip_synchronize():
                opt.step()
            params[name] = [p.detach() for p in model.parameters()]
        _same(params["port"], params["ref"])

    def test_set_backward_passes_per_step(self):
        model, batches, loss = _problem("mlp")
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        opt.set_backward_passes_per_step(2)
        loss(model, batches[0]).backward()
        assert not opt._handles          # the first of two passes
        loss(model, batches[1]).backward()
        assert len(opt._handles) == 4
        opt.step()


@pytest.mark.usefixtures("session")
class TestSparseGradients:
    def test_sparse_allreduce_path(self):
        torch.manual_seed(0)
        emb = torch.nn.Embedding(10, 4, sparse=True)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(emb.parameters(), lr=0.5),
            named_parameters=emb.named_parameters())
        emb(torch.tensor([1, 3, 3])).sum().backward()
        assert opt._handles[emb.weight][0] == "sparse"
        opt.synchronize()
        g = emb.weight.grad.to_dense()
        _same(g[3], torch.full((4,), 2.0))
        _same(g[0], torch.zeros(4))

    def test_sparse_adasum_rejected(self):
        for b in BINDINGS.values():
            emb = torch.nn.Embedding(6, 2, sparse=True)
            b.DistributedOptimizer(
                torch.optim.SGD(emb.parameters(), lr=0.1), op=b.Adasum)
            with pytest.raises(NotImplementedError, match="sparse"):
                emb(torch.tensor([0, 1])).sum().backward()


# --- SyncBatchNorm -------------------------------------------------------------

_BN_SHAPES = {"1d": (6, 3), "1d-seq": (4, 3, 5), "2d": (4, 3, 4, 4),
              "3d": (2, 3, 2, 3, 3)}


def _bn_pair(num_features, dtype, seed=0, **kwargs):
    rng = np.random.RandomState(seed)
    mods = []
    for b in (ref, hvd):
        m = b.SyncBatchNorm(num_features, **kwargs).to(dtype)
        if m.affine:
            with torch.no_grad():
                m.weight.copy_(torch.from_numpy(
                    rng.rand(num_features) + 0.5))
                m.bias.copy_(torch.from_numpy(rng.randn(num_features)))
            rng = np.random.RandomState(seed)
        mods.append(m)
    return mods


@pytest.mark.usefixtures("session")
class TestSyncBatchNorm:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("shape", sorted(_BN_SHAPES))
    def test_matches_reference(self, shape, dtype):
        rng = np.random.RandomState(1)
        x0 = torch.from_numpy(rng.randn(*_BN_SHAPES[shape]) * 2 + 0.5).to(dtype)
        outs = []
        for m in _bn_pair(3, dtype):
            x = x0.clone().requires_grad_(True)
            y = m(x)
            y.pow(3).sum().backward()
            m(x0)          # a second step of the running statistics
            outs.append([y.detach(), x.grad, m.weight.grad, m.bias.grad,
                         m.running_mean, m.running_var,
                         m.num_batches_tracked])
        _same(outs[1], outs[0])

    def test_matches_batchnorm(self):
        """Against ``nn.BatchNorm2d`` in f64 (the reference's own check)."""
        x = torch.from_numpy(np.random.RandomState(0).randn(6, 3, 4, 4))
        sbn = hvd.SyncBatchNorm(3).double()
        bn = torch.nn.BatchNorm2d(3).double()
        xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
        ya, yb = sbn(xa), bn(xb)
        torch.testing.assert_close(ya, yb, rtol=0, atol=1e-10)
        ya.pow(2).sum().backward()
        yb.pow(2).sum().backward()
        torch.testing.assert_close(xa.grad, xb.grad, rtol=0, atol=1e-8)
        torch.testing.assert_close(sbn.running_var, bn.running_var,
                                   rtol=0, atol=1e-10)

    def test_affine_false(self):
        outs = []
        x0 = torch.from_numpy(np.random.RandomState(2).randn(4, 3, 5))
        for m in _bn_pair(3, torch.float64, affine=False):
            x = x0.clone().requires_grad_(True)
            y = m(x)
            y.pow(2).sum().backward()
            outs.append([y.detach(), x.grad, m.running_var])
        _same(outs[1], outs[0])

    def test_no_running_stats_both_modes(self):
        x = torch.from_numpy(np.random.RandomState(3).randn(4, 3))
        outs = []
        for m in _bn_pair(3, torch.float64, track_running_stats=False):
            y_train = m(x)
            m.eval()
            y_eval = m(x)
            _same(y_train, y_eval)
            outs.append(y_eval.detach())
        _same(outs[1], outs[0])

    def test_eval_mode(self):
        x = torch.from_numpy(np.random.RandomState(4).randn(5, 3, 2, 2))
        outs = []
        for m in _bn_pair(3, torch.float64):
            m(x)
            m.eval()
            xe = x.clone().requires_grad_(True)
            y = m(xe)
            y.sum().backward()
            outs.append([y.detach(), xe.grad])
        _same(outs[1], outs[0])


# --- elastic ---------------------------------------------------------------------

@pytest.mark.usefixtures("session")
class TestElastic:
    def test_reference_module_layout(self):
        import horovod_tpu.torch.elastic as r

        for name in ("TorchState", "ObjectState", "run", "ElasticSampler"):
            assert hasattr(r, name) and hasattr(hvd.elastic, name), name
        assert hvd.elastic.TorchState is core.elastic.TorchState
        assert hvd.ElasticSampler is core.elastic.ElasticSampler

    def test_torch_state_round_trip_with_the_hook_optimizer(self, tmp_path):
        from horovod_tpu_torch.checkpoint import Checkpointer

        model, batches, loss = _problem("mlp")
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())

        def step(s):
            opt.zero_grad()
            loss(model, batches[s]).backward()
            opt.step()

        step(0)
        state = hvd.elastic.TorchState(model=model, optimizer=opt, batch=1)
        w1 = copy.deepcopy(model.state_dict())
        m1 = copy.deepcopy(opt.state_dict()["state"])
        step(1)
        state.batch = 9
        state.restore()
        for k, v in model.state_dict().items():
            _same(v, w1[k])
        _same(opt.state_dict()["state"][0]["momentum_buffer"],
              m1[0]["momentum_buffer"])
        assert state.batch == 1
        state.sync()
        ckpt = Checkpointer(str(tmp_path))
        state.save_to(ckpt, step=1)

        twin, _, _ = _problem("mlp", seed=5)
        opt2 = hvd.DistributedOptimizer(
            torch.optim.SGD(twin.parameters(), lr=0.1, momentum=0.9),
            named_parameters=twin.named_parameters())
        state2 = hvd.elastic.TorchState(model=twin, optimizer=opt2, batch=0)
        state2.load_from(ckpt, step=1)
        for k, v in twin.state_dict().items():
            _same(v, w1[k])
        _same(opt2.state_dict()["state"][0]["momentum_buffer"],
              m1[0]["momentum_buffer"])
        assert state2.batch == 1
        # Stepping on from the restored state equals stepping on from the
        # committed one.
        step(1)
        opt2.zero_grad()
        loss(twin, batches[1]).backward()
        opt2.step()
        _same([p.detach() for p in twin.parameters()],
              [p.detach() for p in model.parameters()])


# --- two ranks --------------------------------------------------------------------

def _tokens(seed=0, rows=4):
    return np.random.RandomState(seed).randint(
        0, GPT_SMALL["vocab_size"], (rows, 17)).astype(np.int64)


def test_hook_route_matches_the_fused_route_at_two_ranks(world):
    """Phase (a) of the chip script in small: three AdamW steps through
    the hooks, three through ``make_train_step`` from the same weights,
    each rank on its rows: the losses and every parameter bit for bit,
    the replicas equal."""
    res = world.run("binding_routes", config=GPT_SMALL, tokens=_tokens(),
                    steps=3)
    for r in res:
        assert r["hook"]["losses"] == r["fused"]["losses"]
        assert r["hooks"] == len(r["hook"]["params"])
        for name, p in r["fused"]["params"].items():
            np.testing.assert_array_equal(r["hook"]["params"][name], p,
                                          err_msg=name)
    for name, p in res[0]["hook"]["params"].items():
        np.testing.assert_array_equal(res[1]["hook"]["params"][name], p)
    first = res[0]["seqs"][0]
    assert sum(e[0] == "all_reduce" for e in first) == res[0]["hooks"]


def test_hook_sequences_equal_on_both_ranks_with_groups(world):
    """Phase (b) in small: fp16 and ``num_groups=4``: finite losses, four
    grouped dispatches a step (fused by dtype), the recorded sequences
    equal on both ranks and across the steps."""
    res = world.run("binding_routes", config=GPT_SMALL, tokens=_tokens(1),
                    steps=3, compression="fp16", num_groups=4, fused=False)
    assert all(np.isfinite(r["hook"]["losses"]).all() for r in res)
    a, b = res[0]["seqs"], res[1]["seqs"]
    assert a == b
    assert a[0] == a[1] == a[2]
    assert {e[1] for e in a[0]} == {"float16"}
    found = sc.compare_sequences([a[0], b[0]], path="binding", what="hook")
    assert not found, [f.as_dict() for f in found]


def test_sync_batch_norm_two_ranks_match_the_reference(world):
    """Each rank normalises its half with the global statistics: its
    output and input gradient rows, the running statistics and the
    ranks' summed weight and bias gradients equal the reference's
    ``SyncBatchNorm`` on the concatenated batch at one worker (1e-6
    relative)."""
    rng = np.random.RandomState(7)
    x = (rng.randn(8, 3, 4, 4) * 3 + 1).astype(np.float32)
    weight = (rng.rand(3) + 0.5).astype(np.float32)
    bias = rng.randn(3).astype(np.float32)
    upstream = rng.randn(*x.shape).astype(np.float32)
    res = world.run("binding_sync_bn", x=x, weight=weight, bias=bias,
                    upstream=upstream)
    m = ref.SyncBatchNorm(3)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(weight))
        m.bias.copy_(torch.from_numpy(bias))
    xs = torch.from_numpy(x).requires_grad_(True)
    y = m(xs)
    (y * torch.from_numpy(upstream)).sum().backward()

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())

    for r, part in enumerate(res):
        close(part["y"], y.detach().numpy()[4 * r:4 * (r + 1)])
        close(part["x_grad"], xs.grad.numpy()[4 * r:4 * (r + 1)])
        close(part["running_mean"], m.running_mean.numpy())
        close(part["running_var"], m.running_var.numpy())
    close(res[0]["w_grad"] + res[1]["w_grad"], m.weight.grad.numpy())
    close(res[0]["b_grad"] + res[1]["b_grad"], m.bias.grad.numpy())
