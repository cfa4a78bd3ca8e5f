"""``hvd.run(func, ...)`` of the port (``horovod_tpu_torch/runner/
run_func.py``): a Python function across a fresh world, the results back
in rank order.

Mirrors ``tests/multiproc/test_run_func_mp.py`` (which the reference
marks slow; here two CPU ranks over gloo): real worker processes, the
local route and the agent mesh (ssh replaced by ``local_exec``), a
closure travelling by value (cloudpickle), the standard pickle's
fallback with cloudpickle hidden from the launcher and the workers, the
work directory's lifetime and a failing worker.
"""

import glob
import os
import pickle
import sys
import tempfile

import pytest

import horovod_tpu_torch as hvd
import torch_port_workers as workers
from horovod_tpu_torch.runner import remote, run_func

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")


def _env(*front) -> dict:
    # Workers resolve the package and, for module-level functions
    # pickled by reference, tests/torch_port_workers.py.
    return {"PYTHONPATH": os.pathsep.join(
        p for p in (*front, REPO, TESTS, os.environ.get("PYTHONPATH")) if p)}


def _own_dirs() -> set:
    return set(glob.glob(os.path.join(tempfile.gettempdir(),
                                      "hvd_tpu_torch_run_*")))


def test_closure_results_in_rank_order_and_default_workdir_removed():
    """A closure travels by value; the results come back in rank order;
    the work directory the call made is gone afterwards."""
    factor = 7.0

    def fn(scale):
        import torch
        import horovod_tpu_torch as hvd

        hvd.init(device="cpu")
        out = hvd.allreduce(torch.full((1, 2), hvd.rank() + 1.0),
                            op=hvd.Sum, name="closure")
        return {"rank": hvd.rank(), "size": hvd.size(),
                "sum": float(out[0, 0]) * scale + factor}

    before = _own_dirs()
    results = hvd.run(fn, args=(10,), np=2, env=_env(), start_timeout=60.0)
    assert results == [{"rank": r, "size": 2, "sum": 37.0} for r in (0, 1)]
    assert _own_dirs() == before
    assert hvd.runner.run_function is run_func.launch is hvd.run


def test_stdlib_pickle_fallback_without_cloudpickle(tmp_path, monkeypatch):
    """With cloudpickle hidden in the launcher and in the workers, a
    module-level function still runs (the standard pickle takes it by
    reference)."""
    hide = tmp_path / "hide"
    hide.mkdir()
    (hide / "cloudpickle.py").write_text("raise ImportError('hidden')\n")
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    assert run_func._serializer() is pickle
    results = hvd.run(workers.run_func_body, args=(1.0,),
                      kwargs={"bias": 0.5}, np=2, env=_env(str(hide)),
                      start_timeout=60.0)
    assert [r["rank"] for r in results] == [0, 1]
    assert [r["sum"] for r in results] == [3.5, 3.5]
    assert not any(r["cloudpickle"] for r in results)


def test_remote_hosts_through_the_agent_mesh_keep_the_workdir(tmp_path,
                                                              monkeypatch):
    """``hosts`` naming other hosts launches through the agent mesh (one
    rank a host: two groups); an explicit ``workdir`` is left in place
    with the payload and the results."""
    monkeypatch.setattr(remote, "ssh_exec", remote.local_exec)
    wd = tmp_path / "exchange"
    wd.mkdir()
    results = hvd.run(workers.run_func_body, args=(2.0,), np=2,
                      hosts="fake-host-a:1,fake-host-b:1", env=_env(),
                      workdir=str(wd), start_timeout=60.0)
    assert [r["cross"] for r in results] == [[0, 2], [1, 2]]
    assert [r["sum"] for r in results] == [6.0, 6.0]
    assert {"payload.pkl", "result_0.pkl", "result_1.pkl"} <= \
        {p.name for p in wd.iterdir()}


def test_worker_failure_raises_and_local_slots_bound_np():
    def boom():
        raise RuntimeError("worker exploded")

    with pytest.raises(RuntimeError, match="rc="):
        hvd.run(boom, np=2, env=_env(), start_timeout=60.0)
    with pytest.raises(ValueError, match="exceeds the 2 declared"):
        hvd.run(boom, np=3, hosts="localhost:2", env=_env())
