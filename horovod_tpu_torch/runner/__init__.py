"""The launcher (Horovod's ``horovod/runner``; counterpart of
``horovod_tpu/runner``).  Entry points:

* CLI: ``python -m horovod_tpu_torch.runner -np 4 python train.py``
  (or ``horovodtpurun-torch`` when the package is installed);
* API: ``horovod_tpu_torch.runner.run(4, ["python", "train.py"])``;
* a function: ``horovod_tpu_torch.run(func, np=4)`` (also
  ``runner.run_function``), results in rank order.

A host list naming another host launches through ssh-started task
agents (:mod:`.remote`); an LSF allocation through ``jsrun``
(:mod:`.lsf`).
"""

from .launch import main, run, run_elastic, parse_args  # noqa: F401
from .check_build import check_build_str  # noqa: F401


def __getattr__(name):
    # run_function, imported on first use (see horovod_tpu_torch.run).
    if name == "run_function":
        from .run_func import launch

        return launch
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
