"""The launcher (Horovod's ``horovod/runner``; counterpart of
``horovod_tpu/runner``).  Entry points:

* CLI: ``python -m horovod_tpu_torch.runner -np 4 python train.py``
  (or ``horovodtpurun-torch`` when the package is installed);
* API: ``horovod_tpu_torch.runner.run(4, ["python", "train.py"])``.
"""

from .launch import main, run, run_elastic, parse_args  # noqa: F401
from .check_build import check_build_str  # noqa: F401
