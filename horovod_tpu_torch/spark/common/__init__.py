"""The Spark estimators' shared plumbing: stores and parameters.

Counterpart of ``horovod_tpu/spark/common/__init__.py`` (reference:
``horovod/spark/common/``).
"""

from .params import EstimatorParams  # noqa: F401
from .store import FilesystemStore, LocalStore, Store  # noqa: F401
