"""Module API (counterpart of mxnet_tpu/module/__init__.py; reference:
python/mxnet/module/__init__.py)."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
