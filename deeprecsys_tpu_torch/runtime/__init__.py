"""Native (C++) host runtime: the hot/cold splitter and its hash index.

``cpp/drs_runtime.cpp`` is a byte-equal copy of the JAX package's source
(``tests/test_torch_config.py`` holds it so); ``native.py`` binds the parts
the port's hot/cold serving path calls.
"""

from deeprecsys_tpu_torch.runtime.native import HotIndex, get_lib, native_available

__all__ = ["HotIndex", "get_lib", "native_available"]
