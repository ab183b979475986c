"""Native (C++) host runtime: the hot/cold splitter and its hash index, the
shared-memory packet ring of the cpu-mp process engines and its blob arena,
and a precise sleep.

``cpp/drs_runtime.cpp`` is a byte-equal copy of the JAX package's source
(``tests/test_torch_config.py`` holds it so); ``native.py`` binds it.
"""

import queue

from deeprecsys_tpu_torch.runtime.native import (
    HotIndex, get_lib, native_available, precise_sleep_ns)


class Empty(queue.Empty):
    """Raised by ``ShmRingQueue.get``/``get_nowait`` on an empty ring. A
    ``queue.Empty``, so code that drains either kind of queue catches one
    type."""


__all__ = ["Empty", "HotIndex", "get_lib", "native_available", "precise_sleep_ns"]
