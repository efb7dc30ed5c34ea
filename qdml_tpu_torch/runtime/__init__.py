"""Native host runtime of the port (``qdml_tpu/runtime/``): the C++ IO
library behind :class:`~qdml_tpu_torch.data.datasets.NpyGridLoader`."""

from qdml_tpu_torch.runtime.native_io import (  # noqa: F401
    NativeNpyFile,
    PrefetchPipeline,
    gather_rows,
    native_available,
)
