"""Worlds of ranks laid out as a ``(fed, data, model)`` mesh (``qdml_tpu/parallel/``).

The names of ``qdml_tpu/parallel/__init__.py``, the port's counterparts,
apart from those that exist only in JAX's placement model:
``local_grid_batch_to_global`` (no rank ever assembles a global array;
:mod:`~qdml_tpu_torch.parallel.multihost` says why) and ``place_tree``
(a rank holds its share as module parameters, laid out by
:func:`shard_hdce_state`). The collectives XLA inserts for JAX are written
out in :mod:`~qdml_tpu_torch.parallel.collectives`. The serving engine's
mesh is the cards one process sees (:class:`LocalMesh`,
:func:`make_local_mesh`, :func:`serve_mesh`), not a world of ranks.
"""

from qdml_tpu_torch.parallel.dp import (  # noqa: F401
    replicate,
    shard_flat_batch,
    shard_grid_batch,
)
from qdml_tpu_torch.parallel.federated import (  # noqa: F401
    hdce_state_shardings,
    shard_hdce_state,
)
from qdml_tpu_torch.parallel.mesh import (  # noqa: F401
    LocalMesh,
    init_distributed,
    make_local_mesh,
    make_mesh,
    serve_mesh,
    single_device_mesh,
)
from qdml_tpu_torch.parallel.multihost import (  # noqa: F401
    init_distributed_from_env,
    process_batch_slice,
)
