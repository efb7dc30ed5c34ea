"""The serving tier (``qdml_tpu/serve/``): engine, micro-batcher, replica pool, socket server, loadgen.

- :class:`~qdml_tpu_torch.serve.engine.ServeEngine` restores HDCE and a
  classifier, pins each bucket's circuit impl, routing and batching at
  warmup (three measured races), and serves classify -> route -> estimate;
- :class:`~qdml_tpu_torch.serve.batcher.MicroBatcher` is the bounded queue:
  coalescing to bucket edges or continuous admission, deadline-aware shedding
  into typed ``Overloaded`` results;
- :class:`~qdml_tpu_torch.serve.server.ServeLoop` /
  :class:`~qdml_tpu_torch.serve.server.ReplicaPool` pump it through the
  engine with supervision, a breaker and fault hooks;
  :func:`~qdml_tpu_torch.serve.server.run_server` puts the pool behind the
  newline-JSON socket protocol, which
  :class:`~qdml_tpu_torch.serve.client.ServeClient` speaks;
- :mod:`~qdml_tpu_torch.serve.loadgen` offers open-loop traffic and reports
  tail latency, goodput, padding waste, SLO attainment and parity.

With several visible cards (:func:`qdml_tpu_torch.parallel.mesh.serve_mesh`)
the engine serves over a ``(fed, data, model)`` mesh of them: each bucket
the data axis divides in row slices over ``data``, the weights copied to
each data position (or, with ``serve.expert_sharding``, trunk s on the
``fed=s`` positions), and :meth:`ServeEngine.swap_params` places new
weights at every position before the flip. The exports are the JAX
package's ``qdml_tpu/serve/__init__.py``'s.
"""

from qdml_tpu_torch.serve.batcher import (  # noqa: F401
    MicroBatcher,
    pick_bucket,
    power_of_two_buckets,
)
from qdml_tpu_torch.serve.breaker import CircuitBreaker  # noqa: F401
from qdml_tpu_torch.serve.client import ServeClient, ServeClientError  # noqa: F401
from qdml_tpu_torch.serve.engine import ServeEngine  # noqa: F401
from qdml_tpu_torch.serve.faults import (  # noqa: F401
    FAULT_CLASSES,
    FaultInjected,
    FaultPlan,
    FaultSpec,
)
from qdml_tpu_torch.serve.loadgen import (  # noqa: F401
    arrival_times,
    make_request_samples,
    run_loadgen,
    run_loadgen_socket,
)
from qdml_tpu_torch.serve.metrics import ServeMetrics  # noqa: F401
from qdml_tpu_torch.serve.server import (  # noqa: F401
    ExitCoordinator,
    ReplicaPool,
    ServeLoop,
    run_server,
    serve_async,
)
from qdml_tpu_torch.serve.types import (  # noqa: F401
    Overloaded,
    Prediction,
    Request,
)
