"""Replica lifecycle layer of the port (kserve_tpu/lifecycle): graceful
drain and preemption-safe resumable generation.

- `ReplicaLifecycle`: the STARTING -> READY -> DRAINING -> TERMINATING
  state machine every serving process owns (state.py).
- `GenerationCheckpoint` / `GenerationPreempted`: the portable snapshot a
  draining engine hands each live request, so that a healthy replica
  resumes it with no token lost or repeated (checkpoint.py).

The JAX package's aiohttp middleware has no module here: the port's REST
server runs the admission gate, the readiness override and the
/admin/drain routes itself (protocol/rest/server.py).
"""

from .checkpoint import (  # noqa: F401
    CHECKPOINT_FIELD_SIZE_LIMIT,
    CHECKPOINT_HEADER,
    CHECKPOINT_HEADER_MAX_BYTES,
    CHECKPOINT_HEADER_SAFE_BYTES,
    GenerationCheckpoint,
    GenerationPreempted,
)
from .state import (  # noqa: F401
    DEFAULT_DRAIN_GRACE_S,
    DRAIN_GRACE_ENV,
    DRAINING,
    READY,
    STARTING,
    STATES,
    TERMINATING,
    ReplicaDrainingError,
    ReplicaLifecycle,
    drain_grace_from_env,
    normalize_drain_grace,
)
