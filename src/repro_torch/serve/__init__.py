"""repro_torch.serve — the long-lived partition-plan service.

The batch pipeline (`repro_torch.core.planner`) plans one graph per call; this
package turns it into a serving system for recurring workloads:

  * `PlanService` — batched request API over a **content-addressed plan
    cache**: requests are fingerprinted over (graph/trace content,
    planning knobs), hits return the persisted (partition, mapping,
    cost) bundle from memory or disk (`checkpoint.store`), misses plan
    cold exactly once.
  * `IncrementalPlanner` — **incremental repartitioning**: new trace
    windows stream into a resumable `ShardCutState` in round quanta and
    only dirty replica-CSR rows are re-finalized; the warm result is
    bit-identical to a cold cut over the concatenated trace.
  * `python -m repro_torch.serve` — CLI front end (plan / batch / cache /
    metrics).

Fingerprints, the cache layout and bundles are the JAX package's: the
same request gives the same fingerprint, and a cache directory written
by either package is read by the other.  Cold plans run on the card by
default (`backend="cuda"`, `device="cuda"`); the greedy stream stays on
the host engine.
"""

from .cache import PlanBundle, PlanCache
from .fingerprint import plan_fingerprint
from .incremental import (DEFAULT_QUANTUM, INCREMENTAL_METHODS,
                          IncrementalPlanner)
from .service import (DEFAULT_CACHE_DIR, PlanRequest, PlanResponse,
                      PlanService)

__all__ = [
    "DEFAULT_CACHE_DIR",
    "DEFAULT_QUANTUM",
    "INCREMENTAL_METHODS",
    "IncrementalPlanner",
    "PlanBundle",
    "PlanCache",
    "PlanRequest",
    "PlanResponse",
    "PlanService",
    "plan_fingerprint",
]
