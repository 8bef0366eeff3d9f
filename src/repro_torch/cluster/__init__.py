"""Threaded parameter-server cluster runtime.

Executes the *same* ``Algorithm`` (init/send/receive) triples as the
discrete-event engine (``repro_torch.core.engine``) with real
concurrency: worker threads race a master thread through a bounded
gradient mailbox.  Three modes:

* ``deterministic`` — a virtual clock replays the engine's exact event
  order, so the run is cross-validated bit for bit against
  ``run_simulation`` (the simulator stays the reference semantics).
* ``paced``         — workers free-run but sleep gamma-model execution
  times (simulation-fidelity wall-clock mode).
* ``free``          — workers push as fast as they can (throughput mode).

The master supports *coalesced receive* (apply k queued messages in one
launch of the CUDA kernel ``flat_update_batch``; the legacy per-message
``dana_update`` kernel on request) and a fault-injection layer (stalls,
dropout/rejoin, message reordering).  ``ClusterConfig(shards=S)``
splits the master into S row-range shard servers
(``cluster/sharded.py``), threads on one card; workers push each
gradient once and every shard consumes only its rows.  The process
backend is not ported yet (ROADMAP.md item A5).
"""
from .faults import FaultInjector, FaultPlan
from .mailbox import FanoutMailbox, GradMsg, Mailbox, Reply
from .master import Master
from .runtime import ClusterConfig, run_cluster
from .sharded import ShardedMaster
from .worker import TurnGate, Worker

__all__ = [
    "ClusterConfig", "run_cluster", "Master", "ShardedMaster", "Worker",
    "Mailbox", "FanoutMailbox", "GradMsg", "Reply", "FaultPlan",
    "FaultInjector", "TurnGate",
]
