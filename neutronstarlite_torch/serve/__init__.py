"""serve/ — online GNN inference serving, port of ``neutronstarlite_tpu/serve``.

A checkpoint is restored in eval mode and a ladder of shape-bucketed
forward executables is built once (engine.py: one captured CUDA graph per
bucket on the card), per-node requests coalesce in a deadline/size
micro-batching queue with explicit overload shedding (batcher.py),
fresh-node fan-outs reuse the training sampler with an LRU inference
embedding cache on top (sampling.py), and every serving event is a typed
obs/ record (server.py). fleet.py runs SERVE_REPLICAS SLO-routed replicas
(least-burn with hysteresis, drain-on-breach, fleet-shed only on
all-breach, heartbeat-supervised restart) behind one submit(); SERVE_CB
adds continuous batching; delta.py applies live graph deltas between
flushes.

Entry points (the CUDA card by default, ``--device cpu`` for the CPU):
  python -m neutronstarlite_torch.serve.server <cfg> [<ckpt_dir>]
  python -m neutronstarlite_torch.tools.serve_bench <cfg> [<ckpt_dir>] [--train]
      [--replicas N] [--cb 0|1] [--delta-rate R] ...

crosshost.py runs replicas as separate processes behind an HTTP router
(spawned, supervised and rolled one at a time behind a canary, or
discovered from NTS_FLEET_TARGETS):
  python -m neutronstarlite_torch.tools.serve_router <cfg> <ckpt> [--replicas N]
      [--rollout CKPT] [--device cpu]
  python -m neutronstarlite_torch.tools.serve_bench --targets host:port,... [--trace]
"""

import importlib

# lazy re-exports: importing the package (or its light modules — batcher,
# sampling) must not build the engine's imports
_EXPORTS = {
    "MicroBatcher": "batcher",
    "RequestShedError": "batcher",
    "ServeOptions": "batcher",
    "ServeRequest": "batcher",
    "latency_percentiles": "batcher",
    "DeltaPlan": "delta",
    "GraphDelta": "delta",
    "plan_delta": "delta",
    "InferenceEngine": "engine",
    "ServeSetupError": "engine",
    "EmbeddingCache": "sampling",
    "ServeSampler": "sampling",
    "InferenceServer": "server",
    "FleetOptions": "fleet",
    "Replica": "fleet",
    "ReplicaSet": "fleet",
    "choose_replica": "fleet",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(
        importlib.import_module(f"neutronstarlite_torch.serve.{mod}"), name
    )
