"""estorch_tpu_torch.parallel — the generation engines and their layouts.
Counterpart of ``estorch_tpu.parallel``.

``ESEngine`` (engine.py) runs a generation on one device, or as one rank of
a data-parallel group over a ``PopulationMesh`` (mesh.py, multihost.py);
``PooledEngine`` (pooled.py) evaluates in host env pools; elastic.py joins
remote hosts to a coordinator that folds their populations
(``ES.train_elastic``).  The param-sharded engine (``ShardedESEngine``,
``hyperscale_mesh``, the partition rules) is ROADMAP.md port item 7c.

Every name loads lazily (PEP 562): importing this package imports no
torch, so the elastic wire protocol and the sinks' leader election stay
stdlib at load.
"""

from __future__ import annotations

from .._lazy import lazy_names

_LAZY = {
    "EngineConfig": "engine",
    "ESEngine": "engine",
    "ESState": "engine",
    "EvalResult": "engine",
    "Sample": "engine",
    "generation_seed": "engine",
    "merge_obs_moments": "engine",
    "merge_obs_moments_np": "engine",
    "normalize_obs": "engine",
    "PooledEngine": "pooled",
    "PooledEvalResult": "pooled",
    "MODEL_AXIS": "mesh",
    "POP_AXIS": "mesh",
    "CollectiveError": "mesh",
    "PopulationMesh": "mesh",
    "padded_count": "mesh",
    "pairs_per_device": "mesh",
    "population_mesh": "mesh",
    "single_device_mesh": "mesh",
    "global_population_mesh": "multihost",
    "initialize_distributed": "multihost",
    "leader_only": "multihost",
    "process_info": "multihost",
    "ElasticCoordinator": "elastic",
    "HostWorker": "elastic",
    "es_from_spec": "elastic",
    "run_host_thread": "elastic",
}

__all__ = sorted(_LAZY)
_SUBMODULES = ("elastic", "engine", "mesh", "multihost", "pooled")
__getattr__, __dir__ = lazy_names(__name__, globals(), _LAZY, _SUBMODULES)
