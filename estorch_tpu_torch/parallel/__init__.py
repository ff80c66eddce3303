"""estorch_tpu_torch.parallel — the generation engines and their layouts.
Counterpart of ``estorch_tpu.parallel``.

``ESEngine`` (engine.py) runs a generation on one device, or as one rank of
a data-parallel group over a ``PopulationMesh`` (mesh.py, multihost.py);
``PooledEngine`` (pooled.py) evaluates in host env pools; elastic.py joins
remote hosts to a coordinator that folds their populations
(``ES.train_elastic``).  ``ShardedESEngine`` (sharded.py) is the
param-sharded engine over a ``HyperscaleMesh`` (``hyperscale_mesh``,
``global_hyperscale_mesh``), its leaves split per the regex partition rules
(``DEFAULT_PARTITION_RULES``, ``match_partition_rules``).

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
    "DEFAULT_PARTITION_RULES": "mesh",
    "HyperscaleMesh": "mesh",
    "P": "mesh",
    "hyperscale_mesh": "mesh",
    "match_partition_rules": "mesh",
    "partition_rules_from_json": "mesh",
    "partition_rules_to_json": "mesh",
    "sharding_summary": "mesh",
    "ShardedESEngine": "sharded",
    "ShardedESState": "sharded",
    "global_hyperscale_mesh": "multihost",
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
_SUBMODULES = ("elastic", "engine", "mesh", "multihost", "pooled", "sharded")
__getattr__, __dir__ = lazy_names(__name__, globals(), _LAZY, _SUBMODULES)
