"""The param-sharded ES engine: no leaf whole on one rank.

Counterpart of ``estorch_tpu/parallel/sharded.py`` ("Evolution Strategies
at the Hyperscale", PAPERS.md), on a 2-D ``(pop, model)`` mesh of ranks
(``parallel/mesh.py`` :class:`HyperscaleMesh`, one rank a process, ROADMAP
F21).  The JAX package writes one global-view program and lets GSPMD
partition it; torch has no GSPMD, so the partition is explicit here:

- **State.**  Each rank holds its shards of every leaf, per the regex
  partition rules (:func:`~estorch_tpu_torch.parallel.mesh.
  match_partition_rules`), as one local flat vector (each leaf's shard
  row-major, leaves in ravel order), and the optimizer's moments of that
  vector: the optimizers are elementwise, so the step on the local vector
  is the step on the whole one.  ``seed``, ``generation`` and ``sigma`` are
  replicated.  :attr:`ShardedESState.params_flat` gathers, a collective.
- **Noise.**  ``noise_mode="program"`` generates ε where it is used,
  addressed by element (``ops/noise.py`` ``program_noise``): a rank
  draws exactly its shard, and every mesh shape draws the same bits; with
  ``low_rank`` the 2-D leaves where factoring saves draw factors A, B and
  the update contracts them, no dense E formed.  ``noise_mode="table"``
  slices each leaf's window of the classic table, the rank's elements only:
  the replicated engine's ε, the parity mode.
- **Forward.**  Explicit tensor parallelism over the model group of the
  bundled feedforward policies (``MLPPolicy`` and ``NatureCNN``, each with
  or without VBN): the module's own :class:`~estorch_tpu_torch.models.
  policies.Layer` sequence, each layer run by the same ``layer_linear`` /
  ``layer_post`` as the replicated forward, on this rank's part.  A kernel
  split on its output channels (a dense kernel's columns, a conv kernel's
  HWIO output channels) is column-parallel: the rank runs its channels,
  their VBN (the frozen statistics are per channel) and activation, then
  one disjoint-channel sum over the model group gathers them.  One split
  on its input channels sums partial products, then the bias, VBN and
  activation run whole; a whole kernel runs whole on every rank.  A split
  per-channel vector (bias, VBN scale or bias) that a layer needs whole is
  gathered once a chunk.  Every model rank of a pop group steps the same
  env states with the same gathered actions, so their fitness is
  bit-identical.  Any other module raises (README, "The sharded
  forward").
- **Update.**  A rank's float64 partial Σ w·ε over its pop block's rows,
  one sum over the pop group, one rounding, the division by
  population·σ (as world 1 rounds, ROADMAP F22).  ``grad_norm`` sums the
  squares of the sharded leaves over the model group and counts the
  replicated ones once; ``update_finite`` is the AND over the model group.
- **Rollback.**  A rejected generation (non-finite update, or fewer than two
  valid members) returns the input state, the same generation, on every
  rank; the metrics carry this rank's shard of the generation's best
  member (``best_theta``).

The population layout is the JAX engine's: members ghost-padded to a
multiple of the pop shards, a pop shard's members in ``eval_chunk``-sized
chunks, noise rows clamped (a ghost's weight is 0).  The draws (offsets,
initial states) are the whole population's, from the generation's CPU
generator on every rank, as the replicated engine draws them.  Nothing is
compiled ahead of time, and no throw-away generation runs.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..envs.rollout import make_batched_rollout
from ..models.policies import conv_kernel_layout, flatten_nhwc, layer_linear, layer_post
from ..obs.spans import NULL_TELEMETRY
from ..ops.gradient import fold_mirrored_weights
from ..ops.lowrank import dense_kernel, lowrank_factors_save, lowrank_program_factors
from ..ops.noise import (
    NoiseTable,
    leaf_noise_keys,
    program_noise,
    sample_pair_offsets,
)
from ..ops.params import ParamSpec
from ..ops.ranks import centered_rank_safe
from ..resilience.chaos import poison_update
from .engine import EngineConfig, Sample, _choose_eval_chunk, generation_seed
from .mesh import (
    DEFAULT_PARTITION_RULES,
    MODEL_AXIS,
    POP_AXIS,
    HyperscaleMesh,
    match_partition_rules,
    padded_count,
    sharding_summary,
)

NOISE_MODES = ("program", "table")
# noise is generated or gathered at most this many elements at a time (one
# noise row at least), so the generator's int64 and float64 temporaries stay
# a few MB each: a rank's peak memory is its shards', not its noise's
NOISE_BLOCK_ELEMENTS = 1 << 19
# the module families whose forward the sharded engine partitions
SHARDED_FAMILIES = "MLPPolicy and NatureCNN, each with or without VBN"


class _LayerPlan(NamedTuple):
    """How a rank runs one layer: ``mode`` "whole", "column" (its output
    channels [lo, hi)) or "row" (its input channels [lo, hi), partial
    sums); ``channels`` the layer's output channels; ``vectors`` the leaf
    indices of its bias, then its VBN bias and scale."""

    mode: str
    lo: int
    hi: int
    channels: int
    vectors: tuple


class ShardedESState(NamedTuple):
    """Training state of one rank: its shards of the params and of the
    optimizer state.  ``layout`` is the engine's :class:`ShardLayout`."""

    params_local: torch.Tensor  # (local_dim,) float32: this rank's shards, ravel order
    opt_state: Any  # the optimizer's state of params_local
    seed: int  # with ``generation``, keys the generation's draws and noise
    generation: int
    sigma: torch.Tensor  # () float32, replicated
    layout: Any = None

    @property
    def params_flat(self) -> torch.Tensor:
        """The gathered (dim,) center in ``ParamSpec``'s layout.  A
        collective over the model group: **every rank must read it**, or the
        ranks hang (``ES``'s records, checkpoints and manifests read it on
        every rank before the leader writes)."""
        return self.layout.gather(self.params_local)

    @property
    def params(self) -> dict:
        """This rank's shards as a param dict of views (local shapes)."""
        return self.layout.tree(self.params_local)


class _Leaf(NamedTuple):
    path: tuple
    shape: tuple
    size: int
    flat_offset: int  # in the (dim,) vector
    spec: Any  # the resolved P
    shard_dim: int | None  # the dim split over the model axis, or None
    lo: int  # this rank's first index along shard_dim
    local_shape: tuple
    local_size: int
    local_offset: int  # in the (local_dim,) vector
    elements: torch.Tensor  # (local_size,) int64: row-major indices into the leaf


class ShardLayout:
    """Which elements of each leaf this rank holds, and the gather."""

    def __init__(self, spec: ParamSpec, specs: list, mesh: HyperscaleMesh, device):
        self.spec = spec
        self.mesh = mesh
        self.device = torch.device(device)
        m, mi = mesh.model_shards, mesh.model_index
        leaves, pos = [], 0
        for path, shape, off, sp in zip(spec.paths, spec.shapes, spec.offsets, specs):
            size = math.prod(shape) if shape else 1
            dims = [d for d, a in enumerate(sp) if a is not None]
            for d in dims:
                names = sp[d] if isinstance(sp[d], tuple) else (sp[d],)
                if any(n != MODEL_AXIS for n in names):
                    raise ValueError(
                        f"leaf '{'/'.join(map(str, path))}' is sharded over {sp[d]!r}; the "
                        f"port's sharded engine splits leaves over {MODEL_AXIS!r} only")
            if len(dims) > 1:
                raise ValueError(f"leaf '{'/'.join(map(str, path))}' is sharded along "
                                 f"{len(dims)} dims ({sp}); one axis shards one dim")
            idx = torch.arange(size, dtype=torch.int64).view(shape if shape else (1,))
            shard_dim, lo, local_shape = None, 0, tuple(shape)
            if dims and m > 1:
                shard_dim = dims[0]
                count = shape[shard_dim] // m
                lo = mi * count
                idx = idx.narrow(shard_dim, lo, count)
                local_shape = tuple(count if d == shard_dim else s for d, s in enumerate(shape))
            local_size = math.prod(local_shape) if local_shape else 1
            leaves.append(_Leaf(path, tuple(shape), size, off, sp, shard_dim, lo, local_shape,
                                local_size, pos, idx.reshape(-1).to(self.device)))
            pos += local_size
        self.leaves = leaves
        self.dim = spec.dim
        self.local_dim = pos
        sharded = torch.zeros(pos, dtype=torch.bool)
        for lf in leaves:
            if lf.shard_dim is not None:
                sharded[lf.local_offset:lf.local_offset + lf.local_size] = True
        self.sharded_mask = sharded.to(self.device)
        # the gather: sharded leaves from every model rank, replicated ones
        # from model rank 0 only, each written once into a zero buffer
        src, dst = [], []
        for lf in leaves:
            if lf.shard_dim is None and mi != 0:
                continue
            src.append(torch.arange(lf.local_offset, lf.local_offset + lf.local_size))
            dst.append(lf.elements.cpu() + lf.flat_offset)
        self._gather_src = torch.cat(src).to(self.device) if src else None
        self._gather_dst = torch.cat(dst).to(self.device) if dst else None

    def scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's (local_dim,) part of a (dim,) vector (no collective)."""
        if self.mesh.model_shards == 1:
            return flat.clone()
        return torch.cat([flat[lf.flat_offset:lf.flat_offset + lf.size][lf.elements]
                          for lf in self.leaves])

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The (dim,) vector from every model rank's (local_dim,) part: one
        disjoint-slice sum over the gather group (exact, but a -0.0 turns
        +0.0).  A collective: every rank of the model group calls it."""
        if self.mesh.model_shards == 1:
            return local
        buf = torch.zeros((self.dim,), dtype=local.dtype, device=local.device)
        if self._gather_dst is not None:
            buf.index_copy_(0, self._gather_dst, local[self._gather_src])
        return self.mesh.all_reduce_gather(buf)

    def tree(self, local: torch.Tensor) -> dict:
        """A param dict of views into ``local`` (…, local_dim), local shapes."""
        lead = tuple(local.shape[:-1])
        out: dict = {}
        for lf in self.leaves:
            node = out
            for k in lf.path[:-1]:
                node = node.setdefault(k, {})
            node[lf.path[-1]] = local[..., lf.local_offset:lf.local_offset + lf.local_size].view(
                lead + lf.local_shape)
        return out


class ShardedESEngine:
    """Param-sharded twin of :class:`~estorch_tpu_torch.parallel.engine.
    ESEngine`: the same ``generation_step(state) -> (state, metrics)``
    protocol (``fitness``, ``bc``, ``steps``, ``grad_norm``, ``n_valid``,
    ``update_finite``, ``sigma``, ``best_theta``), so ``ES.train`` drives it.

    ``noise_source`` (None: the port's program stream) replaces program
    noise: ``noise_source(generation, leaf, rows, elements, factor)`` →
    ``(len(rows), len(elements))`` float32, ``factor`` None for a dense
    leaf, 0 or 1 for a low-rank leaf's A or B (tests hand in JAX's draws).
    """

    telemetry = NULL_TELEMETRY

    def __init__(self, env: Any, module: Any, spec: ParamSpec, table: NoiseTable | None,
                 optimizer: Any, config: EngineConfig, mesh: HyperscaleMesh,
                 partition_rules=None, noise_mode: str = "program"):
        for flag in ("decomposed", "streamed", "noise_kernel", "obs_norm"):
            if getattr(config, flag):
                raise ValueError(
                    f"{flag} is a replicated-engine option; the sharded "
                    "path's noise/state layout replaces it (docs/sharding.md)")
        if config.compute_dtype != "float32":
            raise ValueError(
                "the sharded engine runs in float32 (the parity contract "
                "vs the replicated path is stated at f32)")
        if config.episodes_per_member != 1:
            raise ValueError("episodes_per_member is a replicated-engine option for now")
        if env is None:
            raise ValueError(
                "the sharded engine fuses eval+update on-chip; it has no "
                "update-only mode (use ESEngine for the pooled path)")
        if noise_mode not in NOISE_MODES:
            raise ValueError(f"noise_mode must be one of {NOISE_MODES}, got {noise_mode!r}")
        if noise_mode == "table":
            if table is None:
                raise ValueError("noise_mode='table' needs a NoiseTable")
            if config.low_rank:
                raise ValueError(
                    "low_rank noise is generated in-program on the sharded "
                    "path (noise_mode='program'); the table packs full-rank "
                    "rows only")
        missing = {POP_AXIS, MODEL_AXIS} - set(getattr(mesh, "axis_names", ()))
        if missing:
            raise ValueError(
                f"sharded engine needs a ({POP_AXIS!r}, {MODEL_AXIS!r}) "
                f"mesh (parallel/mesh.py::hyperscale_mesh); {getattr(mesh, 'axis_names', ())} "
                f"is missing {sorted(missing)}")
        if getattr(module, "is_recurrent", False) or not hasattr(module, "layers"):
            raise ValueError(
                f"the port's sharded forward partitions the bundled feedforward policies "
                f"({SHARDED_FAMILIES}) layer by layer; {type(module).__name__} is not one of "
                "them (JAX's GSPMD partitions any module; README.md, 'The sharded forward')")
        if config.mirrored and config.population_size % 2:
            raise ValueError(
                f"mirrored sampling needs an even population, got {config.population_size}")
        self.env = env
        self.module = module
        self.spec = spec
        self.table = table
        self.optimizer = optimizer
        self.config = config
        self.mesh = mesh
        self.device = mesh.device
        self.noise_mode = noise_mode
        self.noise_source = None
        self.pop_shards = mesh.pop_shards

        # ---- partition rules -> this rank's layout ----
        self.partition_rules = tuple(partition_rules if partition_rules is not None
                                     else DEFAULT_PARTITION_RULES)
        self._shape_tree = spec.unravel(torch.empty((spec.dim,), device="meta"))
        spec_tree = match_partition_rules(self.partition_rules, self._shape_tree, mesh)
        leaf_specs = []
        for path in spec.paths:
            node = spec_tree
            for k in path:
                node = node[k]
            leaf_specs.append(node)
        self._spec_tree = spec_tree
        self.layout = ShardLayout(spec, leaf_specs, mesh, self.device)
        self._by_path = {lf.path: i for i, lf in enumerate(self.layout.leaves)}
        self._layers = module.layers()
        self._plans = [self._layer_plan(layer) for layer in self._layers]

        # low_rank: which leaves draw factored noise, by the ops/lowrank.py rule
        self._factored: dict[int, tuple[int, int]] = {}
        if config.low_rank:
            for i, lf in enumerate(self.layout.leaves):
                if len(lf.shape) == 2 and lowrank_factors_save(config.low_rank, *lf.shape):
                    self._factored[i] = lf.shape
        self._factor_rows = {i: self._factor_elements(i) for i in self._factored}

        # ---- population layout (ghost-padded like the JAX engine) ----
        cfg = config
        self.rows_global = cfg.population_size // 2 if cfg.mirrored else cfg.population_size
        self.members_padded = padded_count(cfg.population_size, self.pop_shards)
        self.members_per_shard = self.members_padded // self.pop_shards
        req = max(1, cfg.eval_chunk // self.pop_shards) if cfg.eval_chunk > 0 else 0
        self.chunk_per_shard = _choose_eval_chunk(req, self.members_per_shard)
        self.rows_padded = padded_count(self.rows_global, self.pop_shards)
        self.rows_per_shard = self.rows_padded // self.pop_shards
        greq = max(1, cfg.grad_chunk // self.pop_shards) if cfg.grad_chunk > 0 else 0
        self.gchunk_per_shard = _choose_eval_chunk(greq, self.rows_per_shard)

        self._rollout = make_batched_rollout(env, cfg.horizon)
        self._eval_rollouts: dict[bool, Any] = {}

    # ------------------------------------------------------------ layout

    def _leaf(self, layer: str, name: str) -> int:
        return self._by_path[(layer, name)]

    def _layer_plan(self, layer) -> _LayerPlan:
        """How this rank runs ``layer``: whole, column-parallel (its output
        channels [lo, hi)) or by partial sums (its input channels [lo,
        hi)), from the kernel's split; anything else raises, naming the
        layer."""
        kl = self.layout.leaves[self._leaf(layer.name, "kernel")]
        out_dim, in_dim = len(kl.shape) - 1, len(kl.shape) - 2
        vectors = [self._leaf(layer.name, "bias")]
        if layer.vbn is not None:
            vectors += [self._leaf(layer.vbn, "bias"), self._leaf(layer.vbn, "scale")]
        if kl.shard_dim is None:
            return _LayerPlan("whole", 0, kl.shape[out_dim], kl.shape[out_dim], tuple(vectors))
        lo, count = kl.lo, kl.local_shape[kl.shard_dim]
        if kl.shard_dim == out_dim:
            return _LayerPlan("column", lo, lo + count, kl.shape[out_dim], tuple(vectors))
        if kl.shard_dim == in_dim:
            return _LayerPlan("row", lo, lo + count, kl.shape[out_dim], tuple(vectors))
        raise ValueError(
            f"layer '{layer.name}': its kernel {kl.shape} is split along dim {kl.shard_dim} "
            f"({kl.spec}); the sharded forward splits a kernel's output channels (dim "
            f"{out_dim}) or its input channels (dim {in_dim})")

    def _factor_elements(self, i: int):
        """(A's, B's) local element indices of a factored (m, n) leaf: all of
        a factor, or the rows of the sharded dim's factor."""
        lf = self.layout.leaves[i]
        (m, n), r = lf.shape, int(self.config.low_rank)

        def rows_of(count, lo, full):
            idx = torch.arange(full * r, dtype=torch.int64).view(full, r)
            return idx.narrow(0, lo, count).reshape(-1).to(self.device)

        return (rows_of(lf.local_shape[0], lf.lo if lf.shard_dim == 0 else 0, m),
                rows_of(lf.local_shape[1], lf.lo if lf.shard_dim == 1 else 0, n))

    # ------------------------------------------------------------- state

    def init_state(self, params_flat: torch.Tensor, seed: int) -> ShardedESState:
        """The state before generation 0: this rank's shards of
        ``params_flat`` and the optimizer's state of them."""
        if tuple(params_flat.shape) != (self.spec.dim,):
            raise ValueError(f"params_flat must be ({self.spec.dim},), got "
                             f"{tuple(params_flat.shape)}")
        params_flat = params_flat.to(self.device, torch.float32)
        if not bool(torch.isfinite(params_flat).all()):
            raise ValueError("initial params contain non-finite values")
        local = self.layout.scatter(params_flat)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        return ShardedESState(
            params_local=local, opt_state=self.optimizer.init(local), seed=int(seed),
            generation=0,
            sigma=torch.tensor(self.config.sigma, dtype=torch.float32, device=self.device),
            layout=self.layout)

    def sample(self, state: ShardedESState) -> Sample:
        """The whole population's draws of this generation: the table
        offsets (table mode; None in program mode), then the rows' initial
        states, from the generation's CPU generator, as the replicated
        engine draws them."""
        gen = torch.Generator().manual_seed(generation_seed(state.seed, state.generation))
        offsets = None
        if self.noise_mode == "table":
            offsets = sample_pair_offsets(gen, self.rows_global, self.table.size, self.spec.dim)
        states, _ = self.env.reset(gen, self.rows_global)
        return Sample(offsets, states)

    # ------------------------------------------------------------- noise

    def _member_rows_signs(self, ids: torch.Tensor):
        if self.config.mirrored:
            rows = torch.clamp(ids // 2, max=self.rows_global - 1)
            signs = torch.where(ids % 2 == 0, 1.0, -1.0)
        else:
            rows = torch.clamp(ids, max=self.rows_global - 1)
            signs = torch.ones(ids.shape)
        return rows, signs.to(torch.float32)

    def _program(self, draws: dict, i: int, rows: torch.Tensor, elements: torch.Tensor,
                 factor: int | None = None) -> torch.Tensor:
        """Leaf ``i``'s program noise (``factor``: of its factor A or B), or
        the draws of ``noise_source`` when one is set."""
        if self.noise_source is not None:
            return self.noise_source(draws["generation"], i, rows, elements, factor).to(
                self.device, torch.float32)
        return program_noise(draws["keys"][i], rows, elements)

    def _dense_noise(self, i: int, rows: torch.Tensor, draws: dict) -> torch.Tensor:
        """(k, local_size) ε of leaf ``i`` for noise rows ``rows`` (CPU)."""
        lf = self.layout.leaves[i]
        if self.noise_mode == "table":
            size = self.table.size
            starts = draws["offsets"][rows].to(torch.int64) + lf.flat_offset
            # out-of-range starts follow dynamic_slice on the leaf's window
            starts = torch.where(starts < 0, starts + size, starts).clamp(0, size - lf.size)
            idx = starts.to(self.device)[:, None] + lf.elements[None, :]
            return self.table.data[idx]
        if i in self._factored:
            a, b = self._factors(i, rows, draws)
            return dense_kernel(int(self.config.low_rank), a, b).reshape(rows.shape[0], -1)
        step = max(1, NOISE_BLOCK_ELEMENTS // lf.local_size)
        return torch.cat([self._program(draws, i, rows[j:j + step], lf.elements)
                          for j in range(0, rows.shape[0], step)])

    def _factors(self, i: int, rows: torch.Tensor, draws: dict):
        """Leaf ``i``'s local factors: A (k, m_local, r), B (k, n_local, r)."""
        r = int(self.config.low_rank)
        a_el, b_el = self._factor_rows[i]
        if self.noise_source is None:
            return lowrank_program_factors(r, draws["keys"][i], rows, a_el, b_el)
        k = rows.shape[0]
        return (self._program(draws, i, rows, a_el, 0).view(k, -1, r),
                self._program(draws, i, rows, b_el, 1).view(k, -1, r))

    def _member_noise(self, i: int, rows: torch.Tensor, draws: dict) -> torch.Tensor:
        """(k, local_size) for members whose noise rows are ``rows``
        (sorted; a mirrored pair's two members share theirs, drawn once)."""
        urows, inv = torch.unique_consecutive(rows, return_inverse=True)
        eps = self._dense_noise(i, urows, draws)
        return eps if urows.shape[0] == rows.shape[0] else eps[inv.to(self.device)]

    def _draws(self, state: ShardedESState, sample: Sample | None) -> dict:
        sample = self.sample(state) if sample is None else sample
        keys = (None if self.noise_mode == "table"
                else leaf_noise_keys(state.seed, state.generation, len(self.layout.leaves)))
        offsets = None if sample.offsets is None else sample.offsets.cpu()
        return {"offsets": offsets, "states": sample.states, "keys": keys,
                "generation": int(state.generation)}

    # ------------------------------------------------------------ forward

    def _channel_vector(self, members: dict, i: int, plan: _LayerPlan) -> torch.Tensor:
        """Per-channel leaf ``i`` (bias, VBN scale or bias) of the k members
        as the layer runs it on this rank: (k, hi − lo) for a column-parallel
        layer, else whole (k, C).  A split leaf not matching that range is
        gathered (a collective over the model group, once a chunk)."""
        lf = self.layout.leaves[i]
        v = members[lf.path[0]][lf.path[1]]
        lo, hi = (plan.lo, plan.hi) if plan.mode == "column" else (0, plan.channels)
        if lf.shard_dim is None:
            return v[:, lo:hi]
        if plan.mode == "column" and lf.local_size == hi - lo:
            return v
        full = v.new_zeros((v.shape[0], lf.size))
        full[:, lf.lo:lf.lo + lf.local_size] = v
        return self.mesh.all_reduce_model(full)[:, lo:hi]

    def _sharded_apply(self, members: dict):
        """``apply(obs (k, *obs_shape)) -> (k, out)`` of k members whose
        local leaves are ``members`` (leaves (k, *local_shape)): the
        module's layers in order, each on this rank's part (the module
        docstring's forward).  The weights are laid out and any per-channel
        vector a layer needs whole gathered here, once a chunk; a partitioned
        layer gathers its activations once a call."""
        mod = self.module
        mesh = self.mesh
        stats = mod.vbn_stats
        prepared = []
        for layer, plan in zip(self._layers, self._plans):
            kernel = members[layer.name]["kernel"]
            if layer.kind == "conv":
                kernel = conv_kernel_layout(kernel)
            bias, *vbn_vectors = (self._channel_vector(members, i, plan) for i in plan.vectors)
            bias = bias[:, :, None] if layer.kind == "conv" else bias[:, None, :]
            params, layer_stats = {}, None
            if layer.vbn is not None:  # (k, 1, C) and (C,), this rank's channels
                params[layer.vbn] = {"bias": vbn_vectors[0][:, None, :],
                                     "scale": vbn_vectors[1][:, None, :]}
                lo, hi = (plan.lo, plan.hi) if plan.mode == "column" else (0, plan.channels)
                layer_stats = {layer.vbn: {k: v[lo:hi] for k, v in stats[layer.vbn].items()}}
            prepared.append((kernel, bias, params, layer_stats))

        def run(layer, plan, prep, x):
            kernel, bias, params, layer_stats = prep
            if plan.mode == "whole":
                return layer_post(layer, layer_linear(layer, x, kernel, bias), params,
                                  layer_stats)
            if plan.mode == "row":  # this rank's input channels; partial sums
                if layer.kind == "dense" and x.ndim == 5:
                    x = flatten_nhwc(x)
                axis = 2 if layer.kind == "conv" else x.ndim - 1
                part = layer_linear(layer, x.narrow(axis, plan.lo, plan.hi - plan.lo), kernel,
                                    bias if mesh.model_index == 0 else None)
                return layer_post(layer, mesh.all_reduce_model(part), params, layer_stats)
            # column-parallel: this rank's output channels, then gathered
            y = layer_post(layer, layer_linear(layer, x, kernel, bias), params, layer_stats)
            axis = layer.channel_axis % y.ndim
            shape = y.shape[:axis] + (plan.channels,) + y.shape[axis + 1:]
            buf = y.new_zeros(shape)
            buf.narrow(axis, plan.lo, plan.hi - plan.lo).copy_(y)
            return mesh.all_reduce_model(buf)

        def apply(obs: torch.Tensor) -> torch.Tensor:
            n = obs.shape[0]
            x = mod.population_input(obs, n)
            for layer, plan, prep in zip(self._layers, self._plans, prepared):
                x = run(layer, plan, prep, x)
            return mod.population_output(x).reshape(n, -1)

        return apply

    def _perturbed(self, state: ShardedESState, rows: torch.Tensor, signs: torch.Tensor,
                   draws: dict) -> torch.Tensor:
        """(k, local_dim) local θ of k members: each leaf's shard + σ·s·ε,
        written leaf by leaf into one buffer."""
        c = (state.sigma * signs.to(self.device))[:, None]
        theta = torch.empty((rows.shape[0], self.layout.local_dim), dtype=torch.float32,
                            device=self.device)
        for i, lf in enumerate(self.layout.leaves):
            sl = slice(lf.local_offset, lf.local_offset + lf.local_size)
            theta[:, sl] = self._member_noise(i, rows, draws)
            theta[:, sl].mul_(c).add_(state.params_local[sl])
        return theta

    # ------------------------------------------------------------- eval

    def _evaluate(self, state: ShardedESState, draws: dict):
        """The population's fitness (n,), BC (n, bc_dim) and alive steps,
        this pop shard's members rolled out chunk by chunk, then gathered
        over the pop group."""
        cfg = self.config
        first = self.mesh.pop_index * self.members_per_shard
        states = draws["states"]
        fits, bcs, steps = [], [], []
        for lo in range(0, self.members_per_shard, self.chunk_per_shard):
            ids = torch.arange(first + lo, first + lo + self.chunk_per_shard)
            rows, signs = self._member_rows_signs(ids)
            theta = self._perturbed(state, rows, signs, draws)
            apply = self._sharded_apply(self.layout.tree(theta))
            states0 = states[rows].to(self.device)
            res = self._rollout(apply, states0, self.env.observe(states0))
            fits.append(res.total_reward)
            bcs.append(res.bc)
            steps.append(res.steps)
        fitness, bc, st = torch.cat(fits), torch.cat(bcs), torch.cat(steps)
        alive = torch.arange(first, first + self.members_per_shard,
                             device=self.device) < cfg.population_size
        st = torch.where(alive, st.to(torch.int64), 0)
        if self.pop_shards == 1:
            n = cfg.population_size
            return fitness[:n], bc[:n], st.sum()
        cols = torch.cat([fitness[:, None].double(), bc.double(), st[:, None].double()], dim=1)
        buf = cols.new_zeros((self.members_padded, cols.shape[1]))
        buf[first:first + self.members_per_shard] = cols
        packed = self.mesh.all_reduce_pop(buf)[:cfg.population_size]
        return (packed[:, 0].float(), packed[:, 1:1 + bc.shape[1]].float(),
                packed[:, -1].sum().to(torch.int64))

    # ------------------------------------------------------------- update

    def _update_direction(self, state: ShardedESState, draws: dict,
                          weights: torch.Tensor) -> torch.Tensor:
        """(local_dim,) float32 ascent direction: this pop shard's float64
        Σ w·ε over its rows, summed over the pop group, rounded once and
        divided by population·σ."""
        cfg = self.config
        row_w = fold_mirrored_weights(weights) if cfg.mirrored else weights
        row_w = row_w.double()
        pad = self.rows_padded - self.rows_global
        if pad:
            row_w = torch.cat([row_w, row_w.new_zeros((pad,))])
        first = self.mesh.pop_index * self.rows_per_shard
        acc = torch.zeros((self.layout.local_dim,), dtype=torch.float64, device=self.device)
        r = int(cfg.low_rank)
        for lo in range(0, self.rows_per_shard, self.gchunk_per_shard):
            rows = torch.clamp(torch.arange(first + lo, first + lo + self.gchunk_per_shard),
                               max=self.rows_global - 1)
            w = row_w[first + lo:first + lo + self.gchunk_per_shard]
            for i, lf in enumerate(self.layout.leaves):
                sl = slice(lf.local_offset, lf.local_offset + lf.local_size)
                if i in self._factored:
                    a, b = self._factors(i, rows, draws)
                    contrib = torch.einsum("kmr,knr->mn", a.double() * w[:, None, None],
                                           b.double()) / math.sqrt(r)
                    acc[sl] += contrib.reshape(-1)
                    continue
                step = max(1, NOISE_BLOCK_ELEMENTS // lf.local_size)
                for j in range(0, rows.shape[0], step):
                    eps = self._dense_noise(i, rows[j:j + step], draws)
                    acc[sl] += w[j:j + step] @ eps.double()
        acc = self.mesh.all_reduce_pop(acc)
        return acc.to(torch.float32) / (cfg.population_size * state.sigma)

    # ------------------------------------------------------------- step

    def generation_step(self, state: ShardedESState, sample: Sample | None = None):
        """One sharded generation: ``(new_state, metrics)``.  A rejected
        generation returns ``state`` itself (same generation) on every rank.
        ``sample`` replaces the draws (tests hand in the JAX package's)."""
        cfg = self.config
        draws = self._draws(state, sample)
        fitness, bc, steps = self._evaluate(state, draws)
        weights, n_valid = centered_rank_safe(fitness)
        grad = self._update_direction(state, draws, weights)
        if cfg.weight_decay > 0.0:
            grad = grad - cfg.weight_decay * state.params_local
        if poison_update(state.generation):
            grad = torch.full_like(grad, float("nan"))
        updates, new_opt_state = self.optimizer.update(-grad, state.opt_state)
        new_params = state.params_local + updates
        # one model-group sum: the sharded leaves' squares, and the count of
        # non-finite params (any rank's poisons every rank's generation)
        sq = grad.double().square()
        shared = torch.stack([sq[self.layout.sharded_mask].sum(),
                              (~torch.isfinite(new_params)).sum().double()])
        shared = self.mesh.all_reduce_model(shared)
        gnorm = torch.sqrt(shared[0] + sq[~self.layout.sharded_mask].sum()).to(torch.float32)
        update_finite = torch.logical_and(torch.isfinite(gnorm), shared[1] == 0)
        new_sigma = state.sigma
        if cfg.sigma_decay != 1.0:
            new_sigma = torch.clamp(state.sigma * cfg.sigma_decay, min=cfg.sigma_min)
        ok = bool(update_finite) and int(n_valid) >= 2
        new_state = state
        if ok:
            new_state = ShardedESState(new_params, new_opt_state, state.seed,
                                       state.generation + 1, new_sigma, self.layout)
        safe = torch.where(torch.isfinite(fitness), fitness, float("-inf"))
        best = torch.tensor([int(torch.argmax(safe))])
        rows, signs = self._member_rows_signs(best)
        metrics = {
            "fitness": fitness,
            "bc": bc,
            "steps": steps,
            "grad_norm": gnorm,
            "n_valid": n_valid,
            "update_finite": update_finite,
            "sigma": state.sigma,  # the σ this generation sampled under
            "best_theta": self._perturbed(state, rows, signs, draws)[0],
        }
        return new_state, metrics

    # ---------------------------------------------------------- inspection

    def member_params(self, state: ShardedESState, member_index: int,
                      sample: Sample | None = None) -> torch.Tensor:
        """One member's gathered (dim,) θ, rebuilt from the same noise
        functions as the evaluation.  A collective: every rank calls it."""
        draws = self._draws(state, sample)
        rows, signs = self._member_rows_signs(torch.tensor([int(member_index)]))
        return self.layout.gather(self._perturbed(state, rows, signs, draws)[0])

    @torch.no_grad()
    def evaluate_episodes(self, state: ShardedESState, states0: torch.Tensor,
                          params_flat: torch.Tensor | None = None,
                          with_env_metrics: bool = False):
        """One episode from each row of ``states0`` of the policy at
        ``params_flat`` (the gathered center by default: a collective), the
        whole policy on this rank — an inspection API, as ``ES.
        evaluate_policy`` uses it."""
        key = bool(with_env_metrics)
        if key not in self._eval_rollouts:
            self._eval_rollouts[key] = make_batched_rollout(
                self.env, self.config.horizon, with_env_metrics=key)
        flat = state.params_flat if params_flat is None else params_flat
        params = self.spec.unravel(flat.to(self.device, torch.float32))
        states0 = states0.to(self.device)

        def apply(obs):
            return self.module.apply_params(params, obs.to(torch.float32))

        return self._eval_rollouts[key](apply, states0, self.env.observe(states0))

    def sharding_report(self) -> dict[str, str]:
        """``{leaf path: resolved spec}``: what the rules did, divisibility
        fallbacks included."""
        return sharding_summary(self._shape_tree, self._spec_tree)

    def memory_facts(self, state: ShardedESState | None = None) -> dict:
        """This rank's bytes: its params and optimizer state (exact counts)
        and, on a card, ``torch.cuda.max_memory_allocated`` since
        :meth:`init_state` (the eval chunk's perturbed shards and
        activations included)."""
        out = {"local_dim": self.layout.local_dim, "dim": self.spec.dim,
               "param_bytes": 4 * self.layout.local_dim}
        if state is not None:
            out["opt_state_bytes"] = _tensor_bytes(state.opt_state)
        if self.device.type == "cuda":
            out["max_allocated_bytes"] = int(torch.cuda.max_memory_allocated(self.device))
        return out


def _tensor_bytes(tree: Any) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def clone_state(state: ShardedESState) -> ShardedESState:
    """A copy of this rank's shards and optimizer state (a snapshot that no
    later generation shares)."""

    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(copy(v) for v in x))
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        return x

    return state._replace(params_local=state.params_local.clone(),
                          opt_state=copy(state.opt_state), sigma=state.sigma.clone())

