"""Versioned policy bundles — the deployable artifact of a training run.

Counterpart of ``estorch_tpu/serve/bundle.py``, with its on-disk contract.
A bundle is a self-describing directory that carries everything needed to
serve a trained policy in a FRESH process, with a bit-exactness contract:
``Bundle.predict(obs)`` equals the exporting run's ``ES.predict(obs)`` on
the same device.  Contents:

- ``arrays.npz``   — ``params_flat`` (the center or best-member vector, in
                     the layout both packages share, ``ops/params.py``),
                     every frozen collection's leaves (``frozen.vbn_stats.i``,
                     keys sorted as ``ravel_pytree`` sorts them), and the
                     running obs-normalization triple (``obs_stats.count``,
                     ``.mean``, ``.m2``) when the run trained with
                     ``obs_norm``;
- ``MANIFEST.json``— schema + bundle version, the module import spec
                     (``"pkg.mod:Class"`` + JSON kwargs) that rebuilds the
                     policy, obs shape, provenance (algorithm, backend,
                     generation, best reward, and the scenario
                     distribution's spec when the run trained under one),
                     the runtime facts a
                     regression hunt needs (git sha, torch/CUDA/numpy
                     versions, the card: ``obs/manifest.py``), and the
                     sha256 of ``arrays.npz``.

The module spec: the JAX package reads a flax module's dataclass fields.
The port's policies are ``nn.Module``s that keep each constructor argument
as an attribute of the same name, so the spec is the constructor's
parameters read back from the instance, those at their default omitted,
the rest encoded under the JAX package's rules (JSON scalars and lists,
callables as round-tripping import paths); ``module_import=`` /
``module_kwargs=`` are the escape for a class that does not.

Write protocol (the checkpoint lesson, utils/checkpoint.py): payload
first, ``MANIFEST.json`` LAST via atomic rename — the manifest IS the
commit point.  A crash at any earlier moment leaves a directory
``load_bundle`` rejects as uncommitted, never a loadable-looking bundle
with a half-written payload.  Re-exporting over an existing bundle
deletes the manifest first (decommit) for the same reason.

Host-backend policies (the user's own torch module) are not bundleable:
``export_bundle`` says so instead of writing an artifact the server cannot
run.  ``load_bundle`` puts the bundle on ``cuda`` unless the caller asks
for the CPU.
"""

from __future__ import annotations

import importlib
import inspect
import json
import os
import time

import numpy as np
import torch

from ..envs.rollout import episode_carry

from .validate import (ARRAYS_NAME, BUNDLE_SCHEMA, MANIFEST_NAME, BundleError,
                       _sha256_file, validate_bundle)

# --------------------------------------------------------------------- util

def _resolve_import(spec: str):
    """``"pkg.mod:attr"`` → the attribute (class/function)."""
    mod, _, attr = spec.partition(":")
    if not attr:
        raise BundleError(f"import spec {spec!r} must be 'module:attr'")
    try:
        obj = importlib.import_module(mod)
    except ImportError as e:
        raise BundleError(
            f"bundle module {spec!r} is not importable in this process: {e}"
        ) from e
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _import_path(obj) -> str:
    mod = getattr(obj, "__module__", None)
    qual = getattr(obj, "__qualname__", None)
    if not mod or not qual or "<locals>" in qual:
        raise BundleError(
            f"{obj!r} has no stable import path — bundles must reference "
            "module-level classes/functions so a fresh serving process can "
            "import them"
        )
    if mod == "__main__":
        raise BundleError(
            f"{obj!r} is defined in __main__ — move it to an importable "
            "module (the serving process cannot import your script's "
            "__main__) or pass module_import/module_kwargs explicitly"
        )
    return f"{mod}:{qual}"


_JSON_SCALARS = (bool, int, float, str, type(None))


def _encode_field(name: str, v):
    """A module constructor argument's value → JSON, or raise with guidance."""
    if isinstance(v, _JSON_SCALARS):
        return v
    if isinstance(v, (tuple, list)):
        out = []
        for x in v:
            if not isinstance(x, _JSON_SCALARS):
                raise BundleError(
                    f"module field {name!r} contains non-JSON element {x!r}; "
                    "pass module_kwargs explicitly to export_bundle"
                )
            out.append(x)
        return out
    if callable(v):
        path = _import_path(v)
        if _resolve_import(path) is not v:
            raise BundleError(
                f"module field {name!r}={v!r} does not round-trip through "
                f"its import path {path!r}; pass module_kwargs explicitly"
            )
        return {"__callable__": path}
    raise BundleError(
        f"module field {name!r}={v!r} is not JSON-serializable; pass "
        "module_kwargs explicitly to export_bundle"
    )


def _decode_field(v):
    if isinstance(v, dict) and "__callable__" in v:
        return _resolve_import(v["__callable__"])
    return v


def _eq_default(v, default) -> bool:
    try:
        return bool(v == default)
    except Exception:  # exotic __eq__: treat as non-default, encode it
        pass
    return False


def _module_spec(module) -> tuple[str, dict]:
    """(import path, JSON kwargs) that reconstruct a policy module.

    Each parameter of the class's constructor is read back from the
    instance's attribute of the same name; those at their default are
    omitted (the class reconstructs them, including non-serializable
    defaults like activation callables), the rest must encode to JSON.
    """
    cls = type(module)
    path = _import_path(cls)
    if _resolve_import(path) is not cls:
        raise BundleError(
            f"policy class {cls.__name__} does not round-trip through its "
            f"import path {path!r}; pass module_import/module_kwargs "
            "explicitly"
        )
    kwargs = {}
    for name, p in inspect.signature(cls.__init__).parameters.items():
        if name == "self" or p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if not hasattr(module, name):
            raise BundleError(
                f"policy class {cls.__name__} keeps no attribute for its "
                f"constructor argument {name!r}; pass module_import/"
                "module_kwargs explicitly"
            )
        v = getattr(module, name)
        if p.default is not p.empty and (v is p.default or _eq_default(v, p.default)):
            continue
        kwargs[name] = _encode_field(name, v)
    return path, kwargs


def _collection_leaves(tree: dict) -> list[np.ndarray]:
    """A frozen collection's leaves as float32 numpy, keys sorted at every
    level (``ravel_pytree``'s order, ``ops/params.py``)."""
    from ..ops.params import make_param_spec

    flat, spec = make_param_spec(tree)
    flat = flat.detach().to("cpu", torch.float32).numpy()
    return [flat[off:off + int(np.prod(shape, dtype=np.int64))].reshape(shape)
            for off, shape in zip(spec.offsets, spec.shapes)]


def _host_f32(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t,
                      np.float32)


# ------------------------------------------------------------------- export

def export_bundle(
    es,
    path: str,
    *,
    use_best: bool = False,
    version: str | int | None = None,
    module_import: str | None = None,
    module_kwargs: dict | None = None,
    extra: dict | None = None,
    warm: bool = False,
    warm_max_batch: int = 32,
    serve_bf16: bool = False,
) -> str:
    """Export a trained ``ES`` (device/pooled backend) into a bundle dir.

    ``use_best`` exports the best-ever member snapshot instead of the
    current center.  ``version`` tags the artifact (default: the source
    generation).  ``module_import``/``module_kwargs`` override the
    automatic module spec for policies whose constructor arguments don't
    encode to JSON.  Returns the absolute bundle path.

    ``warm=True`` replays the serve-time load on the exporting device for a
    ``warm_max_batch`` bucket ladder and packs what it verified into the
    manifest's ``warm`` block (serve/warm.py): torch keeps no compiled
    programs to ship, so the block records the platform and the ladder.

    ``serve_bf16=True`` opts the bundle into the quantized serving fast
    path (manifest ``serve_dtypes``) — the exporter's assertion that
    accuracy-bounded bf16 answers are acceptable for this policy.  A
    server started with ``--dtype bf16`` refuses bundles that did not
    opt in.  Combined with ``warm=True`` the bf16 ladder is verified too,
    and a policy whose measured divergence exceeds the documented bound
    fails the export with the diagnosis instead of shipping a bundle
    every server will refuse.
    """
    if getattr(es, "backend", None) == "host":
        raise NotImplementedError(
            "host-backend (torch) policies are not bundleable — the serving "
            "stack serves the device and pooled backends' flat-param "
            "policies; use torch.save on es.policy.state_dict() for torch "
            "deployment"
        )
    if getattr(es, "module", None) is None:
        raise BundleError("this ES has no policy module to bundle")

    if use_best and es._best_flat is None:
        raise BundleError(
            "use_best=True but no best-member snapshot exists yet — "
            "train at least one generation first"
        )
    flat = _host_f32(es._best_flat if use_best else es.state.params_flat)

    if module_import is None:
        module_import, auto_kwargs = _module_spec(es.module)
        if module_kwargs is None:
            module_kwargs = auto_kwargs
    elif module_kwargs is None:
        module_kwargs = {}

    arrays: dict[str, np.ndarray] = {"params_flat": flat}
    frozen_meta: dict[str, int] = {}
    vbn_stats = getattr(es.module, "vbn_stats", None)
    if vbn_stats is not None:
        leaves = _collection_leaves(vbn_stats)
        frozen_meta["vbn_stats"] = len(leaves)
        for i, leaf in enumerate(leaves):
            arrays[f"frozen.vbn_stats.{i}"] = leaf

    obs_norm = bool(es.config.obs_norm)
    if obs_norm:
        cnt, mean, m2 = es.state.obs_stats
        arrays["obs_stats.count"] = _host_f32(cnt)
        arrays["obs_stats.mean"] = _host_f32(mean)
        arrays["obs_stats.m2"] = _host_f32(m2)

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    manifest_path = os.path.join(path, MANIFEST_NAME)
    if os.path.exists(manifest_path):
        # decommit BEFORE touching the payload: a reader racing this
        # re-export sees "uncommitted", never a manifest whose checksum
        # describes the previous payload
        os.remove(manifest_path)
    arrays_path = os.path.join(path, ARRAYS_NAME)
    with open(arrays_path, "wb") as f:
        np.savez(f, **arrays)

    from ..obs.manifest import collect_manifest

    obs_shape = es._obs_shape
    obs_shape = tuple(obs_shape) if isinstance(obs_shape, (tuple, list)) else (obs_shape,)
    manifest = {
        "schema": BUNDLE_SCHEMA,
        "created_unix": time.time(),
        "version": str(version if version is not None else es.generation),
        "module": {"import": module_import, "kwargs": module_kwargs},
        "obs_shape": [int(d) for d in obs_shape],
        "param_dim": int(flat.shape[0]),
        "recurrent": bool(getattr(es, "_recurrent", False)),
        "serve_dtypes": ["f32"] + (["bf16"] if serve_bf16 else []),
        "obs_norm": obs_norm,
        "obs_clip": float(es.config.obs_clip),
        "frozen": frozen_meta,
        "source": {
            "algorithm": type(es).__name__,
            "backend": es.backend,
            "generation": int(es.generation),
            "population_size": int(es.population_size),
            "sigma": float(es.sigma),
            "seed": int(es.seed),
            "best_reward": float(es.best_reward),
            "use_best": bool(use_best),
        },
        "runtime": collect_manifest(devices=[es.device]),
        "sha256": {ARRAYS_NAME: _sha256_file(arrays_path)},
    }
    if getattr(es, "_scenarios", None) is not None:
        # the bundle names the scenarios its policy was trained under: the
        # spec and its draw seed reproduce every variant's constants
        manifest["source"]["scenarios"] = es._scenarios.spec_json()
    if extra:
        manifest["extra"] = extra
    _commit_manifest(path, manifest)
    if warm:
        from .warm import warm_bundle

        # verify against the COMMITTED bundle (the replay loads it through
        # the real load path), then re-commit the manifest with the warm
        # block — a crash mid-warm leaves a valid cold bundle.  No decommit
        # here: nothing between the two commits mutates the payload, and
        # os.replace swaps atomically
        manifest["warm"] = warm_bundle(path, max_batch=warm_max_batch,
                                       dtypes=manifest["serve_dtypes"], device=es.device)
        _commit_manifest(path, manifest)
    return path


def _commit_manifest(path: str, manifest: dict) -> None:
    manifest_path = os.path.join(path, MANIFEST_NAME)
    tmp = manifest_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, default=float)
    os.replace(tmp, manifest_path)  # the commit point




# --------------------------------------------------------------------- load

class Bundle:
    """A loaded policy bundle: rebuilt module + parameters on ``device`` +
    the predict program, honoring the exporting run's predict contract."""

    def __init__(self, path: str, manifest: dict, module, params: dict, obs_stats,
                 device: torch.device):
        self.path = path
        self.manifest = manifest
        self.module = module  # holds the frozen collections (vbn_stats)
        self.params = params  # the param dict, views into the flat vector
        self.obs_stats = obs_stats  # (count, mean, m2) or None
        self.device = device
        self.version = manifest["version"]
        self.recurrent = bool(manifest.get("recurrent", False))
        self.obs_shape = tuple(manifest["obs_shape"])
        self.obs_clip = float(manifest.get("obs_clip", 5.0))
        self._obs_norm = bool(manifest.get("obs_norm", False))
        # dtypes the EXPORTER opted this policy into serving with
        self.serve_dtypes = tuple(manifest.get("serve_dtypes") or ("f32",))
        # the export's warm facts (serve/warm.py) — None on cold bundles;
        # how they compare with this process is recorded by load_bundle
        self.warm_info = manifest.get("warm")
        self.warm_status: dict | None = None
        self._params_cast: dict = {}
        from .predictor import make_single_predict

        self._predict_fn = make_single_predict(
            module.apply_params, recurrent=self.recurrent,
            obs_norm=self._obs_norm, obs_clip=self.obs_clip,
        )

    # ---------------------------------------------------------- predict

    def predict(self, obs, carry=None):
        """Forward pass, bit-equal to the exporting run's ``ES.predict`` on
        the same device.  Recurrent bundles return ``(out, new_carry)``;
        ``carry=None`` starts an episode."""
        from .predictor import as_obs

        obs = as_obs(obs, self.device)
        if self.recurrent:
            if carry is None:
                carry = episode_carry(self.module, self.params, self.device)
            return self._predict_fn(self.params, self.obs_stats, obs, carry)
        return self._predict_fn(self.params, self.obs_stats, obs)

    def _params_for(self, dtype: str) -> dict:
        """Param dict for a serving dtype — the quantized cast happens ONCE
        here (the engine's once-per-member discipline), never inside the
        forward."""
        if dtype == "f32":
            return self.params
        if dtype not in self._params_cast:
            from ..ops.params import map_tree

            self._params_cast[dtype] = map_tree(lambda t: t.to(torch.bfloat16), self.params)
        return self._params_cast[dtype]

    def batched_predict_fn(self, dtype: str = "f32"):
        """``f(obs_batch (B, *obs_shape) np.ndarray) -> np.ndarray`` — the
        dynamic batcher's compute: the batch copied to the bundle's device,
        the policy's forward over it, the output copied back.  Stateless
        policies only (the server's contract).

        ``dtype="bf16"`` returns the quantized fast path (half the weight
        bytes read per batch) — refused with :class:`BundleError` unless
        the bundle opted in at export (``serve_dtypes``): quantized answers
        are an accuracy decision the exporter makes, never a silent
        server-side downgrade."""
        if self.recurrent:
            raise BundleError(
                "recurrent bundles cannot serve through the dynamic "
                "batcher — the hidden carry belongs to a session, and the "
                "batcher coalesces unrelated requests; use predict(obs, "
                "carry) in-process"
            )
        if dtype != "f32" and dtype not in self.serve_dtypes:
            raise BundleError(
                f"bundle at {self.path!r} did not opt into {dtype} "
                f"serving (serve_dtypes={list(self.serve_dtypes)}) — "
                "re-export with export_bundle(..., serve_bf16=True) to "
                "assert the quantized path is acceptable for this policy"
            )
        from .predictor import make_batched_predict

        fn = make_batched_predict(self.module.apply_params, obs_norm=self._obs_norm,
                                  obs_clip=self.obs_clip, dtype=dtype)
        params, stats, device = self._params_for(dtype), self.obs_stats, self.device

        def batch_predict(obs_batch: np.ndarray) -> np.ndarray:
            x = torch.from_numpy(np.ascontiguousarray(obs_batch, np.float32)).to(device)
            return fn(params, stats, x).cpu().numpy()

        return batch_predict


def _frozen_template(module, params: dict, coll: str, obs_shape: tuple) -> dict | None:
    """The structure of a frozen collection the rebuilt module defines
    (shapes only, as the JAX package's structure-only ``init``): the VBN
    statistics its forward captures on a zero batch."""
    if coll != "vbn_stats" or not getattr(module, "use_vbn", False):
        return None
    from ..models.vbn import capture_reference_stats

    return capture_reference_stats(module, params, torch.zeros((2,) + obs_shape))


def load_bundle(path: str, device=None) -> Bundle:
    """Validate + load a bundle onto ``device`` (``cuda`` unless the caller
    passes ``"cpu"``); raises :class:`BundleError` on any structural,
    checksum, or module-compatibility problem.

    ``bundle.warm_status`` records how the bundle's warm block
    (serve/warm.py) compares with this process; a mismatch is a finding
    there, never an error.  The JAX package's ``install_warm=`` has no
    counterpart: torch has no program cache to install into."""
    from ..ops.params import make_param_spec
    from ..utils.backend import resolve_device

    device = resolve_device(device)
    manifest = validate_bundle(path)
    path = os.path.abspath(path)

    from .warm import install_warmth

    warm_status = install_warmth(manifest, device)

    module_cls = _resolve_import(manifest["module"]["import"])
    kwargs = {k: _decode_field(v) for k, v in manifest["module"]["kwargs"].items()}
    try:
        module = module_cls(**kwargs)
    except TypeError as e:
        raise BundleError(
            f"policy class {manifest['module']['import']!r} rejected the "
            f"bundled kwargs {sorted(kwargs)}: {e} — the class signature "
            "changed since export"
        ) from e

    obs_shape = tuple(int(d) for d in manifest["obs_shape"])
    # structure-only init on the CPU: shapes depend on the obs shape and
    # the module config, never on the generator's draws
    template, spec = make_param_spec(module.init_params(obs_shape, torch.Generator().manual_seed(0)))
    if spec.dim != int(manifest["param_dim"]):
        raise BundleError(
            f"rebuilt module has {spec.dim} parameters but the bundle "
            f"carries {manifest['param_dim']} — the module definition "
            "changed since export"
        )

    with np.load(os.path.join(path, ARRAYS_NAME)) as z:
        arrays = {k: z[k] for k in z.files}

    def on_device(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    flat = on_device(arrays["params_flat"])
    module.set_params(flat, spec)
    params = spec.unravel(flat)

    for coll, n_leaves in (manifest.get("frozen") or {}).items():
        tmpl = _frozen_template(module, spec.unravel(template), coll, obs_shape)
        if tmpl is None:
            raise BundleError(
                f"bundle carries frozen collection {coll!r} but the rebuilt "
                "module does not define it — module definition drift"
            )
        _, fspec = make_param_spec(tmpl)
        if len(fspec.paths) != int(n_leaves):
            raise BundleError(
                f"frozen collection {coll!r}: module wants {len(fspec.paths)} "
                f"leaves, bundle has {n_leaves}"
            )
        leaves = [on_device(arrays[f"frozen.{coll}.{i}"]) for i in range(int(n_leaves))]
        for i, (leaf, shape) in enumerate(zip(leaves, fspec.shapes)):
            if tuple(leaf.shape) != shape:
                raise BundleError(
                    f"frozen collection {coll!r} leaf {i}: module wants shape {shape}, "
                    f"bundle has {tuple(leaf.shape)}")
        module.vbn_stats = fspec.unravel(torch.cat([leaf.reshape(-1) for leaf in leaves]))

    obs_stats = None
    if manifest.get("obs_norm"):
        obs_stats = tuple(on_device(arrays[f"obs_stats.{k}"]) for k in ("count", "mean", "m2"))

    bundle = Bundle(path, manifest, module, params, obs_stats, device)
    bundle.warm_status = warm_status
    return bundle
