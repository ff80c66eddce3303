"""The port's esguard (``estorch_tpu_torch/analysis/``) against the JAX
package's (``estorch_tpu/analysis/``), on the CPU.

- Every rule whose trigger is not JAX's is the JAX analyzer's, unchanged:
  over every multi-line source string of ``tests/test_analysis.py`` (its
  fixtures) and over the whole ``estorch_tpu/`` tree, both analyzers give
  the same findings (rule, file, line, col, severity, message, hint,
  symbol, snippet).
- The eight JAX-only rules (R01, R02, R03, R04, R07, R10, R14, R16) have
  torch forms under the same ids: each fires on its positive fixtures and
  stays silent on its negative ones.
- Both analyzers register the same rule ids, and the port's config is its
  own (never the repo's ``pyproject.toml``).
"""

from __future__ import annotations

import ast
import functools
import os
import textwrap
from pathlib import Path

import pytest

from estorch_tpu import analysis as jax_analysis
from estorch_tpu_torch import analysis as torch_analysis
from estorch_tpu_torch.analysis import config as torch_config

REPO = Path(__file__).resolve().parent.parent
TORCH_FORMS = ("R01", "R02", "R03", "R04", "R07", "R10", "R14", "R16")
SHARED = ("R05", "R06", "R08", "R09", "R11", "R12", "R13", "R15", "R17", "R18", "R19", "R20",
          "R21", "R22", "R23")


def _rules(mod, ids):
    return [r for r in mod.all_rules() if r.id in ids]


def _as_dicts(found) -> list[dict]:
    return sorted((f.to_dict() for f in found),
                  key=lambda d: (d["file"], d["line"], d["col"], d["rule"], d["message"]))


def _fixture_sources() -> list[str]:
    """Every multi-line string constant of ``tests/test_analysis.py``,
    dedented: the JAX analyzer's fixtures (and a few docstrings, which
    both analyzers must treat alike too)."""
    tree = ast.parse((REPO / "tests" / "test_analysis.py").read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "\n" in node.value.strip():
            out.append(textwrap.dedent(node.value))
    return out


FIXTURES = _fixture_sources()


def test_both_analyzers_register_the_same_rule_ids():
    assert [r.id for r in torch_analysis.all_rules()] == \
        [r.id for r in jax_analysis.all_rules()]
    assert set(TORCH_FORMS) | set(SHARED) == {r.id for r in torch_analysis.all_rules()}


@pytest.mark.parametrize("rule_id", SHARED)
def test_shared_rule_equals_jax_on_the_fixtures(rule_id):
    assert len(FIXTURES) > 100
    jrules, trules = _rules(jax_analysis, [rule_id]), _rules(torch_analysis, [rule_id])
    fired = 0
    for i, src in enumerate(FIXTURES):
        want = _as_dicts(jax_analysis.analyze_source("snippet.py", src, rules=jrules))
        got = _as_dicts(torch_analysis.analyze_source("snippet.py", src, rules=trules))
        assert got == want, f"fixture {i}:\n{src}"
        fired += bool(want)
    assert fired, f"no fixture fires {rule_id}: the comparison saw nothing"


@functools.lru_cache(maxsize=1)
def _jax_tree_findings():
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        want = _as_dicts(jax_analysis.analyze_paths(
            ["estorch_tpu"], rules=_rules(jax_analysis, SHARED), jobs=1))
        got = _as_dicts(torch_analysis.analyze_paths(
            ["estorch_tpu"], rules=_rules(torch_analysis, SHARED), jobs=1))
    finally:
        os.chdir(cwd)
    return want, got


def test_shared_rules_equal_jax_on_the_jax_package():
    want, got = _jax_tree_findings()
    assert want, "the JAX package has baselined findings of shared rules"
    assert got == want


# ------------------------------------------------- the eight torch forms

FIRING = {
    "R01": [
        """
        import torch

        def draw(n):
            return torch.randn(n)
        """,
        """
        import torch

        def init(t):
            t.normal_(0.0, 1.0)
        """,
        """
        import torch

        def setup(seed):
            torch.manual_seed(seed)
        """,
        """
        from torch import randint

        def pick(n):
            return randint(0, 10, (n,))
        """,
    ],
    "R02": [
        """
        import torch

        @torch.compile
        def step(x):
            return x.sum().item()
        """,
        """
        import torch

        def capture(g, static_in, static_out):
            with torch.cuda.graph(g):
                static_out.copy_(static_in * 2)
                torch.cuda.synchronize()
        """,
        """
        def rollout(env, act, states, horizon):
            for _ in range(horizon):
                states, done = env.step(states, act(states))
                if bool(done.all()):
                    break
            return states
        """,
        """
        import torch

        def train(fn, x):
            def body(y):
                return y.cpu()
            return torch.cuda.make_graphed_callables(body, (x,))
        """,
    ],
    "R03": [
        """
        import torch

        @torch.compile
        def step(x):
            print("step")
            return x * 2
        """,
        """
        import time
        import torch

        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * 2
                stamp = time.perf_counter()
            return y, stamp
        """,
        """
        import torch

        def make(stats):
            def step(x):
                stats["calls"] += 1
                return x * 2
            return torch.compile(step)
        """,
    ],
    "R04": [
        """
        def rollout_member(policy, obs):
            return policy(obs)
        """,
        """
        def serve_batch(module, params, obs):
            return module.apply_params(params, obs)
        """,
        """
        def evaluate(net, obs):
            return net.forward(obs)
        """,
    ],
    "R07": [
        """
        import time
        from estorch_tpu_torch.ops.noise_kernels import weighted_noise_sum

        def timed(table, offs, w, dim):
            t0 = time.perf_counter()
            out = weighted_noise_sum(table, offs, w, dim)
            return out, time.perf_counter() - t0
        """,
        """
        import time
        import torch

        def timed(n):
            t0 = time.perf_counter()
            x = torch.ones(n, device="cuda")
            dt = time.perf_counter() - t0
            return x, dt
        """,
        """
        import time

        def replay(graph):
            t0 = time.perf_counter()
            graph.replay()
            return time.perf_counter() - t0
        """,
    ],
    "R10": [
        """
        import numpy as np
        import torch

        def run(env, steps, device):
            bias = np.ones(64, np.float32)
            for _ in range(steps):
                env.step(torch.as_tensor(bias, device=device))
        """,
        """
        def run(obs_scale, batches):
            for x in batches:
                y = x * obs_scale.cuda()
        """,
        """
        def run(table, n, dev):
            i = 0
            while i < n:
                rows = table.to(dev)
                i += 1
        """,
    ],
    "R14": [
        """
        import torch

        def serve(requests, fn):
            for req in requests:
                f = torch.compile(fn)
                f(req)
        """,
        """
        class Handler:
            def do_POST(self):
                from torch.utils.cpp_extension import load
                load("ext", ["ext.cpp"])
        """,
        """
        from estorch_tpu_torch.ops import _build

        def each_call(xs):
            for x in xs:
                lib = _build.load_library()
        """,
    ],
    "R16": [
        """
        def evaluate_variants(engine, state, variants):
            out = []
            for variant in variants:
                out.append(engine.evaluate(state, variant))
            return out
        """,
        """
        import torch

        def per_variant(table, n):
            return [torch.full((n,), p, device="cuda") for p in table.scenarios]
        """,
        """
        def sweep(make_rollout_for, scenarios):
            for scenario in scenarios:
                params = scenario.params
                make_rollout_for(params)
        """,
    ],
}

SILENT = {
    "R01": """
        import torch

        def draw(n, gen):
            a = torch.randn(n, generator=gen)
            b = torch.empty(n).normal_(generator=gen)
            g = torch.Generator().manual_seed(3)
            return a + b + torch.rand(n, generator=g)
        """,
    "R02": """
        import torch

        def rollout(env, act, states, horizon):
            total = torch.zeros(states.shape[0])
            for _ in range(horizon):
                states, reward = env.step(states, act(states))
                total += reward
            return float(total.sum()), int(states.shape[0])

        @torch.compile
        def step(x, n):
            return x * float(n.shape[0])
        """,
    "R03": """
        import time
        import torch

        @torch.compile
        def step(x, scale):
            y = x * scale
            return y

        def timed(x):
            t0 = time.perf_counter()
            print(step(x, 2.0))
            return time.perf_counter() - t0
        """,
    "R04": """
        import torch

        @torch.no_grad()
        def rollout_member(policy, obs):
            def inner(o):
                return policy(o)
            return inner(obs)

        def predict(module, params, obs):
            with torch.inference_mode():
                return module.apply_params(params, obs)

        def update(policy, obs):
            return policy(obs)
        """,
    "R07": """
        import time
        import torch
        from estorch_tpu_torch.ops.noise_kernels import weighted_noise_sum

        def timed(table, offs, w, dim):
            t0 = time.perf_counter()
            out = weighted_noise_sum(table, offs, w, dim)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        def host_only(xs):
            t0 = time.perf_counter()
            s = sum(xs)
            return s, time.perf_counter() - t0

        def events(start, end, graph):
            t0 = time.perf_counter()
            graph.replay()
            ms = start.elapsed_time(end)
            return ms, time.perf_counter() - t0
        """,
    "R10": """
        import torch

        def run(pool, steps, device):
            bias = torch.ones(64, device=device)
            obs = pool.reset()
            for _ in range(steps):
                x = torch.as_tensor(obs, device=device)
                obs = pool.step(x + bias)
            for i in range(steps):
                t = torch.tensor([i], device=device)
                u = torch.as_tensor(obs, device="cpu")
        """,
    "R14": """
        import torch

        def build_server(fn):
            compiled = torch.compile(fn)
            for _ in range(3):
                compiled = torch.compile(fn)
            return compiled

        def serve(requests, compiled):
            for req in requests:
                compiled(req)
        """,
    "R16": """
        import torch

        def draw_table(dist, n_variants, seed):
            rows = []
            for variant in range(n_variants):
                g = torch.Generator().manual_seed(seed + variant)
                rows.append(torch.rand(dist.dim, generator=g))
            return torch.stack(rows)

        def run(engine, state, variants):
            table = torch.stack([v.row for v in variants])
            return engine.evaluate(state, table)
        """,
}


def _torch_findings(src: str, rule_id: str):
    return [f for f in torch_analysis.analyze_source(
        "snippet.py", textwrap.dedent(src), rules=_rules(torch_analysis, [rule_id]))
        if f.rule == rule_id]


@pytest.mark.parametrize("rule_id,i", [(r, i) for r in TORCH_FORMS
                                       for i in range(len(FIRING[r]))])
def test_torch_form_fires(rule_id, i):
    found = _torch_findings(FIRING[rule_id][i], rule_id)
    assert found, f"{rule_id} fixture {i} did not fire"
    assert all(f.message and f.hint for f in found)


@pytest.mark.parametrize("rule_id", TORCH_FORMS)
def test_torch_form_silent(rule_id):
    assert not _torch_findings(SILENT[rule_id], rule_id), \
        [f.render() for f in _torch_findings(SILENT[rule_id], rule_id)]


@pytest.mark.parametrize("rule_id", [r for r in TORCH_FORMS if r != "R16"])
def test_torch_form_is_silent_on_jax_code(rule_id):
    """The torch forms read torch constructs, not JAX's: the JAX fixtures'
    ``jax.random``/``jax.jit`` code fires none of them.  (R16 is left out
    on purpose: JAX's fix, an already-jitted rollout called once per
    variant, is a rollout launched per variant in the port.)"""
    for src in FIXTURES:
        if "torch" in src:
            continue
        found = [f for f in torch_analysis.analyze_source(
            "snippet.py", src, rules=_rules(torch_analysis, [rule_id])) if f.rule == rule_id]
        assert not found, [f.render() for f in found]


def test_rule_docs_name_the_port():
    """Each torch form's registered description and module docstring say
    what it checks in the port, not JAX's construct."""
    for r in _rules(torch_analysis, TORCH_FORMS):
        assert "jax" not in r.description.lower(), r.id
        assert any(w in r.description for w in ("torch", "card", "device", "rollout",
                                                "serving")), r.id
        doc = (r.check.__module__, r.check.__doc__ or "")
        assert "estorch_tpu_torch.analysis" in doc[0]


def test_port_config_is_its_own():
    cfg = torch_analysis.load_config()
    assert cfg.root == torch_config.PACKAGE_DIR
    assert Path(cfg.baseline_path()).name == "esguard_baseline.json"
    assert Path(cfg.baseline_path()).parent == REPO / "estorch_tpu_torch" / "analysis"
    assert Path(cfg.ratchet_path()).parent == REPO / "estorch_tpu_torch" / "analysis"
    assert cfg.exclude == ["estorch_tpu_torch/native/*"]
    assert cfg.rule_ids([r.id for r in torch_analysis.all_rules()]) == \
        [r.id for r in torch_analysis.all_rules()]
    # an explicit file is read as a [tool.esguard] table
    jax_cfg = torch_analysis.load_config(str(REPO / "pyproject.toml"))
    assert jax_cfg.baseline == "esguard_baseline.json" and jax_cfg.root == str(REPO)
