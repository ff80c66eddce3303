"""Tier-1 gate of the port: ``estorch_tpu_torch/`` is clean under its own
esguard (``estorch_tpu_torch/analysis/``) and config.

The counterpart of ``tests/test_analysis_clean.py``, which gates the JAX
package through ``run_lint.sh``'s config; the port's gate is this file,
with the port's own baseline and ratchet (``estorch_tpu_torch/analysis/
esguard_baseline.json``, ``esguard_ratchet.json``).  Five things fail it:
a new unsuppressed finding, a stale baseline entry (the bug it suppressed
was fixed — delete the entry), a baseline entry with no reason, a ratchet
mismatch on the R18–R22 lockset family, and a file of the port that does
not compile.  It also holds R11's repair: ``AsyncSaveHandle.wait`` never
waits without end.
"""

from __future__ import annotations

import compileall
import functools
import os
import threading
import time

import pytest

from estorch_tpu_torch.analysis import (Baseline, all_rules, analyze_paths, check_ratchet,
                                        load_baseline, load_config, load_ratchet,
                                        sort_findings)

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@functools.lru_cache(maxsize=1)
def _run_port_analysis():
    cfg = load_config()
    rules = [r for r in all_rules() if r.id in cfg.rule_ids([r.id for r in all_rules()])]
    cwd = os.getcwd()
    os.chdir(REPO_ROOT)  # findings and exclude globs are repo-relative
    try:
        findings = analyze_paths(["estorch_tpu_torch"], rules=rules, exclude=cfg.exclude)
    finally:
        os.chdir(cwd)
    baseline = load_baseline(cfg.baseline_path())
    return cfg, baseline, findings, baseline.apply(sort_findings(findings))


def test_port_is_esguard_clean():
    _, _, _, res = _run_port_analysis()
    report = "\n".join(f.render() for f in res.unsuppressed)
    assert not res.unsuppressed, (
        "esguard found new findings in estorch_tpu_torch/ (fix them or baseline WITH a "
        f"reason in estorch_tpu_torch/analysis/esguard_baseline.json):\n{report}")


def test_port_baseline_has_no_stale_entries():
    _, _, _, res = _run_port_analysis()
    stale = "\n".join(f"{e.rule} {e.file} [{e.symbol}] `{e.snippet}`" for e in res.stale)
    assert not res.stale, f"baseline entries whose finding no longer exists:\n{stale}"


def test_port_baseline_entries_are_justified():
    _, baseline, _, _ = _run_port_analysis()
    assert isinstance(baseline, Baseline) and baseline.entries
    unjust = baseline.unjustified()
    assert not unjust, "baseline entries need a `reason`: " + ", ".join(
        f"{e.rule}:{e.file}" for e in unjust)


def test_port_ratchet_matches_current_counts():
    cfg, _, findings, _ = _run_port_analysis()
    assert os.path.exists(cfg.ratchet_path())
    recorded = load_ratchet(cfg.ratchet_path())
    assert sorted(recorded) == ["R18", "R19", "R20", "R21", "R22"]
    check = check_ratchet(recorded, findings)
    assert check.ok(), f"regressions={check.regressions} stale={check.stale}"


def test_checkpoint_writer_wait_is_bounded():
    """R11 at ``utils/checkpoint.py``'s ``AsyncSaveHandle.wait`` is fixed,
    not baselined: a finding of it would fail the gate above."""
    _, baseline, findings, _ = _run_port_analysis()
    assert not [f for f in findings if f.rule == "R11"]
    assert not [e for e in baseline.entries if e.rule == "R11"]


def test_port_compiles(tmp_path):
    assert compileall.compile_dir(os.path.join(REPO_ROOT, "estorch_tpu_torch"), quiet=1,
                                  force=True, legacy=False,
                                  ddir=str(tmp_path / "estorch_tpu_torch"))


def test_wedged_checkpoint_writer_is_a_timeout(tmp_path, monkeypatch):
    """A writer blocked on an Event: ``wait(timeout_s=0.5)`` raises a
    ``TimeoutError`` naming the checkpoint within 2 s; released, the
    writer finishes and ``wait`` returns."""
    from estorch_tpu_torch.utils import checkpoint as ckpt

    release = threading.Event()

    class Wedged:
        def synchronize(self):
            release.wait(30)

    committed = []
    monkeypatch.setattr(ckpt, "_commit_payload", lambda tree, p: committed.append(p))
    path = str(tmp_path / "gen_00000001")
    handle = ckpt.AsyncSaveHandle({}, Wedged(), [], path)
    try:
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError, match="gen_00000001"):
            handle.wait(timeout_s=0.5)
        assert time.perf_counter() - t0 < 2.0
    finally:
        release.set()
    handle.wait(timeout_s=10.0)
    assert committed == [path]
