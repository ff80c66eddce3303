"""Declarative SLO/alert rules over the fleet store.

``rules.json`` is the operator's contract with the fleet: instead of a
human eyeballing N dashboards, the collector evaluates every rule each
collection tick against STORED history and appends firing/resolved
transitions to an alerts ledger — the exact health/capacity/rollback
signal the future fleet router consumes (ROADMAP item 1: canary rollout
"gated on the tail").

Schema (``{"schema": 1, "rules": [...]}``); every rule has a unique
``name`` and a ``kind``:

* ``threshold`` — ``{"metric", "op": ">"|">="|"<"|"<=", "value",
  "for_s": 0, "window_s": 30}``: fires per target when the LATEST stored
  sample of ``metric`` satisfies the predicate continuously for
  ``for_s`` seconds (the classic queue-depth / shed-rate alert);
* ``absence`` — ``{"metric": "estorch_up", "for_s": 0, "window_s": 30}``:
  fires per target when the metric has NO sample in the window **or its
  latest value is 0** — one rule covers both ways a replica dies: the
  endpoint stops answering (no scrape lands) and the endpoint answers
  but reports itself down/stale (``estorch_up 0``, heartbeat-stale);
* ``burn_rate`` — ``{"metric", "quantile": 0.99, "slo_s", "windows":
  [{"window_s": 300, "burn": 1.0}, {"window_s": 30, "burn": 1.0}]}``:
  fires per target when the histogram-derived ``quantile`` over EVERY
  window exceeds ``slo_s × burn`` — the multi-window discipline: the
  long window proves the burn is significant, the short window proves it
  is STILL happening (so a resolved spike stops alerting as soon as the
  short window clears, while a single long window would page for
  minutes after recovery).

Targets are discovered from the store itself (the ``target`` label the
collector stamps on every sample), so a rule written once covers every
replica that ever reports — including ones added after the rules file
was authored.

State machine per (rule, target): ok → pending (condition true, clock
running) → firing (held ``for_s``) → ok again, with ``firing`` /
``resolved`` transitions appended to the ledger (JSONL, atomic append)
and exposed on the collector's ``/alerts``.  Transition messages NAME
the target and the metric/endpoint — an alert an operator must decode
is an alert that gets ignored.

Stdlib-only, file-loadable (the collector/dash wedge contract).
"""

from __future__ import annotations

import json
import os

RULES_SCHEMA = 1
LEDGER_FILENAME = "alerts.jsonl"
# the ledger compacts to this many most-recent transitions on append —
# every reader (seed_from_ledger, /alerts, the dash) uses tail<=500, and
# an unbounded ledger under a flapping rule would grow forever while
# each atomic append re-copies the whole file (O(n^2) cumulative)
LEDGER_MAX_TRANSITIONS = 2000

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


def validate_rules(obj) -> list[str]:
    """Structural problems of a parsed rules file ([] when clean)."""
    problems: list[str] = []
    if not isinstance(obj, dict) or obj.get("schema") != RULES_SCHEMA:
        return [f"rules file must be an object with schema={RULES_SCHEMA}"]
    rules = obj.get("rules")
    if not isinstance(rules, list):
        return ["rules must be a list"]
    seen: set[str] = set()
    for i, r in enumerate(rules):
        where = f"rules[{i}]"
        if not isinstance(r, dict):
            problems.append(f"{where}: not an object")
            continue
        name = r.get("name")
        if not name or not isinstance(name, str):
            problems.append(f"{where}: missing name")
        elif name in seen:
            problems.append(f"{where}: duplicate name {name!r}")
        else:
            seen.add(name)
        kind = r.get("kind")
        if kind not in ("threshold", "absence", "burn_rate"):
            problems.append(f"{where}: unknown kind {kind!r}")
            continue
        if not isinstance(r.get("metric"), str):
            problems.append(f"{where}: missing metric")
        if kind == "threshold":
            if r.get("op") not in _OPS:
                problems.append(f"{where}: op must be one of "
                                f"{sorted(_OPS)}")
            if not isinstance(r.get("value"), (int, float)):
                problems.append(f"{where}: missing numeric value")
        if kind == "burn_rate":
            if not isinstance(r.get("slo_s"), (int, float)) \
                    or r.get("slo_s", 0) <= 0:
                problems.append(f"{where}: slo_s must be > 0")
            q = r.get("quantile", 0.99)
            if not isinstance(q, (int, float)) or not 0.5 <= q < 1.0:
                problems.append(f"{where}: quantile must be in [0.5, 1)")
            wins = r.get("windows")
            if not isinstance(wins, list) or not wins or not all(
                    isinstance(w, dict)
                    and isinstance(w.get("window_s"), (int, float))
                    and w.get("window_s", 0) > 0 for w in wins):
                problems.append(f"{where}: windows must be a non-empty "
                                "list of {window_s[, burn]} objects")
    return problems


def load_rules(path: str) -> "RulesEngine":
    """Parse + validate a rules file; ValueError carries every problem
    on one line (a collector refusing to start must say exactly why)."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(f"{path}: unreadable rules file: {e}") from e
    problems = validate_rules(obj)
    if problems:
        raise ValueError(f"{path}: " + "; ".join(problems))
    return RulesEngine(obj["rules"])


class RulesEngine:
    """Evaluate rules against a store each tick; track alert states."""

    def __init__(self, rules: list[dict], *, ledger_path: str | None = None):
        self.rules = list(rules)
        self.ledger_path = ledger_path
        # (rule name, target) -> {"state", "since_ts", "detail"}
        self._states: dict[tuple[str, str], dict] = {}
        if ledger_path:
            self.seed_from_ledger()

    def seed_from_ledger(self, tail: int = LEDGER_MAX_TRANSITIONS) -> None:
        """Adopt still-firing alerts from the ledger as this engine's
        starting state.  Without this, a collector restart forgets a
        fired alert: if the condition cleared while the collector was
        down, no ``resolved`` is ever appended and the dash (which
        reconstructs active alerts from the ledger) shows a phantom
        firing forever; if it still holds, a duplicate ``firing`` is
        re-announced.  Seeded state makes the next evaluate() emit
        exactly the missing transition."""
        if not self.ledger_path:
            return
        known = {r["name"] for r in self.rules if isinstance(r, dict)}
        for t in read_ledger(self.ledger_path, tail=tail):
            rule, target = str(t.get("rule")), str(t.get("target"))
            key = (rule, target)
            if t.get("event") == "firing" and rule in known:
                self._states[key] = {
                    "state": "firing",
                    "since_ts": float(t.get("ts", 0.0)),
                    "detail": str(t.get("detail", "")),
                }
            elif t.get("event") == "resolved":
                self._states.pop(key, None)

    # -------------------------------------------------------- predicates

    def _condition(self, rule: dict, store, target: str, now: float
                   ) -> tuple[bool, str]:
        """(condition holds, human detail naming target + metric)."""
        metric = rule["metric"]
        labels = {"target": target}
        kind = rule["kind"]
        window_s = float(rule.get("window_s", 30.0))
        if kind == "threshold":
            latest = store.latest(metric, labels, window_s, now)
            if not latest:
                return False, f"no {metric} sample for {target!r}"
            _ts, _lab, v = max(latest.values(), key=lambda t: t[0])
            op, bound = rule["op"], float(rule["value"])
            return (_OPS[op](v, bound),
                    f"{metric}={v:g} {op} {bound:g} on target {target!r}")
        if kind == "absence":
            latest = store.latest(metric, labels, window_s, now)
            if not latest:
                return True, (f"{metric} absent for {window_s:g}s on "
                              f"target {target!r}")
            _ts, _lab, v = max(latest.values(), key=lambda t: t[0])
            return (v == 0.0,
                    f"{metric}={v:g} on target {target!r}")
        # burn_rate: every window's quantile must exceed slo*burn
        q = float(rule.get("quantile", 0.99))
        slo = float(rule["slo_s"])
        worst = None
        for w in rule["windows"]:
            win = float(w["window_s"])
            burn = float(w.get("burn", 1.0))
            got = store.quantile(metric, q, labels, win, now)
            if got is None or got <= slo * burn:
                return False, (f"p{q * 100:g} of {metric} within SLO "
                               f"{slo:g}s on target {target!r}")
            worst = max(worst or 0.0, got)
        return True, (f"p{q * 100:g} of {metric} = {worst:.6g}s breaches "
                      f"SLO {slo:g}s on target {target!r} across all "
                      f"{len(rule['windows'])} windows")

    # -------------------------------------------------------- evaluation

    def evaluate(self, store, targets: list[str], now: float) -> list[dict]:
        """One tick: run every rule against every target; returns the
        transitions (also appended to the ledger when one is configured)."""
        transitions: list[dict] = []
        for rule in self.rules:
            for_s = float(rule.get("for_s", 0.0))
            for target in targets:
                key = (rule["name"], target)
                st = self._states.get(key) or {"state": "ok",
                                               "since_ts": now}
                holds, detail = self._condition(rule, store, target, now)
                state = st["state"]
                if holds:
                    if state == "ok":
                        st = {"state": "pending", "since_ts": now,
                              "detail": detail}
                    if st["state"] == "pending" \
                            and now - st["since_ts"] >= for_s:
                        st = {"state": "firing", "since_ts": now,
                              "detail": detail}
                        transitions.append({
                            "ts": now, "event": "firing",
                            "rule": rule["name"], "kind": rule["kind"],
                            "target": target, "detail": detail,
                        })
                    elif st["state"] == "firing":
                        st["detail"] = detail  # keep the latest reading
                else:
                    if state == "firing":
                        transitions.append({
                            "ts": now, "event": "resolved",
                            "rule": rule["name"], "kind": rule["kind"],
                            "target": target, "detail": detail,
                        })
                    st = {"state": "ok", "since_ts": now}
                self._states[key] = st
        # a target removed from the configuration can never re-evaluate:
        # close its firing alerts instead of haunting /alerts and the
        # dash forever (and being re-adopted by every restart's seed)
        live = set(targets)
        for (rule_name, target), st in list(self._states.items()):
            if target in live:
                continue
            if st["state"] == "firing":
                transitions.append({
                    "ts": now, "event": "resolved", "rule": rule_name,
                    "kind": "removed", "target": target,
                    "detail": f"target {target!r} removed from the "
                              "collector's configuration",
                })
            del self._states[(rule_name, target)]
        if transitions and self.ledger_path:
            append_ledger(self.ledger_path, transitions)
        return transitions

    def active(self) -> list[dict]:
        """Currently-firing alerts, stable order."""
        out = []
        for (rule, target), st in sorted(self._states.items()):
            if st["state"] == "firing":
                out.append({"rule": rule, "target": target,
                            "since_ts": st["since_ts"],
                            "detail": st.get("detail", "")})
        return out


# ---------------------------------------------------------------- ledger

def append_ledger(path: str, transitions: list[dict],
                  max_transitions: int = LEDGER_MAX_TRANSITIONS) -> None:
    """Atomic append (copy + extend + rename, the FlightRecorder dump
    contract): a crash mid-append leaves the previous complete ledger or
    the new complete one, never a torn line for ``/alerts`` or the dash
    to choke on.  Compacts to the newest ``max_transitions`` lines so a
    flapping rule on a long-running collector cannot grow the ledger
    (and the cost of each atomic rewrite) without bound."""
    prev_lines: list[str] = []
    if os.path.exists(path):
        with open(path) as old:
            prev = old.read()
        if prev and not prev.endswith("\n"):
            cut = prev.rfind("\n")
            prev = prev[:cut + 1] if cut >= 0 else ""
        prev_lines = prev.splitlines()
    lines = prev_lines + [json.dumps(t, default=float)
                          for t in transitions]
    lines = lines[-int(max_transitions):]
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n" if lines else "")
    os.replace(tmp, path)


def read_ledger(path: str, tail: int = 100) -> list[dict]:
    """Last ``tail`` ledger transitions (torn/garbage lines skipped)."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return []
    out: list[dict] = []
    for ln in lines[-int(tail):]:
        try:
            row = json.loads(ln)
        except ValueError:
            continue
        if isinstance(row, dict):
            out.append(row)
    return out
