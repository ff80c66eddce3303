"""esguard configuration for the port: its own, kept in the package.

By default the port's analyzer runs with :func:`package_config`: every
registered rule, ``estorch_tpu_torch/native/*`` excluded, and the
baseline and ratchet files that sit beside this module
(``esguard_baseline.json``, ``esguard_ratchet.json``).  It never reads
the repo's ``pyproject.toml``, whose ``[tool.esguard]`` table points at
the JAX package's baseline.  A config file given explicitly
(``--config``) is read as a ``[tool.esguard]`` table through a tiny
TOML-SUBSET reader (Python 3.10 has no ``tomllib``): one ``[tool.esguard]``
table of ``key = value`` pairs where value is a string, bool, int, or a
(possibly multi-line) array of strings.  That subset is the whole config
language on purpose — if the config ever needs more TOML than this, it
should become Python, not grow a parser.

Recognized keys::

    [tool.esguard]
    enable   = ["R01", "R02"]   # default: all registered rules
    disable  = ["R04"]          # subtracted after `enable`
    baseline = "esguard_baseline.json"
    ratchet  = "esguard_ratchet.json"   # per-rule shrink-only counts
    exclude  = ["*_pb2.py", "build/*"]  # glob per file path / basename
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field


@dataclass
class EsguardConfig:
    enable: list[str] | None = None  # None -> all rules
    disable: list[str] = field(default_factory=list)
    baseline: str | None = None
    ratchet: str | None = None
    exclude: list[str] = field(default_factory=list)
    root: str = "."  # directory the config file lives in

    def baseline_path(self) -> str | None:
        if self.baseline is None:
            return None
        return os.path.join(self.root, self.baseline)

    def ratchet_path(self) -> str | None:
        if self.ratchet is None:
            return None
        return os.path.join(self.root, self.ratchet)

    def rule_ids(self, all_ids: list[str]) -> list[str]:
        ids = list(all_ids) if self.enable is None else [
            i for i in all_ids if i in self.enable]
        return [i for i in ids if i not in self.disable]


_SECTION_RE = re.compile(r"^\s*\[(?P<name>[^\]]+)\]\s*$")
_KV_RE = re.compile(r"^\s*(?P<key>[A-Za-z0-9_-]+)\s*=\s*(?P<val>.+)$")


def _strip_comment(line: str) -> str:
    out, in_str, quote = [], False, ""
    for ch in line:
        if in_str:
            out.append(ch)
            if ch == quote:
                in_str = False
        elif ch in ("'", '"'):
            in_str, quote = True, ch
            out.append(ch)
        elif ch == "#":
            break
        else:
            out.append(ch)
    return "".join(out).strip()


def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith("["):
        items = re.findall(r"""["']([^"']*)["']""", raw)
        return list(items)
    if raw in ("true", "false"):
        return raw == "true"
    if (raw.startswith('"') and raw.endswith('"')) or (
            raw.startswith("'") and raw.endswith("'")):
        return raw[1:-1]
    try:
        return int(raw)
    except ValueError:
        return raw


def parse_esguard_table(text: str) -> dict:
    """The `[tool.esguard]` table as a dict (TOML subset, see module doc)."""
    table: dict = {}
    in_section = False
    pending_key: str | None = None
    pending_val: list[str] = []
    for line in text.splitlines():
        stripped = _strip_comment(line)
        if not stripped:
            continue
        m = _SECTION_RE.match(stripped)
        if m:
            in_section = m.group("name").strip() == "tool.esguard"
            pending_key = None
            continue
        if not in_section:
            continue
        if pending_key is not None:
            pending_val.append(stripped)
            if stripped.endswith("]"):
                table[pending_key] = _parse_value(" ".join(pending_val))
                pending_key = None
            continue
        m = _KV_RE.match(stripped)
        if not m:
            continue
        key, val = m.group("key"), m.group("val").strip()
        if val.startswith("[") and not val.endswith("]"):
            pending_key, pending_val = key, [val]  # multi-line array
        else:
            table[key] = _parse_value(val)
    return table


PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))


def package_config() -> EsguardConfig:
    """The port's own config (module docstring)."""
    return EsguardConfig(exclude=["estorch_tpu_torch/native/*"],
                         baseline="esguard_baseline.json",
                         ratchet="esguard_ratchet.json", root=PACKAGE_DIR)


def load_config(pyproject_path: str | None = None) -> EsguardConfig:
    """The port's :func:`package_config`, or the ``[tool.esguard]`` table
    of the file given (absent file or table -> defaults)."""
    if pyproject_path is None:
        return package_config()
    cfg = EsguardConfig(root=os.path.dirname(pyproject_path) or ".")
    if not os.path.exists(pyproject_path):
        return cfg
    with open(pyproject_path, encoding="utf-8") as fh:
        table = parse_esguard_table(fh.read())
    if "enable" in table:
        cfg.enable = list(table["enable"])
    if "disable" in table:
        cfg.disable = list(table["disable"])
    if "baseline" in table:
        cfg.baseline = str(table["baseline"])
    if "ratchet" in table:
        cfg.ratchet = str(table["ratchet"])
    if "exclude" in table:
        cfg.exclude = list(table["exclude"])
    return cfg
