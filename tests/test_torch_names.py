"""Every public name of the JAX package has a counterpart in the port, or a
row in README.md's table "Names that differ from the JAX package".

Both packages are walked with ``ast`` (neither is imported): a module's
public names are its top-level functions, classes and assigned names not
starting with ``_``.  A JAX name is covered when the port's module of the
same path defines it, or when the table has a row for it (or for its whole
module).  The table is held too: each row's JAX name must exist, its port
name (unless "—") must exist, and no row may cover a name the port's module
of the same path already defines.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_ROOT, PORT_ROOT = REPO / "estorch_tpu", REPO / "estorch_tpu_torch"
HEADING = "### Names that differ from the JAX package"
ROW = re.compile(r"^\| `([^`]+)` \| (?:`([^`]+)`|—) \|")


def public_names(root: Path) -> dict[str, set[str]]:
    """``{module path under root: its public top-level names}``."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if "/__pycache__/" in rel:
            continue
        names = set()
        for node in ast.parse(path.read_text(), filename=str(path)).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets if isinstance(t, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                names.add(node.target.id)
        out[rel] = {n for n in names if not n.startswith("_")}
    return out


def table_rows() -> dict[str, str | None]:
    """README's table: ``{JAX "module::name" or "module": port's or None}``."""
    text = (REPO / "README.md").read_text()
    assert HEADING in text, f"README.md lacks the section {HEADING!r}"
    section = text.split(HEADING, 1)[1].split("\n#", 1)[0]
    rows = {}
    for line in section.splitlines():
        m = ROW.match(line)
        if m and m.group(1) != "JAX name":
            assert m.group(1) not in rows, f"two rows for {m.group(1)}"
            rows[m.group(1)] = m.group(2)
    assert rows, "README.md's name table has no rows"
    return rows


@pytest.fixture(scope="module")
def trees():
    return public_names(JAX_ROOT), public_names(PORT_ROOT), table_rows()


def _split(ref: str) -> tuple[str, str | None]:
    module, _, name = ref.partition("::")
    return module, name or None


def test_every_jax_name_has_a_counterpart_or_a_row(trees):
    jax_names, port_names, rows = trees
    missing = []
    for module, names in jax_names.items():
        if module in rows:  # a renamed module: its names live in the row's module
            target = port_names.get(rows[module], set())
            missing += [f"{module}::{n} (in {rows[module]})" for n in sorted(names - target)
                        if f"{module}::{n}" not in rows]
            continue
        have = port_names.get(module)
        if have is None:
            missing.append(f"{module} (the whole module)")
            continue
        missing += [f"{module}::{n}" for n in sorted(names - have) if f"{module}::{n}" not in rows]
    assert not missing, ("JAX names with neither a port counterpart nor a row in README.md's "
                         f"name table: {missing}")


def test_every_row_is_live(trees):
    """Each row's JAX name exists, its port name exists, and the port does
    not already define the JAX name at the same path."""
    jax_names, port_names, rows = trees
    for ref, port in rows.items():
        module, name = _split(ref)
        assert module in jax_names, f"row {ref}: no JAX module {module}"
        if name is None:
            assert module not in port_names, f"row {ref}: the port has the module"
        else:
            assert name in jax_names[module], f"row {ref}: JAX's {module} has no {name}"
            assert name not in port_names.get(module, set()), (
                f"row {ref}: the port's {module} defines {name}; delete the row")
        if port is not None:
            pmod, pname = _split(port)
            assert pmod in port_names, f"row {ref}: no port module {pmod}"
            if pname is not None:
                assert pname in port_names[pmod], f"row {ref}: the port's {pmod} has no {pname}"


def test_the_walk_sees_both_packages(trees):
    """The walk reads real trees: the main modules and names are there."""
    jax_names, port_names, _ = trees
    for names in (jax_names, port_names):
        assert "ES" in names["algo/es.py"] and "MLPPolicy" in names["models/policies.py"]
        assert len(names) > 100
