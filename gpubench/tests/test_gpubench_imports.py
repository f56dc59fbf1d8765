"""Nothing under gpubench/ imports JAX or the JAX package; the reference
imports nothing of the port either, and a family module imports the port
only inside its `program`. Top-level names compare whole:
`fasterseg_tpu_torch` begins with `fasterseg_tpu` and is allowed outside
the reference."""

import ast
import os

import pytest

GPUBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "fasterseg_tpu"}


def _sources():
    for base, _, files in os.walk(GPUBENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: os.path.relpath(p, GPUBENCH))
def test_no_jax(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in _sources()
                                  if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, GPUBENCH))
def test_reference_imports_nothing_of_the_port(path):
    assert "fasterseg_tpu_torch" not in set(_top_level_imports(path))


FAMILIES = os.path.join(GPUBENCH, "families")


def _port_imports_outside_program(tree, inside=False):
    """Imports of the port that no function named `program` encloses."""
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)) and not inside:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            for name in names:
                if name.split(".")[0] == "fasterseg_tpu_torch":
                    yield node.lineno
        yield from _port_imports_outside_program(
            node, inside or (isinstance(node, ast.FunctionDef)
                             and node.name == "program"))


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(FAMILIES)
                                         if f.endswith(".py")))
def test_a_family_imports_the_port_only_in_program(name):
    with open(os.path.join(FAMILIES, name)) as f:
        tree = ast.parse(f.read(), name)
    assert list(_port_imports_outside_program(tree)) == []


def test_the_family_rule_finds_a_port_import_outside_program():
    tree = ast.parse("import fasterseg_tpu_torch\n"
                     "def program():\n    from fasterseg_tpu_torch import m\n"
                     "def reference_logits():\n"
                     "    from fasterseg_tpu_torch.models import x\n")
    assert list(_port_imports_outside_program(tree)) == [1, 5]


def test_the_check_compares_names_whole():
    tree = "import fasterseg_tpu_torch.models\nfrom fasterseg_tpu import x\n"
    names = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
             else n.module.split(".")[0]
             for n in ast.parse(tree).body}
    assert names & FORBIDDEN == {"fasterseg_tpu"}
