"""Nothing under gpubench/ imports JAX or the JAX package; the reference
imports nothing of the port either. Top-level names compare whole:
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


def test_the_check_compares_names_whole():
    tree = "import fasterseg_tpu_torch.models\nfrom fasterseg_tpu import x\n"
    names = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
             else n.module.split(".")[0]
             for n in ast.parse(tree).body}
    assert names & FORBIDDEN == {"fasterseg_tpu"}
