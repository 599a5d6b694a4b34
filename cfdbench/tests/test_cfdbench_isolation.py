"""Nothing under cfdbench/ imports jax, jaxlib, flax or the JAX package,
and the yardstick (inputs/, reference/, counts.py, check.py, state.py)
imports nothing of the port either. Names are compared by their whole
top-level part: mgcfd_tpu_torch begins with mgcfd_tpu."""
import ast
import os

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = {"jax", "jaxlib", "flax", "mgcfd_tpu"}
YARDSTICK = ("inputs", "reference", "counts.py", "check.py", "state.py")


def sources():
    for base, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if not d.startswith(".")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(base, f), PKG)


def top_level_imports(rel):
    with open(os.path.join(PKG, rel)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", sorted(sources()))
def test_imports(rel):
    names = set(top_level_imports(rel))
    assert not names & NEVER, rel
    if rel.split(os.sep)[0] in YARDSTICK:
        assert "mgcfd_tpu_torch" not in names, rel


def test_the_whole_name_is_compared():
    assert "mgcfd_tpu_torch".split(".")[0] not in NEVER
