"""What the benchmark imports: no module under ``portbench/`` names
``jax``, ``jaxlib``, ``flax`` or the JAX package ``keypoints_tpu`` as its
top-level module (compared whole: ``keypoints_tpu_torch`` begins with
``keypoints_tpu``), and the reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from portbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "keypoints_tpu"}
PROGRAM = "keypoints_tpu_torch"


def imported_tops(path):
    tree = ast.parse(path.read_text(), str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(p for p in spec.HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((spec.HERE / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in imported_tops(path)
    assert PROGRAM not in path.read_text()


def test_the_prefix_is_compared_whole():
    assert "keypoints_tpu_torch".split(".")[0] not in FORBIDDEN
    assert set(run.FORBIDDEN) == FORBIDDEN


def test_a_run_loads_no_jax():
    """Every module a run imports, drivers and readers included, then the
    program's modules they reach, leave no forbidden top-level module."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import run, spec\n"
        "b = spec.load()\n"
        "for w in b['workloads']:\n"
        "    spec.driver(spec.read_json('traffic', w['traffic'])['kind'])\n"
        "for m in b['per_layer']:\n"
        "    spec.metric_reader(m['name'])\n"
        "import keypoints_tpu_torch.serve, keypoints_tpu_torch.train\n"
        "print(run.forbidden_modules())\n" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=spec.ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[]"
