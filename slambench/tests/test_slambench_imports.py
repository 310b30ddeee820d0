"""What the benchmark imports, compared by whole top-level name: the
reference (and every module it loads) nothing of JAX, the JAX package or
the program; the harness and the metrics nothing of JAX or the JAX
package; and a run's process holds none of them once it has loaded the
program, the reference and every metric."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "slam_tpu"}
PROGRAM = {"slam_tpu_torch"}


def _imports(path: Path) -> set:
    """Top-level names of every absolute import in a file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _files(*parts):
    return sorted((BENCH.joinpath(*parts)).rglob("*.py"))


@pytest.mark.parametrize("path", _files("reference"),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports(path):
    assert not _imports(path) & (JAX | PROGRAM)


@pytest.mark.parametrize(
    "path", _files("harness") + _files("metrics") + [BENCH / "run.py",
                                                      BENCH / "calibrate.py"],
    ids=lambda p: str(p.relative_to(BENCH)))
def test_harness_imports(path):
    assert not _imports(path) & JAX


def test_name_compared_whole():
    """``slam_tpu_torch`` begins with ``slam_tpu`` and is not it."""
    from harness import runner

    saved = dict(sys.modules)
    try:
        sys.modules["slam_tpu_torch_x"] = sys
        assert runner.forbidden_modules() == sorted(
            {m.split(".")[0] for m in saved if m.split(".")[0] in JAX})
    finally:
        sys.modules.pop("slam_tpu_torch_x", None)


def test_loaded_modules_in_a_run_process():
    code = f"""
import json, sys
sys.path[:0] = [{str(BENCH.parent)!r}, {str(BENCH)!r},
                {str(BENCH / "reference")!r}]
from harness import runner, spec
runner.setup_env()
import slamref, slamref.models.frontend
bench = spec.load_benchmark()
for m in bench["per_layer"]:
    runner.load_metric(m["name"])
ref_mods = sorted({{m.split(".")[0] for m in sys.modules}})
import slam_tpu_torch.pipeline
print(json.dumps({{"ref": ref_mods, "bad": runner.forbidden_modules()}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert not set(got["ref"]) & (JAX | PROGRAM)
