"""What the benchmark runs imports neither JAX nor the JAX package, compared
by whole top-level module names; the reference imports nothing of the
program."""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

from perfbench import harness

HERE = pathlib.Path(harness.__file__).resolve().parent
PROGRAM = "seed_story_torch"


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not top_level_imports(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert PROGRAM not in top_level_imports(path), path


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    # the port's name begins with the JAX package's: a prefix match would flag it
    before = set(harness.forbidden_modules())
    for name in ("seed_story_tpux", "jaxlibrary", "flax_like", "flax.core"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(harness.forbidden_modules()) - before == {"flax.core"}


def test_loading_every_driver_and_reader_loads_no_forbidden_module():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(HERE.parent)!r})\n"
        "from perfbench import harness\n"
        "b = harness.benchmark()\n"
        "for w in b['workloads']:\n"
        "    harness.driver(harness.workload(w['name'])['driver'])\n"
        "for m in b['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
