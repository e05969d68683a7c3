"""Nothing the benchmark loads is JAX or the JAX package, and its reference
loads nothing of the program.  Each check runs in a fresh interpreter, so
what the test runner itself loaded does not count."""
from __future__ import annotations

import json
import subprocess
import sys

from benchmark import harness

FORBIDDEN = set(harness.FORBIDDEN)

_LOAD_ALL = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness, calibrate
import benchmark.run
for cell in [w["name"] for w in harness.load_manifest()["workloads"]]:
    spec = harness.cell_spec(cell)
    harness.runner_of(spec)
    for m in spec.end_to_end + spec.per_layer:
        harness.load_module(harness.BENCH / "metrics" / (m["name"] + ".py"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.checks, benchmark.pool, benchmark.counts.flops, benchmark.counts.peaks
import benchmark.reference.follow, benchmark.reference.steps, benchmark.reference.nets
import benchmark.reference.geometry, benchmark.reference.cameras
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, check=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_benchmark_loads_no_jax():
    top = set(_modules(_LOAD_ALL))
    assert "dhaug_torch" in top and "torch" in top
    assert not top & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _modules(_LOAD_REFERENCE)
    assert not [m for m in loaded if m.split(".")[0].startswith("dhaug_torch")]
    assert not {m.split(".")[0] for m in loaded} & FORBIDDEN


def test_reference_sources_name_no_program_module():
    for path in list((harness.BENCH / "reference").glob("*.py")) + [
            harness.BENCH / "pool.py", harness.BENCH / "checks.py"]:
        for line in path.read_text().splitlines():
            if line.lstrip().startswith(("import ", "from ")):
                assert "dhaug" not in line, (path.name, line)


def test_forbidden_modules_is_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "dhaug_tpu_like", sys)
    assert "dhaug_tpu_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
