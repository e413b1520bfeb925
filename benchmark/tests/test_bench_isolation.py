"""What the harness loads, and that it is driven by its files: no module
that a cell's run loads is JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), the
plain reference imports nothing of the program, and a cell and a
per-layer metric added as new files are picked up with no edit to any
file the harness has."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys

import helpers
import pytest

FORBIDDEN = {"jax", "jaxlib", "flax", "octcubem_tpu"}


def _run_py(code: str, cwd, timeout: int = 600) -> str:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("cell", sorted(helpers.TINY))
def test_a_cells_run_loads_no_jax(cell):
    code = (f"import sys; sys.path.insert(0, {str(helpers.HERE / 'tests')!r})\n"
            "import json, helpers, run as bench\n"
            f"run = helpers.tiny_run({cell!r}, trace=True)\n"
            "r = helpers.drive(run)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = set(json.loads(_run_py(code, helpers.HERE.parent)))
    assert "octcubem_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sorted((helpers.HERE / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in {"torch", "numpy", "math",
                                           "__future__"}, (path.name, n)
    code = (f"import sys; sys.path.insert(0, {str(helpers.HERE)!r})\n"
            "import json\n"
            "from reference import adamw, coem, plain, vit3d\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = set(json.loads(_run_py(code, helpers.HERE.parent)))
    assert not loaded & (FORBIDDEN | {"octcubem_tpu_torch", "harness"})


def _digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


NEW_METRIC = '''"""steps_seen.train: the window's steps (a metric added as a file)."""


def read(run):
    return run.window.get("steps")
'''


def test_new_cell_and_metric_are_picked_up_from_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(helpers.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(helpers.HERE.parent / "BENCHMARK.json", root)
    os.symlink(helpers.HERE.parent / "octcubem_tpu_torch",
               root / "octcubem_tpu_torch")
    before = _digest(root / "benchmark")

    bench = root / "benchmark"
    cell = json.loads((bench / "workloads" / "mae_vitl16_pretrain.json")
                      .read_text())
    (bench / "workloads" / "mae_added.json").write_text(json.dumps(cell))
    (bench / "metrics" / "steps_seen.py").write_text(NEW_METRIC)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append(dict(
        name="mae_added", config=cell["config"], traffic="added",
        chips=1, why="a cell added as a file"))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "mae_vitl16_pretrain" in m.get("workloads", []):
            m["workloads"].append("mae_added")
    manifest["per_layer"].append(dict(
        name="steps_seen.train", unit="steps", better="higher",
        source="host_clock", layer="train step", moves="samples_per_s",
        workloads=["mae_added"]))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    code = (f"import sys; sys.path.insert(0, {str(bench / 'tests')!r})\n"
            "import json, helpers\n"
            "run = helpers.tiny_run('mae_added', trace=True, overrides="
            "helpers.TINY['mae_vitl16_pretrain'])\n"
            "r = helpers.drive(run)\n"
            "print(json.dumps([r['correct'], sorted(r['metrics'])]))")
    correct, metrics = json.loads(_run_py(code, root))
    assert correct
    assert "steps_seen.train" in metrics and "issue_ms.train" in metrics
    after = _digest(bench)
    added = set(after) - set(before)
    assert added == {"workloads/mae_added.json", "metrics/steps_seen.py"}
    assert all(after[k] == v for k, v in before.items())
