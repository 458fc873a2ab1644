"""Nothing the benchmark runs imports JAX, flax or the JAX package
(``repro``), compared by whole top-level names, or reads ``benchmarks/``."""

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_no_forbidden_import_in_sources():
    for f in sorted(HERE.rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & FORBIDDEN, f"{f}: {tops & FORBIDDEN}"
        assert "benchmarks/" not in f.read_text() or f.name == Path(__file__).name


def test_no_forbidden_module_loaded():
    code = ("import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
            "from cardbench import harness, calibrate\n"
            "from cardbench.runners import train, prefill\n"
            "import repro_torch.training.train_step, repro_torch.serving.serve_step\n"
            "for c in harness.benchmark()['workloads']:\n"
            "    cell = harness.cell(c['name'])\n"
            "    [harness.metric_reader(m['name']) for m in cell.per_layer]\n"
            "print(sorted({{m.split('.')[0] for m in sys.modules}} & {bad!r}))\n"
            ).format(root=str(ROOT), src=str(ROOT / "src"), bad=FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]", out.stdout


def test_refuses_without_a_card(tmp_path):
    """Without a card the command prints no result and
    exits non-zero."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          "deepseek7b-prefill-lognorm", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
