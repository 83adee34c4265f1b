"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (``repro_torch`` is not ``repro``); the
reference imports nothing of the program; without a card ``run.py`` exits
non-zero and prints no result."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from bench import harness

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in list((BENCH / "reference").glob("*.py")) + [BENCH / "frozen" / "flops.py",
                                                           BENCH / "weights.py",
                                                           BENCH / "check.py"]:
        assert "repro_torch" not in set(_imports(path)), path


def test_whole_names_compared(monkeypatch):
    for name in ("repro_torch", "repro_torch.api", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    for name in harness.FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setattr(sys, "modules", {k: v for k, v in sys.modules.items()
                                         if k.split(".")[0] not in harness.FORBIDDEN})
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.api", sys)
    assert harness.forbidden_modules() == ["repro"]


def test_a_tiny_run_loads_no_jax(tmp_path):
    """A whole run of a tiny cell in a fresh interpreter leaves no JAX module
    behind."""
    code = f"""
import json, sys
from pathlib import Path
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from bench import _cases, harness
spec = _cases.make_bench(Path({str(tmp_path)!r}))
r = harness.run_cell("ds-tiny.tiny", 3, 0.1, False, device="cpu", spec=spec,
                     bench_dir=Path({str(tmp_path)!r}))
print(json.dumps([harness.forbidden_modules(), r.correct]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], True]


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          harness.load_spec()["workloads"][0]["name"], "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
