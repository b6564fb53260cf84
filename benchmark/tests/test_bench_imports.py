"""Nothing the benchmark loads is JAX or of the JAX package; the reference
loads nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = Path(harness.BENCH_DIR)


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_runners_and_reference_load_no_jax():
    loaded = _loaded("import benchmark.harness, benchmark.reference, benchmark.trace\n"
                     "from benchmark.runners import synth, train\n"
                     "import megatts2_tpu_torch.models, megatts2_tpu_torch.training")
    assert not loaded & set(harness.FORBIDDEN)
    assert "megatts2_tpu_torch" in loaded  # names compared whole: the port is not the JAX package


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded("import benchmark.reference")
    assert "megatts2_tpu_torch" not in loaded and not loaded & set(harness.FORBIDDEN)
    tree = ast.parse((BENCH / "reference.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "math", "typing", "numpy", "torch"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "megatts2_tpu_torch_x", sys)
    assert "megatts2_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
