"""Nothing the benchmark loads is JAX or the JAX package, compared by the
top-level module name as a whole (``pwcnet_tpu_torch`` is allowed); the
reference loads nothing of the port either."""

from __future__ import annotations

import ast
import subprocess
import sys

from flowbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "pwcnet_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(','.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        check=True).stdout.strip().splitlines()[-1]
    return set(out.split(","))


def test_everything_the_benchmark_runs_loads_no_jax():
    mods = _loaded(
        "import sys; sys.path.insert(0, '.')\n"
        "from flowbench import harness, run, costs, frames\n"
        "import flowbench.drivers.stream, flowbench.drivers.train\n"
        "import glob, os\n"
        "[harness.load_module(harness.BENCH / 'metrics' / os.path.basename"
        "(p)) for p in glob.glob('flowbench/metrics/*.py')]\n"
        "import pwcnet_tpu_torch.train.loop, pwcnet_tpu_torch.data.pipeline")
    assert "pwcnet_tpu_torch" in mods and "flowbench" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    mods = _loaded("import sys; sys.path.insert(0, '.')\n"
                   "import flowbench.reference.pwcnet, "
                   "flowbench.reference.raft, flowbench.reference.train, "
                   "flowbench.reference.synthetic")
    assert not mods & (FORBIDDEN | {"pwcnet_tpu_torch"})


def test_no_source_of_the_benchmark_imports_jax():
    for path in harness.BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in FORBIDDEN, (path, n)
                if "reference" in path.parts:
                    assert top != "pwcnet_tpu_torch", (path, n)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pwcnet_tpu_torch_x", sys)
    assert "pwcnet_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
