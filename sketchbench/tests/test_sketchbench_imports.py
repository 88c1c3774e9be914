"""No JAX in a run: the whole-name check on loaded modules, the reference
and the harness's own modules importing nothing of JAX or the JAX
package, the reference importing nothing of the program, and a checkout
with only the benchmark's files exiting non-zero with no result."""

import json
import shutil
import subprocess
import sys

from sketchbench.catalog import HERE, ROOT
from sketchbench.run import FORBIDDEN, forbidden_modules


def test_the_check_compares_whole_top_level_names():
    assert forbidden_modules(["repro_torch", "repro_torch.sketch",
                              "reprox", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                              "flax.linen", "repro_torch"]) == \
        ["flax", "jax", "jaxlib", "repro"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, timeout=300,
        env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_no_jax_and_nothing_of_the_program():
    top = _loaded_after("import sketchbench.reference.sketch\n"
                        "import sketchbench.check\n"
                        "import sketchbench.traffic.queries")
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_harness_and_the_program_load_no_jax():
    top = _loaded_after("import sketchbench.harness, sketchbench.trace\n"
                        "import repro_torch.launch.serve_sketch\n"
                        "import repro_torch.sketch")
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_a_checkout_of_only_the_benchmark_exits_nonzero(tmp_path):
    shutil.copytree(HERE, tmp_path / "sketchbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "sketchbench/run.py", "--workload", "comfs.ingest",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
