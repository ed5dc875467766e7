"""What the benchmark loads: no module of JAX or of the JAX package
(compared by the whole top-level name: ``repro_torch`` is not
``repro``), in a fresh interpreter that imports the harness, the port
adapter, every per-layer reader and the reference."""
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

PROBE = """
import importlib, json, pathlib, sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench import calibrate, check, harness, profiling, roofline, system, traffic
from portbench.reference import des
for path in sorted(pathlib.Path({here!r}, "metrics").glob("*.py")):
    harness.reader(path.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_and_no_jax_package_loaded():
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"),
                        here=str(HERE))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}, top


def test_forbidden_modules_compares_whole_names():
    from portbench import harness
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core.engine", "jax.numpy",
                                      "flax", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "repro"]
