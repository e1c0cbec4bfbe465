"""Nothing the benchmark loads brings in JAX or the JAX package, and the
reference loads nothing of the port either (top-level names compared
whole: the port's name begins with the JAX package's)."""
import json
import subprocess
import sys

from snnbench.tests.helpers import ROOT

HARNESS = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
from pathlib import Path
import snnbench.run, snnbench.sweep, snnbench.control
from snnbench.lookup import load_module
base = Path({root!r}) / "snnbench"
for sub in ("configs", "metrics", "work"):
    for f in sorted((base / sub).glob("*.py")):
        if f.name != "__init__.py":
            load_module(f, sub)
import snnbench.reference
# what a run loads of the port: its network, compilers, executor and engine
import repro_torch.core, repro_torch.core.runtime, repro_torch.scaffold
import repro_torch.serving, repro_torch.kernels
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
import snnbench.reference, snnbench.reference.lif_graph
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(src=str(ROOT / "src"),
                                                            root=str(ROOT))],
                         capture_output=True, text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    loaded = _top_level(HARNESS)
    assert "repro_torch" in loaded and "snnbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE)
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
