"""What the benchmark loads: the harness's run (here its CPU dry path, in a
process of its own) holds no module of the JAX side, and the reference holds
neither that nor the port.  Modules are compared by their whole top-level
name: the port's name begins with the JAX package's."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from conftest import ROOT

_DRY = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import small_spec
from benchmark.harness import run_cell
out = run_cell("cavity_ne85184.explicit", 5, 0.01, False, device="cpu",
               spec=small_spec("cavity_ne85184.explicit", segment=3, first=1, sampled=1),
               log=lambda *a, **k: None)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REF = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.explicit, benchmark.check
import benchmark.decks, benchmark.traffic, benchmark.yardstick, benchmark.trace
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = code.format(root=str(ROOT), tests=str(ROOT / "benchmark" / "tests"))
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax_side():
    mods = _modules(_DRY)
    assert "cfd_with_cuda_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "cfd_with_cuda_tpu"}


def test_reference_loads_neither_package():
    mods = _modules(_REF)
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "cfd_with_cuda_tpu", "cfd_with_cuda_tpu_torch"}


def test_forbidden_names_compared_whole():
    from benchmark.harness import forbidden_loaded

    assert "cfd_with_cuda_tpu_torch" not in forbidden_loaded()
