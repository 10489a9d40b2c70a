"""Nothing a run loads is JAX or the JAX package, compared by the whole
top-level name; the reference and the yardstick load nothing of the
program."""

import subprocess
import sys

import pytest

from benchmark.harness import guard, spec as spec_mod

CELLS = [w["name"] for w in spec_mod.load_spec()["workloads"]]


def test_top_level_names_are_compared_whole():
    mods = ["epivo_tpu_torch", "epivo_tpu_torch.pipeline.vo", "jaxtyping", "numpy",
            "epivo_tpu_tools"]
    assert guard.forbidden_modules(mods) == []
    assert guard.forbidden_modules(mods + ["jax.numpy", "epivo_tpu.frontend"]) == [
        "epivo_tpu.frontend", "jax.numpy"]
    assert guard.forbidden_modules(["jaxlib", "flax.linen"]) == ["flax.linen", "jaxlib"]


def _fresh(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=spec_mod.ROOT,
                          capture_output=True, text=True, timeout=240,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(spec_mod.ROOT),
                               "PYTHONPATH": str(spec_mod.ROOT)})


@pytest.mark.parametrize("name", CELLS)
def test_a_cells_imports_load_no_jax(name):
    code = f"""
import sys, importlib
import torch
from benchmark.harness import cell as cell_mod, guard, port, spec
c = spec.cell({name!r})
importlib.import_module("benchmark.harness.kinds." + c.traffic["kind"])
import benchmark.run, benchmark.calibrate
from epivo_tpu_torch.pipeline import ba, runners, vo
from epivo_tpu_torch import _graphs
print("BAD", guard.forbidden_modules())
"""
    out = _fresh(code)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout


def test_the_reference_and_yardstick_load_nothing_of_the_program():
    code = """
import sys
import benchmark.reference.vo, benchmark.reference.ba
import benchmark.yardstick.work, benchmark.yardstick.frames, benchmark.yardstick.ba_windows
import benchmark.harness.compare, benchmark.harness.trace, benchmark.harness.stats
print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in
      ("epivo_tpu_torch", "epivo_tpu", "jax", "jaxlib")))
"""
    out = _fresh(code)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
