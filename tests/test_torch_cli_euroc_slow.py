"""The slow twin of ``tests/test_torch_cli_euroc.py``: the port's EuRoC CLI
and the JAX package's (``scripts/run_euroc.py``) on the same fabricated
``mav0/`` tree, each with the fixture's calibration monkeypatched into its
own dataset module, in the stereo mode (with and without ``--loop-close``)
and the vo mode with ``--loop-close``: the same artifact files and summary
keys, and the JAX CLI's own bounds met by both (stereo ATE below 0.3 m, no
loop applied). Marked slow, as ``tests/test_euroc_cli.py`` is: the JAX CLI
compiles each mode's steps (minutes on the CPU).

    python -m pytest tests/test_torch_cli_euroc_slow.py -m slow
"""

import contextlib
import io
import json
import os
import sys

import pytest

from epivo_tpu.datasets import euroc as jeuroc
from tests.test_euroc_cli import _load_cli
from tests.test_torch_cli_euroc import calibration, run_port, tree  # noqa: F401 (fixture)

pytestmark = pytest.mark.slow


@pytest.mark.parametrize("flags", [["--mode", "stereo"], ["--mode", "stereo", "--loop-close"],
                                   ["--mode", "vo", "--loop-close"]],
                         ids=["stereo", "stereo-loop", "vo-loop"])
def test_cli_against_reference(tree, tmp_path, monkeypatch, flags):  # noqa: F811
    out, ref_out = str(tmp_path / "port"), str(tmp_path / "jax")
    summary = run_port(tree, out, monkeypatch, *flags)
    for name, value in calibration():
        monkeypatch.setattr(jeuroc, name, value)
    monkeypatch.setattr(sys, "argv", ["run_euroc.py", "--root", tree, "--out", ref_out,
                                      *flags])
    with contextlib.redirect_stdout(io.StringIO()):
        _load_cli().main()
    with open(os.path.join(ref_out, "summary.json")) as f:
        ref = json.load(f)
    print(f"{flags}: port {summary}, JAX CLI {ref}")
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref_out))
    assert set(summary) == set(ref)
    if "config" in ref:
        assert set(summary["config"]) == set(ref["config"])
    assert summary["loops_applied"] == ref["loops_applied"] == 0
    if flags[1] == "stereo":
        assert summary["ate_m"] < 0.3 and ref["ate_m"] < 0.3, (summary, ref)
