"""Port parity: the KITTI CLI's artifacts against the JAX package's CLI
(``scripts/run_kitti.py``) in the vo and gt modes, on the small KITTI tree of
``tests/test_torch_cli_kitti.py`` (:func:`against_reference` there: the
same files, summary keys and config values; the port's ATE at most 1.5x
the JAX CLI's)."""

import pytest

from tests.test_torch_cli_kitti import against_reference, tree  # noqa: F401 (fixture)


@pytest.mark.parametrize("mode", ["vo", "gt"])
def test_cli_against_reference(tree, tmp_path, monkeypatch, mode):  # noqa: F811
    against_reference(tree, str(tmp_path), monkeypatch, mode)
