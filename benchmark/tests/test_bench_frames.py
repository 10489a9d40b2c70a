"""The VO cells' frames: a configuration with no ``motion`` renders the
corridor drive bit for bit as before configurations could state a motion,
and a configuration that writes the corridor's motion out renders the
same frames."""

import copy
import hashlib

from benchmark.harness.kinds import _vo
from benchmark.tests._tiny import tiny_cell

SEED = 2**33 + 17
# sha256 of kitti00_vo's frames at the tiny camera and SEED, from the
# renderer as it was before ``motion`` existed.
DIGEST = "b12ca14b650138f253f6ca31f98cd09b0ccb01cef1e8d09ebd16b3c46169548f"
CORRIDOR = {"speed": 0.8, "yaw_rate": 0.002, "speed_wobble": 0.3, "sway": 0.02}


def _digest(cfg: dict, traffic: dict) -> str:
    return hashlib.sha256(_vo.render(cfg, traffic, SEED).tobytes()).hexdigest()


def test_kitti00_vo_frames_held_bit_for_bit():
    c = tiny_cell("kitti00_vo.offline_b32")
    assert "motion" not in c.config
    assert _digest(c.config, c.traffic) == DIGEST
    written_out = dict(copy.deepcopy(c.config), motion=CORRIDOR)
    assert _digest(written_out, c.traffic) == DIGEST
    slower = dict(copy.deepcopy(c.config), motion=dict(CORRIDOR, speed=0.022))
    assert _digest(slower, c.traffic) != DIGEST

