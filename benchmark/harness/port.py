"""The program's side: the port's configurations built from a
configuration file. Only the drivers import the port, and only inside
functions, so that the harness, the yardstick and the reference load
without it."""

from __future__ import annotations


def pinhole(c: dict):
    from epivo_tpu_torch.geometry.camera import Pinhole

    return Pinhole(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], width=c["width"],
                   height=c["height"])


def vo_config(cfg: dict):
    """The port's ``VOConfig`` of a two-view configuration file."""
    from epivo_tpu_torch.pipeline.config import (FrontendConfig, LMConfig, RansacConfig,
                                                 VOConfig)

    return VOConfig(camera=pinhole(cfg["camera"]), frontend=FrontendConfig(**cfg["frontend"]),
                    ransac=RansacConfig(**cfg["ransac"]), lm=LMConfig(**cfg["lm"]))


def ba_config(cfg: dict):
    """The port's ``BAConfig`` and mono ``WindowSpec`` of a BA configuration
    file."""
    from epivo_tpu_torch.pipeline import ba
    from epivo_tpu_torch.pipeline.config import BAConfig, LMConfig

    w = cfg["window"]
    config = BAConfig(camera=pinhole(cfg["camera"]), lm=LMConfig(**cfg["lm"]),
                      window_size=w["size"], stride=w["stride"])
    return config, ba.mono_window_spec(w["size"])
