"""The harness's only contact with the system under test
(coslam_tpu_torch): the configuration built from a configuration file, and
the settings a configuration pins on a fresh System.  Imported after the
run has checked for the card."""

from __future__ import annotations

import dataclasses


def system_config(config: dict):
    """coslam_tpu_torch.config.SystemConfig from a configuration file's
    `system` block; a field the block leaves out keeps the port's default."""
    from coslam_tpu_torch import config as cfg_mod

    groups = {"camera": cfg_mod.CameraConfig,
              "extractor": cfg_mod.ExtractorConfig,
              "matcher": cfg_mod.MatcherConfig,
              "tracker": cfg_mod.TrackerConfig,
              "mapper": cfg_mod.MapperConfig, "loop": cfg_mod.LoopConfig}
    block = config["system"]
    kw = {}
    for key, cls in groups.items():
        fields = {f.name for f in dataclasses.fields(cls)}
        given = block.get(key, {})
        unknown = set(given) - fields
        if unknown:
            raise ValueError(f"{config['name']}: {key} has no fields "
                             f"{sorted(unknown)}")
        kw[key] = cls(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in given.items()})
    return cfg_mod.SystemConfig(sensor=block.get("sensor", "mono"), **kw)


def pin_mapper_cycle(system, seconds: float) -> None:
    """Fix a System's measured mapper cycle (its InterruptBA window) at
    `seconds` instead of the host's clock."""
    system._insert_cost_s = float(seconds)
    system._note_insert_cost = lambda dt: None
