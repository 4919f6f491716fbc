"""coslam_tpu_torch.config is a field-for-field copy of coslam_tpu.config."""

import dataclasses

import pytest

import coslam_tpu.config as jcfg
import coslam_tpu_torch.config as tcfg

CLASSES = ["CameraConfig", "ExtractorConfig", "MatcherConfig",
           "TrackerConfig", "MapperConfig", "LoopConfig", "MeshConfig",
           "SystemConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_equal(name):
    a, b = getattr(jcfg, name), getattr(tcfg, name)
    fa = [(f.name, str(f.type)) for f in dataclasses.fields(a)]
    fb = [(f.name, str(f.type)) for f in dataclasses.fields(b)]
    assert fa == fb
    assert dataclasses.asdict(a()) == dataclasses.asdict(b())


@pytest.mark.parametrize("factory", ["tum_fr1_config", "euroc_config",
                                     "kitti_config"])
def test_dataset_presets_equal(factory):
    assert dataclasses.asdict(getattr(jcfg, factory)()) \
        == dataclasses.asdict(getattr(tcfg, factory)())


def test_derived_properties_equal():
    for a, b in ((jcfg.ExtractorConfig(), tcfg.ExtractorConfig()),
                 (jcfg.tum_fr1_config().camera, tcfg.tum_fr1_config().camera)):
        for prop in ("scale_factors", "level_sigma2", "K", "has_distortion"):
            if hasattr(a, prop):
                assert getattr(a, prop) == getattr(b, prop)
