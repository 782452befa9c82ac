"""The port's settings dataclasses are field-for-field copies of the JAX
package's (plainrenderer_tpu/config.py, ops/shade.py:34, ops/sky.py:40)."""

import dataclasses

import pytest

from plainrenderer_tpu import config as jcfg
from plainrenderer_tpu_torch import config as tcfg


@pytest.mark.parametrize("name", [
    "ShadingConfig", "AtmosphereSettings", "TAASettings", "SDFTraceSettings",
    "VolumetricsSettings", "BloomSettings", "SDFDebugSettings",
    "ShadowSettings", "RenderSettings"])
def test_settings_copies_match(name):
    """Same fields in the same order, same defaults, same frozenness."""
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert [f.name for f in dataclasses.fields(j)] == \
        [f.name for f in dataclasses.fields(t)]
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())
    assert j.__dataclass_params__.frozen and t.__dataclass_params__.frozen
    hash(t())


def test_derived_atmosphere_property():
    assert tcfg.AtmosphereSettings().extinction_mie_ground == \
        jcfg.AtmosphereSettings().extinction_mie_ground
