"""The port's presets against the JAX package's: every preset of
``sba_gan_tpu/configs/`` (``gen2_birds.yml`` too, since the gen-2 StyleGAN
was ported) has a copy under ``sba_gan_tpu_torch/configs/`` that
loads through the port's ``cfg_from_file`` to the values the JAX package's
``cfg_from_file`` gives its own file, key for key (defaults included), but
for the documented differences below.

Documented differences: a training preset's ``TRAIN.NET_E`` names a
checkpoint of the port's own DAMSM pretraining, so the port's copy leaves it
empty (random encoders) where the JAX file names the reference's encoder
directory.  Evaluation presets keep their reference paths.
"""

import os

import pytest

from sba_gan_tpu.config import cfg_from_file as jax_cfg_from_file
from sba_gan_tpu_torch.config import CONFIG_DIR, cfg_from_file, preset

JAX_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "sba_gan_tpu", "configs")
NOT_PORTED = set()  # every preset is ported
# {preset: {key: the port's value}} where it differs by design
DIFFERENCES = {name: {"TRAIN.NET_E": ""} for name in (
    "bird_attn2", "bird_attnDCGAN2", "bird_bert", "bird_mixing", "bird_style",
    "bird_style_tpu", "coco_attn2")}


def _jax_presets():
    out = []
    for d, _, files in os.walk(JAX_CONFIGS):
        out += [os.path.relpath(os.path.join(d, f), JAX_CONFIGS) for f in files
                if f.endswith(".yml") and f not in NOT_PORTED]
    return sorted(out)


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_every_jax_preset_has_a_port_copy():
    ported = sorted(os.path.relpath(os.path.join(d, f), CONFIG_DIR)
                    for d, _, files in os.walk(CONFIG_DIR) for f in files
                    if f.endswith(".yml"))
    assert ported == _jax_presets()
    assert {"coco_attn2.yml", "eval_coco.yml", os.path.join("DAMSM", "coco.yml"),
            "bird_attn2.yml", "bird_style_tpu.yml", "gen2_birds.yml"} <= set(ported)


@pytest.mark.parametrize("rel", _jax_presets())
def test_port_preset_loads_to_jax_values(rel):
    want = _flat(jax_cfg_from_file(os.path.join(JAX_CONFIGS, rel)))
    got = _flat(cfg_from_file(os.path.join(CONFIG_DIR, rel)))
    name = rel[:-len(".yml")]
    assert _flat(preset(name)) == got
    differ = DIFFERENCES.get(name, {})
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key in differ:
            assert value and got[key] == differ[key], key  # the reference's path, emptied
        else:
            assert got[key] == value and type(got[key]) is type(value), key
