"""``JAX.DTYPE`` in the port: the JAX package's TPU preset
(``sba_gan_tpu/configs/bird_style_tpu.yml``, ``DTYPE: bfloat16``) loads through
the port's config, and each of the port's model builders refuses it (the
port computes in float32 only, until bf16 compute is ported), where it used
to run in float32 without a word.
"""

import os

import pytest

from sba_gan_tpu_torch.config import cfg_from_file
from sba_gan_tpu_torch.train.damsm import build_damsm_models
from sba_gan_tpu_torch.train.gan import build_models
from sba_gan_tpu_torch.train.sample import Sampler

PRESET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "sba_gan_tpu", "configs", "bird_style_tpu.yml")
BUILDERS = {
    "sampler": lambda cfg: Sampler.from_config(cfg, 30, device="cpu"),
    "damsm": lambda cfg: build_damsm_models(cfg, 30),
    "gan": lambda cfg: build_models(cfg, 30),
}


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_bfloat16_compute_is_refused(builder):
    cfg = cfg_from_file(PRESET)
    assert cfg.JAX.DTYPE == "bfloat16"
    with pytest.raises(NotImplementedError, match=r"JAX.DTYPE='bfloat16'.*ROADMAP"):
        BUILDERS[builder](cfg)
