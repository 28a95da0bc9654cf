"""``JAX.DTYPE`` in the port: the JAX package's TPU preset
(``sba_gan_tpu/configs/bird_style_tpu.yml``, ``DTYPE`` and ``LOSS_DTYPE``
bfloat16) loads through the port's config, and each of the port's model
builders builds from it models that compute in bfloat16 with float32
parameters; a ``DTYPE`` the port has no path for (float16) raises, naming
``ROADMAP.md``.
"""

import os

import pytest
import torch

from sba_gan_tpu_torch.config import cfg_from_file
from sba_gan_tpu_torch.models.layers import Conv2d, Linear
from sba_gan_tpu_torch.train.damsm import DAMSMTrainer, build_damsm_models
from sba_gan_tpu_torch.train.gan import GANStep, build_models, init_gan_state
from sba_gan_tpu_torch.train.sample import Sampler

PRESET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "sba_gan_tpu", "configs", "bird_style_tpu.yml")


def _sampler(cfg):
    s = Sampler.from_config(cfg, 30, device="cpu")
    return [s.generator, s.text_encoder], None


def _damsm(cfg):
    models = build_damsm_models(cfg, 30)
    return list(models), DAMSMTrainer(cfg, models, device="cpu").mm_dtype


def _gan(cfg):
    models = build_models(cfg, 30)
    step = GANStep(cfg, init_gan_state(cfg, models, device="cpu"))
    return [models.text_encoder, models.image_encoder, models.generator,
            *models.discriminators], step.mm_dtype


BUILDERS = {"sampler": _sampler, "damsm": _damsm, "gan": _gan}


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_bfloat16_preset_builds_bfloat16_compute(builder):
    cfg = cfg_from_file(PRESET)
    assert cfg.JAX.DTYPE == cfg.JAX.LOSS_DTYPE == "bfloat16"
    nets, mm_dtype = BUILDERS[builder](cfg)
    assert mm_dtype in (None, torch.bfloat16)
    for net in nets:
        assert all(p.dtype == torch.float32 for p in net.parameters())
        assert all(b.dtype in (torch.float32, torch.long) for b in net.buffers())
        layers = [m for m in net.modules() if isinstance(m, (Conv2d, Linear))]
        assert all(m.compute_dtype == torch.bfloat16 for m in layers)
        if hasattr(net, "compute_dtype"):  # the text encoder
            assert net.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_float16_compute_is_refused(builder):
    cfg = cfg_from_file(PRESET)
    cfg.JAX.DTYPE = "float16"
    with pytest.raises(NotImplementedError, match=r"JAX.DTYPE='float16'.*ROADMAP"):
        BUILDERS[builder](cfg)
