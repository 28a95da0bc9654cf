"""Typed configuration for the PyTorch port.

The same schema and strict YAML merge as the JAX package's config (unknown
keys raise ``KeyError``, type mismatches raise ``ValueError``), so every
preset of the repository loads unchanged.  The port reads ``TREE``,
``GAN``, ``TEXT``, ``GEN2`` (the gen-2 StyleGAN, :mod:`train.gen2`),
``TRAIN`` (the global batch size, epochs, snapshot
interval, the three learning rates, the RNN gradient clip, ``SMOOTH``,
``MIXING``, ``FLAG``, ``NET_E``, ``GRAD_ACCUM`` and ``GRAD_ACCUM_MODE``
'window' or 'dfresh', and gen-2's ``CRITIC_ITER``), ``RNN_TYPE``, ``MODEL.TEXT_ENCODER`` /
``INCEPTION_INPUT``, and of the ``JAX`` group ``SEED``, ``DTYPE`` and
``LOSS_DTYPE`` (float32 or bfloat16, as torch dtypes through
:func:`compute_dtype` and :func:`loss_dtype`; any other value raises),
``MESH_DATA`` (-1, or the world size of the ``torchrun`` ranks, else
``ValueError``), ``MESH_MODEL`` (1; above it raises
``NotImplementedError``: the tensor-parallel Inception is not ported) and
``SYNC_BATCHNORM``, which is accepted and, as in the JAX package, only
documents: across ranks the BatchNorm statistics are the global batch's
whatever it says (:mod:`parallel.dist`).  The other ``JAX`` keys and the ``BENCH`` group
are accepted so that presets carrying them still load, and have no effect
here.  In particular ``DAMSM_SIM_IMPL``, ``DAMSM_SIM_TILE``,
``DAMSM_GRID_CHUNKS``, ``DAMSM_FOLD_SOFTMAX``, ``USE_PALLAS`` and
``REMAT_IMAGE_ENCODER*`` are XLA/TPU levers that give the same values:
which implementation runs is decided by the device of the tensors (CUDA
kernel on the card, plain PyTorch on the CPU), not by a key.
``DAMSM_CHUNKS`` gives the same values in the GAN step, whose Inception is
frozen in eval mode; in DAMSM pretraining the train-mode Inception runs
over that many sequential sub-batches, each with its own BatchNorm
statistics, as in the JAX package (``train.damsm.DAMSMTrainer``; one
process only: across ranks it raises ``NotImplementedError``).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict

import torch
import yaml

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


class ConfigDict(dict):
    """dict with attribute access; values are plain Python scalars/ConfigDicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _cd(d: Dict[str, Any]) -> ConfigDict:
    out = ConfigDict()
    for k, v in d.items():
        out[k] = _cd(v) if isinstance(v, dict) else v
    return out


def default_config() -> ConfigDict:
    return _cd(
        {
            "DATASET_NAME": "birds",
            "CONFIG_NAME": "",
            "DATA_DIR": "",
            "GPU_ID": 0,
            "CUDA": True,
            "WORKERS": 6,
            "RNN_TYPE": "LSTM",  # 'LSTM' | 'GRU'
            "B_VALIDATION": False,
            "TREE": {
                "BRANCH_NUM": 3,
                "BASE_SIZE": 64,
            },
            "TRAIN": {
                "BATCH_SIZE": 64,
                "MAX_EPOCH": 600,
                "SNAPSHOT_INTERVAL": 2000,
                "DISCRIMINATOR_LR": 2e-4,
                "GENERATOR_LR": 2e-4,
                "ENCODER_LR": 2e-4,
                "RNN_GRAD_CLIP": 0.25,
                "GRAD_ACCUM": 1,
                "GRAD_ACCUM_MODE": "window",
                "FLAG": True,
                "NET_E": "",
                "NET_G": "",
                "B_NET_D": True,
                "SMOOTH": {
                    "GAMMA1": 5.0,
                    "GAMMA2": 5.0,
                    "GAMMA3": 10.0,
                    "LAMBDA": 1.0,
                },
                # G_NET_MIX: two z draws, one w code per refinement stage
                "MIXING": False,
                "CRITIC_ITER": 5,
            },
            "GAN": {
                "DF_DIM": 64,
                "GF_DIM": 128,
                "Z_DIM": 100,
                "W_DIM": 256,
                "CONDITION_DIM": 100,
                "R_NUM": 2,
                "B_ATTENTION": True,
                "B_DCGAN": False,
                "M_NUM": 6,  # mapping-network depth
                "INIT_Z_CONCAT": True,  # stage-0 input concat(c, z) or c alone
            },
            "TEXT": {
                "CAPTIONS_PER_IMAGE": 10,
                "EMBEDDING_DIM": 256,
                "WORDS_NUM": 20,
            },
            "GEN2": {
                "E_DIM": 128,
                "C_DIM": 128,
                "Z_DIM": 128,
                "W_DIM": 256,
                "A_DIM": 256,
                "WORD_DIM": 768,
                "MAX_LENGTH": 18,
                "M_LAYERS": 8,
                "M_USE_NORM": True,
                "RESOLUTION": 128,
                "RESOLUTION_INIT": 4,
                "USE_ATTENTION": False,
                "USE_NOISE": False,
                "USE_PIXEL_NORM": False,
                "USE_INSTANCE_NORM": True,
                "USE_TRUNCATION": False,
                "FMAP_BASE": 4096,
                "FMAP_MAX": 256,
                "WGAN": True,
                "WGAN_LAMBDA": 10.0,
                "BERT_VOCAB": 30522,
                "BERT_HIDDEN": 768,
                "BERT_LAYERS": 12,
                "BERT_HEADS": 12,
                "BERT_INTERMEDIATE": 3072,
            },
            "MODEL": {
                "TEXT_ENCODER": "rnn",  # 'rnn' | 'bert' (bert-base, wordpieces)
                "INCEPTION_INPUT": 299,
                "IMAGE_LOADER": "pil",
            },
            # SEED, DTYPE, LOSS_DTYPE and the MESH keys take effect in the
            # port; the rest are accepted for preset compatibility.
            "JAX": {
                "SEED": 100,
                "PLATFORM": "",
                "DTYPE": "float32",
                "MESH_DATA": -1,
                "MESH_MODEL": 1,
                "SYNC_BATCHNORM": True,
                "USE_PALLAS": False,
                "REMAT_IMAGE_ENCODER": False,
                "REMAT_IMAGE_ENCODER_MODE": "full",
                "REMAT_GENERATOR": False,
                "REMAT_GENERATOR_MODE": "stages",
                "DAMSM_CHUNKS": 1,
                "DAMSM_GRID_CHUNKS": 1,
                "DAMSM_SIM_IMPL": "xla",
                "DAMSM_SIM_TILE": 16,
                "DAMSM_FOLD_SOFTMAX": False,
                "UPBLOCK_FUSED": False,
                "UPBLOCK_FUSED_IMPL": "phase3x3",
                "BN_COMPACT": False,
                "RGB_HEAD_PAD": 0,
                "CONV_WGRAD_DOT": False,
                "TRAIN_UNROLL": 1,
                "LOSS_DTYPE": "float32",
            },
            "BENCH": {
                "WARMUP_STEPS": 5,
                "MEASURE_STEPS": 30,
                "UNROLL": 1,
            },
        }
    )


def merge_into(src: Dict[str, Any], dst: ConfigDict, _path: str = "") -> None:
    """Recursively merge ``src`` into ``dst``: unknown keys raise KeyError,
    type mismatches raise ValueError; an int is accepted for a float."""
    if src is None:
        return
    for k, v in src.items():
        where = f"{_path}{k}"
        if k not in dst:
            raise KeyError(f"{where} is not a valid config key")
        old = dst[k]
        if isinstance(old, ConfigDict):
            if not isinstance(v, dict):
                raise ValueError(
                    f"Type mismatch ({type(old)} vs. {type(v)}) for config key: {where}"
                )
            merge_into(v, old, where + ".")
            continue
        if isinstance(old, float) and isinstance(v, int) and not isinstance(v, bool):
            v = float(v)
        if (old is not None and v is not None and type(old) is not type(v)
                # tri-state flag: False | True | "large"
                and not (where == "JAX.BN_COMPACT"
                         and isinstance(old, bool) and isinstance(v, str))):
            raise ValueError(
                f"Type mismatch ({type(old)} vs. {type(v)}) for config key: {where}"
            )
        if where == "JAX.BN_COMPACT" and isinstance(v, str) and v != "large":
            raise ValueError(
                f"JAX.BN_COMPACT must be a bool or the string 'large'; got {v!r}"
            )
        dst[k] = v


def cfg_from_file(filename: str, base: ConfigDict | None = None) -> ConfigDict:
    """Load a YAML preset and merge it over the defaults."""
    cfg = base if base is not None else default_config()
    with open(filename, "r") as f:
        merge_into(yaml.safe_load(f), cfg)
    return cfg


def cfg_from_dict(d: Dict[str, Any], base: ConfigDict | None = None) -> ConfigDict:
    cfg = base if base is not None else default_config()
    merge_into(d, cfg)
    return cfg


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(key: str, value: str) -> torch.dtype:
    if value not in _DTYPES:
        raise NotImplementedError(
            f"JAX.{key}={value!r}: the port computes in float32 or bfloat16; "
            "other dtypes are not ported (ROADMAP.md, section 3)")
    return _DTYPES[value]


def compute_dtype(cfg) -> torch.dtype:
    """``JAX.DTYPE`` as a torch dtype: what the models compute in (flax's
    ``dtype=``; parameters stay float32)."""
    return _dtype("DTYPE", cfg.JAX.DTYPE)


def loss_dtype(cfg) -> torch.dtype:
    """``JAX.LOSS_DTYPE`` as a torch dtype: the operands' dtype of the
    products of the DAMSM similarity (``mm_dtype`` of K1-K3)."""
    return _dtype("LOSS_DTYPE", cfg.JAX.LOSS_DTYPE)


def preset(name: str) -> ConfigDict:
    """One of the presets shipped with the port, e.g. ``preset("eval_bird")``."""
    return cfg_from_file(os.path.join(CONFIG_DIR, f"{name}.yml"))
