"""Reference PyTorch checkpoints into the port's modules (the counterpart of
the JAX package's ``utils/torch_port.py``).

The port's :class:`GNet`, :class:`RNNEncoder`, :class:`CNNEncoder` and
:class:`InceptionV3Classifier` carry the reference's state-dict keys
(G_NET, RNN_ENCODER, CNN_ENCODER, torchvision's ``inception_v3``), so a
reference file loads by its keys with no map; one layout differs: the word
projection ``h_netJ.att.conv_context`` is the reference's 1 x 1 conv
(idf, cdf, 1, 1) and the port's linear (idf, cdf).  As in the JAX package,
``num_batches_tracked`` (either side) and torchvision's auxiliary
classifier ``AuxLogits`` are skipped; every other key must match both
ways, and every shape.  A text encoder of another vocabulary raises, naming
both sizes; it is never cut or padded.

:func:`load_bert` takes HuggingFace's ``bert-base-uncased`` state dict (the
JAX package's ``port_bert``) into the transformer of the port's
:class:`BertEncoder`.  A reference ``bird_bert`` text encoder file (its
``BertEncoder`` of ``model_bert.py``) is not read: neither package has its
import, and :func:`load_rnn_encoder` refuses it.

Files are read with ``torch.load(..., weights_only=True)`` on the CPU.
A reference G_DCGAN ``netG`` is not imported either: the JAX package has no
import of it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn

_SKIPPED_LEAF = "num_batches_tracked"
_SKIPPED_MODULE = "AuxLogits"


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict, on the CPU."""
    return dict(torch.load(path, map_location="cpu", weights_only=True))


def load_reference(module: nn.Module, state_dict: Dict[str, torch.Tensor],
                   what: str) -> None:
    """Copy a reference state dict into ``module``: strict but for the
    skipped keys (KeyError naming the keys that differ; RuntimeError from
    torch for a shape that differs)."""
    sd = {k: v for k, v in state_dict.items()
          if k.rsplit(".", 1)[-1] != _SKIPPED_LEAF and k.split(".", 1)[0] != _SKIPPED_MODULE}
    own = {k for k in module.state_dict() if k.rsplit(".", 1)[-1] != _SKIPPED_LEAF}
    missing, unexpected = sorted(own - set(sd)), sorted(set(sd) - own)
    if missing or unexpected:
        raise KeyError(f"{what}: {len(missing)} keys missing from the file "
                       f"{missing[:4]}, {len(unexpected)} unexpected {unexpected[:4]}")
    module.load_state_dict(sd, strict=False)


def refuse_dcgan_net_g(path: str) -> None:
    """Raises: a reference G_DCGAN ``netG`` is not imported, as the JAX
    package imports none (its ``port_g_net`` maps G_NET's layout only)."""
    raise NotImplementedError(
        f"netG {path}: a reference G_DCGAN generator (GAN.B_DCGAN) is not imported "
        "(ROADMAP.md, queue 1, item 3); the port trains, saves and resumes its own")


def load_g_net(generator: nn.Module, path: str) -> None:
    """A reference ``netG_epoch_*.pth`` (EMA weights, as the reference saves
    them) into the port's GNet; a GDCGAN raises (:func:`refuse_dcgan_net_g`)."""
    from sba_gan_tpu_torch.models.generator import GDCGAN

    if isinstance(generator, GDCGAN):
        refuse_dcgan_net_g(path)
    sd = {k: v[:, :, 0, 0] if k.endswith("att.conv_context.weight") and v.dim() == 4 else v
          for k, v in load_state_dict_file(path).items()}
    load_reference(generator, sd, f"netG {path}")


def load_rnn_encoder(encoder: nn.Module, path: str) -> None:
    """A reference ``text_encoder*.pth`` into the port's RNNEncoder, whose
    embedding has the dataset's vocabulary size."""
    sd = load_state_dict_file(path)
    if any(k.startswith("bert.") for k in sd):
        raise NotImplementedError(
            f"text encoder {path}: a reference BERT text encoder is not imported "
            "(ROADMAP.md, section 3); train one with the port's pretrain.py and "
            "name its checkpoint in TRAIN.NET_E")
    if not hasattr(encoder, "rnn"):
        raise ValueError(f"text encoder {path} is a reference RNN text encoder; the "
                         "model's text encoder is BERT (MODEL.TEXT_ENCODER: bert)")
    got, want = sd["encoder.weight"].shape[0], encoder.encoder.weight.shape[0]
    if got != want:
        raise ValueError(f"text encoder {path} has a vocabulary of {got} words; the "
                         f"data set's caption vocabulary has {want}")
    load_reference(encoder, sd, f"text encoder {path}")


def load_cnn_encoder(model: nn.Module, path: str) -> None:
    """A reference ``image_encoder*.pth`` into the port's CNNEncoder, or a
    torchvision ``inception_v3`` state dict into the InceptionV3Classifier."""
    load_reference(model, load_state_dict_file(path), f"Inception {path}")


def image_encoder_path(text_encoder_path: str) -> Optional[str]:
    """The image encoder beside a reference text encoder: the path with
    ``text_encoder`` replaced by ``image_encoder``, if that file exists."""
    path = text_encoder_path.replace("text_encoder", "image_encoder")
    return path if path != text_encoder_path and os.path.isfile(path) else None


_HF_BUFFERS = ("position_ids", "token_type_ids")  # non-parameter buffers of some versions
_HF_OLD_LEAF = {"gamma": "weight", "beta": "bias"}  # LayerNorm names of old checkpoints


def load_bert(encoder: nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """A HuggingFace ``BertModel`` / ``BertForPreTraining`` state dict, keys with
    or without ``bert.``, into ``encoder.bert`` (a :class:`BertEncoder`): the
    ``cls.*`` heads and the position/token-type id buffers are dropped, the
    projection heads ``emb_words`` / ``emb_sent`` keep their weights.
    Strict otherwise: a key that differs raises ``KeyError``."""
    sd = {}
    for key, v in state_dict.items():
        k = key[len("bert."):] if key.startswith("bert.") else key
        if k.startswith("cls.") or k.rsplit(".", 1)[-1] in _HF_BUFFERS:
            continue
        head, leaf = k.rsplit(".", 1)
        sd[f"{head}.{_HF_OLD_LEAF.get(leaf, leaf)}"] = v
    load_reference(encoder.bert, sd, "BERT state dict")
