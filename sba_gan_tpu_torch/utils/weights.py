"""Carry the JAX package's weights into the port.

The JAX package keeps its variables as nested dicts in Flax tree layout
(``CANet_0/Dense_0/kernel`` ...).  These functions turn them, as numpy
arrays, into ``state_dict``s of the port's :class:`GNet` or :class:`GDCGAN`,
``DNet64/128/256``,
:class:`RNNEncoder`, :class:`BertEncoder` and :class:`CNNEncoder`, whose
module names are the reference G_NET / D_NET / RNN_ENCODER / torchvision
Inception-v3 / HuggingFace ``BertModel`` state-dict keys.  Apart from the
discriminators, which the JAX package has no reader for, the map is the
inverse of the reference-key to Flax-path map that the JAX package uses to
read reference checkpoints:

* conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in);
* BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
* ``WordAttention_0/Dense_0/kernel`` -> the word projection ``att.conv_context``;
* the generator's RGB heads: ``GetImageG_k`` -> ``img_net{k+1}`` in GNet,
  and GDCGAN's single ``GetImageG_0`` -> ``img_net`` (``NextStageG_k`` ->
  ``h_net{k+2}`` in both).  Which layout a tree has is the config's
  ``GAN.B_DCGAN``, or, where no config is given, the tree's: refinement
  stages and a single head make a GDCGAN (at one branch the two layouts
  hold the same paths, and the GNet map is taken);
* the RNN gates copy through unchanged (both sides use torch's layout);
* BERT's ``layer_N/attention_self/query`` -> ``bert.encoder.layer.N.attention.
  self.query`` and so on (the inverse of the JAX package's ``port_bert``),
  LayerNorm scale/bias -> weight/bias, embedding tables as they are;
* the gen-2 generator and D (:func:`gen2_state_from_jax`): paths joined by
  dots, the BERT tower as above, the constant NHWC -> NCHW, and the
  transposed convolutions' kernels flipped in space;
* the gen-1 progressive G and D (:func:`progressive_state_from_jax`): paths
  joined by dots, the equalized layers' ``weight`` HWIO -> OIHW or (in,
  out) -> (out, in), the constant NHWC -> NCHW.

A Flax path with no port key raises, and the module's strict
``load_state_dict`` raises on a port key that got no value.

The parameters are float32 under any compute dtype, in both packages:
``JAX.DTYPE: bfloat16`` casts them at each call (flax's ``dtype=``, the
port's :mod:`models.layers`) and leaves the stored values, the running
statistics and the optimizer state float32.  So the map is the same for a
bfloat16 run, and a bfloat16 run's state dicts are float32.

A weights file for serving is an ``.npz`` of these trees with keys joined
by ``/``, named as the JAX package's train state names them:
``g_ema/...`` (the generator's EMA parameters), ``g/batch_stats/...`` and
``text/params/...``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_LIN = {"kernel": "weight", "bias": "bias"}
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}
_RNN = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih",
        "b_hh": "bias_hh"}


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {'a/b/c': array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """{'a/b/c': array} -> nested dict."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v)
    return tree


def _index(name: str) -> int:
    return int(name.rsplit("_", 1)[1])


def _up_block_key(prefix: str, rest) -> str:
    if rest[0] == "Conv3x3_0":
        return f"{prefix}.1.weight"
    if rest[0] == "BatchNorm_0":
        return f"{prefix}.2.{_BN[rest[-1]]}"
    raise KeyError(rest)


def g_net_key(path: Tuple[str, ...], dcgan: bool = False) -> str:
    """Port key of one Flax GNet path (with ``dcgan``, GDCGAN path), e.g.
    ('CANet_0', 'Dense_0', 'kernel') -> 'ca_net.fc.weight'.  Raises KeyError
    for a path it does not know."""
    top, leaf = path[0], path[-1]
    try:
        if top == "CANet_0":
            return f"ca_net.fc.{_LIN[leaf]}"
        if top == "MappingNet_0":
            return f"mapping_net.fc.{_index(path[1])}.weight"
        if top == "InitStageG_0":
            if path[1] == "Dense_0":
                return "h_net1.fc.0.weight"
            if path[1] == "BatchNorm_0":
                return f"h_net1.fc.1.{_BN[leaf]}"
            if path[1].startswith("UpBlock_"):
                k = _index(path[1]) + 1
                return _up_block_key(f"h_net1.upsample{k}", path[2:])
        if top.startswith("GetImageG_"):
            if dcgan:
                return {"GetImageG_0": "img_net.img.0.weight"}[top]
            return f"img_net{_index(top) + 1}.img.0.weight"
        if top.startswith("NextStageG_"):
            p = f"h_net{_index(top) + 2}"
            sub = path[1]
            if sub == "WordAttention_0":
                return f"{p}.att.conv_context.weight"
            if sub == "AdaINNorm_0":
                return f"{p}.adain.style.{_LIN[leaf]}"
            if sub.startswith("ResBlock_"):
                r = f"{p}.residual.{_index(sub)}.block"
                idx = {"Conv3x3_0": "0", "BatchNorm_0": "1",
                       "Conv3x3_1": "3", "BatchNorm_1": "4"}[path[2]]
                leaf_name = "weight" if idx in ("0", "3") else _BN[leaf]
                return f"{r}.{idx}.{leaf_name}"
            if sub == "UpBlock_0":
                return _up_block_key(f"{p}.upsample", path[2:])
    except (KeyError, IndexError, ValueError):
        pass
    raise KeyError(f"no port key for Flax {'GDCGAN' if dcgan else 'GNet'} path "
                   f"{'/'.join(path)}")


def is_dcgan_tree(params: Mapping) -> bool:
    """Whether a generator's Flax ``params`` are GDCGAN's: refinement stages
    (``NextStageG_0``) and one RGB head."""
    return "NextStageG_0" in params and "GetImageG_1" not in params


def flax_leaf_to_torch(path: Tuple[str, ...], value: np.ndarray) -> torch.Tensor:
    """One Flax leaf in torch layout: a conv kernel HWIO -> OIHW, a dense
    kernel (in, out) -> (out, in), anything else as it is."""
    v = np.array(value, dtype=np.float32)  # a writable copy
    if path[-1] == "kernel":
        v = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
    return torch.from_numpy(np.ascontiguousarray(v))


def g_net_state_dict(params: Mapping, batch_stats: Mapping,
                     dcgan: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """Flax GNet or GDCGAN ``params`` + ``batch_stats`` -> the port's
    state_dict; ``dcgan`` (``GAN.B_DCGAN``) picks the map, None reads it
    from the tree (:func:`is_dcgan_tree`)."""
    if dcgan is None:
        dcgan = is_dcgan_tree(params)
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for key, value in flatten_tree(tree).items():
            path = tuple(key.split("/"))
            name = g_net_key(path, dcgan)
            if name in sd:
                raise KeyError(f"two Flax paths map to {name}")
            sd[name] = flax_leaf_to_torch(path, value)
            if name.endswith(".running_mean"):
                sd[name[: -len("running_mean")] + "num_batches_tracked"] = (
                    torch.zeros((), dtype=torch.long))
    return sd


def rnn_encoder_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax RNNEncoder ``params`` -> the port's RNNEncoder state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flatten_tree(params).items():
        path = key.split("/")
        if path == ["embedding"]:
            name = "encoder.weight"
        elif len(path) == 2 and path[0] in ("fwd", "bwd") and path[1] in _RNN:
            suffix = "l0" if path[0] == "fwd" else "l0_reverse"
            name = f"rnn.{_RNN[path[1]]}_{suffix}"
        else:
            raise KeyError(f"no port key for Flax RNNEncoder path {key}")
        sd[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    return sd


_BERT_LAYER = {"attention_self": "attention.self", "attention_output": "attention.output.dense",
               "attention_LayerNorm": "attention.output.LayerNorm",
               "intermediate": "intermediate.dense", "output": "output.dense",
               "output_LayerNorm": "output.LayerNorm"}
_BERT_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight", "embedding": "weight"}


def bert_encoder_key(path: Tuple[str, ...]) -> str:
    """Port key of one Flax BertEncoder path, e.g. ('bert', 'layer_0',
    'attention_self', 'query', 'kernel') -> 'bert.encoder.layer.0.attention.
    self.query.weight'.  Raises KeyError for a path it does not know."""
    try:
        leaf = _BERT_LEAF[path[-1]]
        if path[0] in ("emb_words", "emb_sent") and len(path) == 2:
            return f"{path[0]}.{leaf}"
        if path[0] == "bert" and path[1] == "embeddings":
            return f"bert.embeddings.{path[2]}.{leaf}"
        if path[0] == "bert" and path[1] == "pooler" and len(path) == 3:
            return f"bert.pooler.dense.{leaf}"
        if path[0] == "bert" and path[1].startswith("layer_"):
            inner = ".".join((_BERT_LAYER[path[2]], *path[3:-1]))
            return f"bert.encoder.layer.{_index(path[1])}.{inner}.{leaf}"
    except (KeyError, IndexError, ValueError):
        pass
    raise KeyError(f"no port key for Flax BertEncoder path {'/'.join(path)}")


def bert_encoder_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax BertEncoder ``params`` -> the port's BertEncoder state_dict
    (Dense kernels transposed)."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flatten_tree(params).items():
        path = tuple(key.split("/"))
        sd[bert_encoder_key(path)] = flax_leaf_to_torch(path, value)
    return sd


def text_encoder_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax text encoder ``params``, RNN or BERT (told apart by their
    trees) -> the port's state_dict."""
    return (bert_encoder_state_dict(params) if "bert" in params
            else rnn_encoder_state_dict(params))


def cnn_encoder_state_dict(params: Mapping, batch_stats: Mapping
                           ) -> Dict[str, torch.Tensor]:
    """Flax CNNEncoder (or InceptionV3Classifier) ``params`` +
    ``batch_stats`` -> the port's CNNEncoder (or InceptionV3Classifier)
    state_dict: ``backbone/<module>/.../conv/kernel`` -> ``<module>....conv.
    weight`` (HWIO -> OIHW), ``bn`` scale/bias/mean/var -> weight/bias/
    running_mean/running_var, ``emb_features`` (1 x 1 conv, no bias),
    ``emb_cnn_code`` and the classifier's ``fc`` (dense, transposed) as they
    are named.  The inverse of the JAX package's ``port_cnn_encoder``."""
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for key, value in flatten_tree(tree).items():
            path = tuple(key.split("/"))
            if path[0] in ("emb_features", "emb_cnn_code", "fc") and len(path) == 2:
                name = f"{path[0]}.{_LIN[path[1]]}"
            elif path[0] == "backbone" and path[-2] == "conv" and path[-1] == "kernel":
                name = ".".join(path[1:-1]) + ".weight"
            elif path[0] == "backbone" and path[-2] == "bn" and path[-1] in _BN:
                name = ".".join(path[1:-1]) + "." + _BN[path[-1]]
            else:
                raise KeyError(f"no port key for Flax CNNEncoder path {key}")
            sd[name] = flax_leaf_to_torch(path, value)
            if name.endswith(".running_mean"):
                sd[name[: -len("running_mean")] + "num_batches_tracked"] = (
                    torch.zeros((), dtype=torch.long))
    return sd


_D_STAGES = {"down32": "img_code_s32", "block32": "img_code_s32_1",
             "down64": "img_code_s64", "block64_1": "img_code_s64_1",
             "block64_2": "img_code_s64_2"}
# a block's conv and BN inside the reference's Sequential: (conv, BN) index
_D_BLOCK = {"Conv_0": "0", "Conv3x3_0": "0", "BatchNorm_0": "1"}


def d_net_key(path: Tuple[str, ...]) -> str:
    """Port key of one Flax DNet64/128/256 path, e.g.
    ('backbone', 'DownBlock_1', 'Conv_0', 'kernel') -> 'img_code_s16.5.weight'.
    Raises KeyError for a path it does not know."""
    top, leaf = path[0], path[-1]
    name = "weight" if leaf == "kernel" else _BN.get(leaf, leaf)
    try:
        if top == "backbone":
            if path[1] == "Conv_0":
                return "img_code_s16.0.weight"
            k = _index(path[1])  # DownBlock_k: conv at 2 + 3k, BN at 3 + 3k
            return f"img_code_s16.{2 + 3 * k + int(_D_BLOCK[path[2]])}.{name}"
        if top in _D_STAGES:
            return f"{_D_STAGES[top]}.{_D_BLOCK[path[1]]}.{name}"
        if top in ("cond_head", "uncond_head"):
            head = "COND_DNET" if top == "cond_head" else "UNCOND_DNET"
            if path[1] == "Conv_0":
                return f"{head}.outlogits.0.{_LIN[leaf]}"
            if top == "cond_head" and path[1] == "Block3x3LeakRelu_0":
                return f"{head}.jointConv.{_D_BLOCK[path[2]]}.{name}"
    except (KeyError, IndexError, ValueError):
        pass
    raise KeyError(f"no port key for Flax DNet path {'/'.join(path)}")


def d_net_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """Flax DNet64/128/256 ``params`` + ``batch_stats`` -> the port's DNet
    state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for key, value in flatten_tree(tree).items():
            path = tuple(key.split("/"))
            name = d_net_key(path)
            if name in sd:
                raise KeyError(f"two Flax paths map to {name}")
            sd[name] = flax_leaf_to_torch(path, value)
            if name.endswith(".running_mean"):
                sd[name[: -len("running_mean")] + "num_batches_tracked"] = (
                    torch.zeros((), dtype=torch.long))
    return sd


def gan_state_from_jax(state: Mapping, dcgan: Optional[bool] = None) -> Dict[str, Any]:
    """A JAX ``GANTrainState`` as nested numpy dicts (``g`` with ``params``
    and ``batch_stats``, ``g_ema``, ``ds`` a sequence of ``params`` +
    ``batch_stats``, ``text`` and ``image`` variables) -> the port's state
    dicts: ``generator``, ``g_ema`` (G's parameters only), ``discriminators``
    (a list), ``text_encoder`` (RNN or BERT) and ``image_encoder``.  G's map
    is ``dcgan``'s (``GAN.B_DCGAN``), or with None the tree's.  Optimizer
    moments are not carried."""
    if dcgan is None:
        dcgan = is_dcgan_tree(state["g"]["params"])
    g_ema = g_net_state_dict(state["g_ema"], {}, dcgan)
    return {
        "generator": g_net_state_dict(state["g"]["params"], state["g"]["batch_stats"],
                                      dcgan),
        "g_ema": g_ema,
        "discriminators": [d_net_state_dict(d["params"], d["batch_stats"])
                           for d in state["ds"]],
        "text_encoder": text_encoder_state_dict(state["text"]["params"]),
        "image_encoder": cnn_encoder_state_dict(state["image"]["params"],
                                                state["image"]["batch_stats"]),
    }


_GEN2_LEAF = {"kernel": "weight", "bias": "bias", "weight": "weight"}


def gen2_key(path: Tuple[str, ...]) -> str:
    """Port key of one Flax ``Gen2Generator`` or ``Gen2DNet`` path: the BERT
    tower through :func:`bert_encoder_key` (``bert_embedding/bert/...`` ->
    ``bert_embedding.bert.embeddings...``), every other path joined with
    dots, ``kernel`` -> ``weight``."""
    if path[:2] == ("bert_embedding", "bert"):
        return "bert_embedding." + bert_encoder_key(path[1:])
    if path in (("const",), ("bias",)):
        return path[0]
    if path[-1] not in _GEN2_LEAF:
        raise KeyError(f"no port key for Flax gen-2 path {'/'.join(path)}")
    return ".".join((*path[:-1], _GEN2_LEAF[path[-1]]))


def gen2_leaf_to_torch(path: Tuple[str, ...], value: np.ndarray) -> torch.Tensor:
    """One Flax gen-2 leaf in torch layout: the constant NHWC -> NCHW; a
    transposed convolution's kernel (kh, kw, in, out) flipped in space and
    laid out (in, out, kh, kw), which makes torch's ``conv_transpose2d``
    with padding 1 Flax's 'SAME' ``ConvTranspose``; the rest as
    :func:`flax_leaf_to_torch`."""
    if path == ("const",):
        return torch.from_numpy(np.ascontiguousarray(
            np.transpose(np.asarray(value, np.float32), (0, 3, 1, 2))))
    if path[-2:] == ("up_conv", "kernel"):
        v = np.asarray(value, np.float32)[::-1, ::-1].transpose(2, 3, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(v))
    return flax_leaf_to_torch(path, value)


def gen2_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``Gen2Generator`` or ``Gen2DNet`` ``params`` -> the port's
    state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flatten_tree(params).items():
        path = tuple(key.split("/"))
        sd[gen2_key(path)] = gen2_leaf_to_torch(path, value)
    return sd


def gen2_state_from_jax(g_params: Mapping, d_params: Mapping,
                        enc_params: Optional[Mapping] = None,
                        enc_batch_stats: Optional[Mapping] = None,
                        g_ema: Optional[Mapping] = None) -> Dict[str, Any]:
    """The JAX gen-2 trees (as numpy) -> the port's state dicts:
    ``generator``, ``g_ema`` (G's EMA, else a copy of G), ``dnet`` and,
    given its params and ``batch_stats``, ``image_encoder`` (the Inception
    trunk's keys and ``fc``, as :func:`cnn_encoder_state_dict`).  RMSprop
    moments are not carried."""
    generator = gen2_state_dict(g_params)
    return {
        "generator": generator,
        "g_ema": generator if g_ema is None else gen2_state_dict(g_ema),
        "dnet": gen2_state_dict(d_params),
        "image_encoder": (None if enc_params is None
                          else cnn_encoder_state_dict(enc_params, enc_batch_stats or {})),
    }


def progressive_leaf_to_torch(path: Tuple[str, ...], value: np.ndarray) -> torch.Tensor:
    """One Flax leaf of the gen-1 progressive G or D in torch layout: the
    constant (1, S, S, C) -> (1, C, S, S), an equalized conv's ``weight`` HWIO
    -> OIHW, an equalized dense's ``weight`` (in, out) -> (out, in), biases
    and noise gains as they are."""
    v = np.array(value, dtype=np.float32)  # a writable copy
    if path[-2:] == ("const", "input"):
        v = np.transpose(v, (0, 3, 1, 2))
    elif path[-1] == "weight" and v.ndim == 4:
        v = np.transpose(v, (3, 2, 0, 1))
    elif path[-1] == "weight" and v.ndim == 2:
        v = v.T
    return torch.from_numpy(np.ascontiguousarray(v))


def progressive_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``StyledGenerator`` or ``ProgressiveDiscriminator`` ``params`` ->
    the port's state_dict: paths joined with dots (the port's modules carry
    the Flax names), leaves by :func:`progressive_leaf_to_torch`."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flatten_tree(params).items():
        path = tuple(key.split("/"))
        if path[-1] not in ("weight", "bias", "input"):
            raise KeyError(f"no port key for Flax progressive path {key}")
        sd[".".join(path)] = progressive_leaf_to_torch(path, value)
    return sd


def progressive_state_from_jax(g_params: Mapping, d_params: Mapping,
                               g_ema: Optional[Mapping] = None) -> Dict[str, Any]:
    """The JAX gen-1 trees (as numpy) -> the port's ``generator``, ``g_ema``
    (G's EMA, else a copy of G) and ``discriminator`` state dicts.  Adam's
    moments are not carried."""
    generator = progressive_state_dict(g_params)
    return {"generator": generator,
            "g_ema": generator if g_ema is None else progressive_state_dict(g_ema),
            "discriminator": progressive_state_dict(d_params)}


def read_npz(path: str) -> Tuple[Dict, Dict, Dict]:
    """A serving weights file -> (g_ema params, g batch_stats, text params),
    as trees; :func:`g_net_state_dict` maps the generator's with the
    config's layout, or the tree's."""
    with np.load(path) as z:
        tree = unflatten_tree({k: z[k] for k in z.files})
    try:
        return tree["g_ema"], tree["g"]["batch_stats"], tree["text"]["params"]
    except KeyError as e:
        raise KeyError(f"{path} lacks the tree {e}; want keys g_ema/..., "
                       "g/batch_stats/... and text/params/...") from e
