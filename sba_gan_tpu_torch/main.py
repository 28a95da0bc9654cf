"""GAN training, sampling and generation CLI (the JAX package's ``main.py``):
a YAML preset, ``--data_dir`` / ``--manualSeed`` overrides, the CUB-layout
data under ``DATA_DIR`` (or ``--synthetic``), and the mode from the preset:

* ``TRAIN.FLAG`` true: training from the latest checkpoint of the output
  directory, if any;
* else ``B_VALIDATION`` true: ``sampling('valid')``, one PNG per test item;
* else ``gen_example``: the captions of the files that
  ``{DATA_DIR}/example_filenames.txt`` names.

``TRAIN.NET_E`` names the DAMSM encoders: a checkpoint of the port's own
pretraining (:mod:`sba_gan_tpu_torch.pretrain`: an ``epoch_N.pt`` file or its
``Model`` directory, whose latest checkpoint is taken), or a reference
``text_encoder*.pth``, whose image encoder is the file of the same name with
``text_encoder`` replaced by ``image_encoder``, if it exists; the two are
told apart by what the file holds.  A reference BERT text encoder is not
imported: its load raises (ROADMAP.md, section 3).  Under
``MODEL.TEXT_ENCODER: bert`` ``TRAIN.NET_E`` names the port's own BERT
pretrain checkpoint.
``TRAIN.NET_G`` names a reference ``netG*.pth`` (EMA weights).  Empty:
random weights.  deviation: a named path that does not exist raises (the
JAX package skips it).

``MODEL.TEXT_ENCODER`` picks the vocabulary: the data set's word ids for
``rnn``, BERT's wordpieces (``data/vocab.py``) for ``bert``, in the caption
cache and in ``gen_example``'s captions.

Training runs on N ranks, one process per GPU, under ``torchrun``
(:mod:`parallel.dist`): ``TRAIN.BATCH_SIZE`` is the global batch, each rank
trains on its rows, rank 0 writes; ``JAX.MESH_DATA`` must be -1 or the
world size.  Sampling and ``gen_example`` stay one process.

Usage (on the card; ``--device cpu`` runs on the CPU):

    python -m sba_gan_tpu_torch.main \\
        --cfg sba_gan_tpu_torch/configs/bird_style.yml --synthetic --max_epoch 1
    torchrun --standalone --nproc_per_node 8 -m sba_gan_tpu_torch.main \\
        --cfg sba_gan_tpu_torch/configs/bird_style.yml --synthetic --max_epoch 1
    python -m sba_gan_tpu_torch.main \\
        --cfg sba_gan_tpu_torch/configs/bird_bert.yml --synthetic --max_epoch 1
    python -m sba_gan_tpu_torch.main \\
        --cfg sba_gan_tpu_torch/configs/eval_bird.yml --data_dir data/birds
"""

from __future__ import annotations

import argparse
import datetime
import os
import pprint
import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sba_gan_tpu_torch.config import cfg_from_file, default_config
from sba_gan_tpu_torch.data.pipeline import build_dataset
from sba_gan_tpu_torch.parallel import dist
from sba_gan_tpu_torch.utils.checkpoint import Checkpointer


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Train or sample the SBA-GAN generator")
    p.add_argument("--cfg", dest="cfg_file", type=str, default=None)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--manualSeed", type=int, default=None,
                   help="default: 100 when training, random when not")
    p.add_argument("--output_dir", type=str, default="")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic data set in place of DATA_DIR")
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_net_e(path: str) -> Tuple[Optional[Dict], Optional[Dict], Optional[str]]:
    """What ``TRAIN.NET_E`` names: (text encoder, image encoder) state dicts of
    a port pretrain checkpoint (a ``.pt`` file or a checkpoint directory, its
    latest) and None, or (None, None, path) for a reference text encoder
    file.  (None, None, None) for an empty path; a path that does not exist
    raises."""
    if not path:
        return None, None, None
    if os.path.isdir(path):
        state = Checkpointer(path).restore()
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    if "text_encoder" in state and "image_encoder" in state:
        return state["text_encoder"], state["image_encoder"], None
    if "encoder.weight" in state or any(k.startswith("bert.") for k in state):
        return None, None, path  # read, or refused, by torch_port.load_rnn_encoder
    raise ValueError(f"TRAIN.NET_E {path} is neither a pretrain checkpoint of the port "
                     "nor a reference text encoder state dict")


def load_example_captions(cfg, wordtoix) -> Dict[str, Tuple[np.ndarray, np.ndarray, None]]:
    """``{name: (ids (N, WORDS_NUM), lengths (N,), None)}`` for each file
    ``{DATA_DIR}/{name}.txt`` listed in ``{DATA_DIR}/example_filenames.txt``,
    one caption a line; the key is the name after its last ``/``.  Under
    ``MODEL.TEXT_ENCODER: bert`` the captions are BERT wordpieces with
    ``[CLS]`` and ``[SEP]``, else the data set's word ids."""
    from sba_gan_tpu_torch.data.vocab import bert_vocab_encode, encode_free_text

    data_dic = {}
    with open(os.path.join(cfg.DATA_DIR, "example_filenames.txt"), "r") as f:
        filenames = [line.strip() for line in f if line.strip()]
    for name in filenames:
        with open(os.path.join(cfg.DATA_DIR, name + ".txt"), "r") as f:
            sentences = [s for s in f.read().split("\n") if s.strip()]
        if cfg.MODEL.TEXT_ENCODER == "bert":
            ids, lens = bert_vocab_encode(sentences, cfg.TEXT.WORDS_NUM)
        else:
            ids, lens = encode_free_text(sentences, wordtoix, cfg.TEXT.WORDS_NUM)
        data_dic[name[name.rfind("/") + 1:]] = (ids, lens, None)
    return data_dic


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Runs the CLI; returns a summary: the output directory and mode; in
    training the epoch resumed from and per epoch its step count, last logs
    and seconds; else the directory written."""
    args = parse_args(argv)
    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else default_config()
    with dist.distributed(cfg, args.device) as device:
        return _run(args, cfg, device)


def _run(args, cfg, device) -> Dict:
    if dist.world_size() > 1 and not cfg.TRAIN.FLAG:
        raise NotImplementedError("sampling and gen_example across ranks are not "
                                  "ported (ROADMAP.md, queue 1, item 8): run them in one process")
    if args.data_dir:
        cfg.DATA_DIR = args.data_dir
    if args.manualSeed is None:
        args.manualSeed = 100 if cfg.TRAIN.FLAG else random.randint(1, 10000)
    cfg.JAX.SEED = args.manualSeed
    random.seed(args.manualSeed)
    np.random.seed(args.manualSeed)
    torch.manual_seed(args.manualSeed)
    if dist.is_main():
        print("Using config:")
        pprint.pprint(cfg)

    now = dist.broadcast_object(datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S"))
    output_dir = args.output_dir or os.path.join(
        "output", f"{cfg.DATASET_NAME}_{cfg.CONFIG_NAME}_{now}")
    dataset = build_dataset(cfg, args.synthetic, "train" if cfg.TRAIN.FLAG else "test")
    text_state, image_state, net_e_text = load_net_e(cfg.TRAIN.NET_E)
    net_g = cfg.TRAIN.NET_G
    if net_g and not os.path.isfile(net_g):
        raise FileNotFoundError(f"TRAIN.NET_G {net_g} does not exist")

    from sba_gan_tpu_torch.train.loop import GANTrainer

    trainer = GANTrainer(cfg, output_dir, dataset, dataset.n_words, dataset.ixtoword,
                         text_state=text_state, image_state=image_state, device=device)
    if net_g or net_e_text:
        from sba_gan_tpu_torch.utils.torch_port import image_encoder_path

        net_e_image = image_encoder_path(net_e_text) if net_e_text else None
        if net_e_text and net_e_image is None:
            print(f"no image encoder beside {net_e_text}: it keeps random weights")
        trainer.load_torch_weights(net_g=net_g or None, net_e_text=net_e_text,
                                   net_e_image=net_e_image)

    summary = {"output_dir": output_dir, "seed": args.manualSeed}
    if cfg.TRAIN.FLAG:
        resumed = trainer.ckpt.latest_step() if trainer.resume() else None
        epochs = trainer.train(max_epoch=args.max_epoch)
        summary.update(mode="train", resumed_from=resumed, epochs=epochs)
    elif cfg.B_VALIDATION:
        summary.update(mode="sampling", samples_dir=trainer.sampling("valid"))
    else:
        data_dic = load_example_captions(cfg, dataset.wordtoix)
        summary.update(mode="gen_example", gen_example_dir=trainer.gen_example(data_dic))
    return summary


if __name__ == "__main__":
    main()
