"""GAN training loop around the step (the JAX package's ``train/loop.py``
``GANTrainer``): epochs of shuffled batches, the loss line every
``LOG_EVERY`` steps (the only host reads of the logs, besides the last
step of each epoch, which the summary keeps), the EMA sample and attention
grid every ``IMAGE_EVERY`` steps, a checkpoint every
``TRAIN.SNAPSHOT_INTERVAL`` epochs and at the end, and resume from the
latest checkpoint.

``sampling``, ``gen_example`` and ``r_precision_eval`` are not ported yet.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import torch
from PIL import Image

from sba_gan_tpu_torch.data.pipeline import DataLoader
from sba_gan_tpu_torch.train.gan import GANStep, build_models, init_gan_state, log_keys
from sba_gan_tpu_torch.train.sample import noise_shape
from sba_gan_tpu_torch.utils.checkpoint import Checkpointer
from sba_gan_tpu_torch.utils.image import to_uint8
from sba_gan_tpu_torch.utils.platform import resolve_device
from sba_gan_tpu_torch.utils.viz import build_super_images

LOG_EVERY = 100  # steps, as the JAX trainer
IMAGE_EVERY = 1000


class GANTrainer:
    """Owns the train state (random weights from ``cfg.JAX.SEED``; the
    encoders from ``text_state`` / ``image_state`` when given), the step and
    the output directory (``Model/`` checkpoints, ``Image/`` dumps)."""

    def __init__(self, cfg, output_dir: str, dataset, n_words: int, ixtoword: Dict[int, str],
                 text_state: Optional[Dict] = None, image_state: Optional[Dict] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.output_dir = output_dir
        self.model_dir = os.path.join(output_dir, "Model")
        self.image_dir = os.path.join(output_dir, "Image")
        os.makedirs(self.image_dir, exist_ok=True)
        self.dataset = dataset
        self.ixtoword = ixtoword
        models = build_models(cfg, n_words, seed=cfg.JAX.SEED)
        self.state = init_gan_state(cfg, models, self.device, text_state, image_state)
        self.step_fn = GANStep(cfg, self.state)
        self.ckpt = Checkpointer(self.model_dir)
        self.start_epoch = 0

    def save_model(self, epoch: int) -> str:
        path = self.ckpt.save(epoch, self.state.state_dict())
        print(f"Save G/Ds models @ epoch {epoch} -> {self.model_dir}", flush=True)
        return path

    def resume(self) -> bool:
        """Load the latest checkpoint of the output directory, if any."""
        epoch = self.ckpt.latest_step()
        if epoch is None:
            return False
        self.state.load_state_dict(self.ckpt.restore(epoch))
        self.start_epoch = epoch + 1
        print(f"Resumed from epoch {epoch}", flush=True)
        return True

    def train(self, max_epoch: Optional[int] = None) -> List[Dict]:
        """Runs the epochs from ``start_epoch``; returns per epoch its step
        count, the last step's logs as floats and the seconds it took."""
        cfg = self.cfg
        max_epoch = cfg.TRAIN.MAX_EPOCH if max_epoch is None else max_epoch
        loader = DataLoader(self.dataset, cfg.TRAIN.BATCH_SIZE, shuffle=True,
                            drop_last=True, seed=cfg.JAX.SEED, device=self.device)
        n_ds = len(self.state.discriminators)
        bs = cfg.TRAIN.BATCH_SIZE
        epochs = []
        t_log, since_log = time.perf_counter(), 0
        for epoch in range(self.start_epoch, max_epoch):
            t0 = time.time()
            logs, steps = None, 0
            for batch in loader:
                logs = self.step_fn(batch.imgs, batch.captions, batch.cap_lens,
                                    batch.class_ids)
                steps += 1
                since_log += 1
                gstep = self.state.step
                if gstep % LOG_EVERY == 0:
                    values = {k: float(v) for k, v in logs.items()}  # fences the window
                    ms = (time.perf_counter() - t_log) * 1e3 / since_log
                    t_log, since_log = time.perf_counter(), 0
                    d_str = " ".join(f"errD{i}: {values[f'errD{i}']:.2f}" for i in range(n_ds))
                    print(f"[{epoch}][{gstep}] {d_str} errG: {values['errG']:.2f} "
                          f"kl: {values['kl_loss']:.4f} | {ms:.0f} ms/batch "
                          f"{bs * 1e3 / ms:.1f} img/s", flush=True)
                if gstep % IMAGE_EVERY == 0:
                    self.save_img_results(batch, gstep)
            last = {k: float(logs[k]) for k in log_keys(n_ds)} if logs is not None else {}
            seconds = time.time() - t0
            print(f"[{epoch}/{max_epoch}] {steps} steps, time: {seconds:.1f}s", flush=True)
            epochs.append({"epoch": epoch, "steps": steps, "logs": last, "seconds": seconds})
            if (epoch + 1) % cfg.TRAIN.SNAPSHOT_INTERVAL == 0:
                self.save_model(epoch)
        if epochs:
            self.save_model(max_epoch - 1)
        return epochs

    @torch.no_grad()
    def save_img_results(self, batch, gstep: int) -> List[str]:
        """The EMA generator's sample of the batch's captions (eval mode,
        noise from ``gstep``): the first final-scale image, and the
        attention grid of the last refinement stage."""
        s = self.state
        g = s.ema_generator()
        b = batch.captions.shape[0]
        gen = torch.Generator().manual_seed(int(gstep))
        z = torch.randn(noise_shape(self.cfg, b), generator=gen).to(self.device)
        eps = torch.randn((b, self.cfg.GAN.CONDITION_DIM), generator=gen).to(self.device)
        words, sent = s.text_encoder(batch.captions, batch.cap_lens)
        fakes, atts, _, _ = g(z, sent, words, batch.captions == 0, eps)
        paths = [os.path.join(self.image_dir, f"G_avg_{gstep}_0.png")]
        Image.fromarray(to_uint8(fakes[-1][0].cpu().numpy())).save(paths[0])
        if atts:
            stage = fakes[-2] if len(fakes) > 1 else fakes[-1]
            grid = build_super_images(stage.cpu().numpy(), batch.captions.cpu().numpy(),
                                      self.ixtoword, atts[-1].cpu().numpy())
            paths.append(os.path.join(self.image_dir, f"attn_{gstep}.png"))
            Image.fromarray(grid).save(paths[-1])
        return paths

    def sampling(self, split_dir: str = "valid", rounds: int = 1):
        raise NotImplementedError("GANTrainer.sampling is not ported yet (ROADMAP.md, "
                                  "queue 1, item 3)")

    def gen_example(self, data_dic):
        raise NotImplementedError("GANTrainer.gen_example is not ported yet (ROADMAP.md, "
                                  "queue 1, item 3)")

    def r_precision_eval(self, *args, **kwargs):
        raise NotImplementedError("GANTrainer.r_precision_eval is not ported yet "
                                  "(ROADMAP.md, queue 1, item 5)")
