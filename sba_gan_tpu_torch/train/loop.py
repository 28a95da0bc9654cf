"""GAN training loop and samplers around the step (the JAX package's
``train/loop.py`` ``GANTrainer``).

Training: epochs of shuffled batches, the loss line every ``LOG_EVERY``
steps (the only host reads of the logs, besides the last step of each
epoch, which the summary keeps), the EMA sample and attention grid every
``IMAGE_EVERY`` steps, a checkpoint every ``TRAIN.SNAPSHOT_INTERVAL``
epochs and at the end, and resume from the latest checkpoint.

Evaluation, with the EMA generator in eval mode (``TRAIN.FLAG`` false makes
no ``Model``/``Image`` directory and no checkpointer):

* ``sampling``: one final-scale PNG ``{key}_s-1.png`` per item of the data
  set (the ragged last batch included), ``rounds`` times over;
* ``r_precision_eval``: R-precision of the DAMSM codes of one generated
  image per item;
* ``gen_example``: free-text captions -> per-stage PNGs and
  ``attention_maps.png``; with ``TRAIN.MIXING`` the style-mixing sets
  ``_mix_AB``, ``_BA``, ``_A`` and ``_B``.

deviation: the JAX package draws each batch's noise from
``jax.random.PRNGKey(seed)``; the port draws it from a CPU
``torch.Generator`` seeded with the same integer (``cnt + r * 100003`` for
``sampling``, ``7700 + cnt + r * 100003`` for R-precision, 0 for
``gen_example``, ``JAX.SEED`` for the mixing sets), so the two packages
give other images from the same seed; the same injected noise gives the
same images (tests/test_torch_sampling.py).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from sba_gan_tpu_torch.data.pipeline import DataLoader
from sba_gan_tpu_torch.train.gan import GANStep, build_models, init_gan_state, log_keys
from sba_gan_tpu_torch.train.sample import Sampler, noise_shape
from sba_gan_tpu_torch.utils.checkpoint import Checkpointer
from sba_gan_tpu_torch.utils.image import save_image, to_uint8
from sba_gan_tpu_torch.utils.platform import resolve_device
from sba_gan_tpu_torch.utils.viz import build_super_images, build_super_images2

LOG_EVERY = 100  # steps, as the JAX trainer
IMAGE_EVERY = 1000


class GANTrainer:
    """Owns the train state (random weights from ``cfg.JAX.SEED``; the
    encoders from ``text_state`` / ``image_state`` when given), the step and
    the output directory (in training, ``Model/`` checkpoints and ``Image/``
    dumps)."""

    def __init__(self, cfg, output_dir: str, dataset, n_words: int, ixtoword: Dict[int, str],
                 text_state: Optional[Dict] = None, image_state: Optional[Dict] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.output_dir = output_dir
        self.model_dir = os.path.join(output_dir, "Model")
        self.image_dir = os.path.join(output_dir, "Image")
        if cfg.TRAIN.FLAG:
            os.makedirs(self.image_dir, exist_ok=True)
        self.dataset = dataset
        self.ixtoword = ixtoword
        models = build_models(cfg, n_words, seed=cfg.JAX.SEED)
        self.state = init_gan_state(cfg, models, self.device, text_state, image_state)
        self.step_fn = GANStep(cfg, self.state)
        self.ckpt = Checkpointer(self.model_dir) if cfg.TRAIN.FLAG else None
        self.start_epoch = 0

    def save_model(self, epoch: int) -> str:
        path = self.ckpt.save(epoch, self.state.state_dict())
        print(f"Save G/Ds models @ epoch {epoch} -> {self.model_dir}", flush=True)
        return path

    def resume(self) -> bool:
        """Load the latest checkpoint of the output directory, if any (never
        in evaluation, which has no checkpointer)."""
        if self.ckpt is None:
            return False
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
                            drop_last=True, seed=cfg.JAX.SEED, device=self.device,
                            num_workers=cfg.WORKERS)
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
                                      self.ixtoword, atts[-1].float().cpu().numpy())
            paths.append(os.path.join(self.image_dir, f"attn_{gstep}.png"))
            Image.fromarray(grid).save(paths[-1])
        return paths

    def load_torch_weights(self, net_g: Optional[str] = None,
                           net_e_text: Optional[str] = None,
                           net_e_image: Optional[str] = None) -> None:
        """Reference PyTorch checkpoints (:mod:`utils.torch_port`): a
        ``netG`` file holds the EMA weights, so they go into G and its EMA;
        a ``text_encoder`` and an ``image_encoder`` file into the encoders."""
        from sba_gan_tpu_torch.utils import torch_port

        s = self.state
        if net_g:
            torch_port.load_g_net(s.generator, net_g)
            with torch.no_grad():
                for n, p in s.generator.named_parameters():
                    s.g_ema[n].copy_(p)
        if net_e_text:
            torch_port.load_rnn_encoder(s.text_encoder, net_e_text)
        if net_e_image:
            torch_port.load_cnn_encoder(s.image_encoder, net_e_image)

    def sampler(self) -> Sampler:
        """The EMA generator and the text encoder, in eval mode."""
        return Sampler(self.cfg, self.state.ema_generator(), self.state.text_encoder,
                       device=self.device)

    def _eval_loader(self) -> DataLoader:
        """The data set in order with its ragged tail, on the host (the
        sampler moves the captions)."""
        return DataLoader(self.dataset, self.cfg.TRAIN.BATCH_SIZE, shuffle=False,
                          drop_last=False, num_workers=self.cfg.WORKERS)

    def sampling(self, split_dir: str = "valid", rounds: int = 1) -> str:
        """``{output_dir}/{split_dir}/single/{key}_s-1.png`` (``/`` in the key
        as ``_``) per item, each batch's noise from seed ``cnt + r * 100003``
        (``cnt`` images written before it).  Returns the directory."""
        out = os.path.join(self.output_dir, split_dir, "single")
        os.makedirs(out, exist_ok=True)
        sampler, loader = self.sampler(), self._eval_loader()
        cnt = 0
        for r in range(rounds):
            for batch in loader:
                z, eps = sampler.draw_noise(len(batch.keys), cnt + r * 100003)
                fakes, _ = sampler.launch_with_noise(batch.captions, batch.cap_lens, z, eps)
                final = fakes[-1].float().cpu().numpy()
                for i, key in enumerate(batch.keys):
                    save_image(final[i], os.path.join(out, f"{key.replace('/', '_')}_s-1.png"))
                    cnt += 1
        print(f"sampling: wrote {cnt} images -> {out}", flush=True)
        return out

    def r_precision_eval(self, num_candidates: int = 100, trials: int = 3,
                         rounds: int = 1) -> Tuple[float, float]:
        """(mean, std) over ``trials`` candidate draws of the R-precision of
        one generated image per item (noise from seed ``7700 + cnt + r *
        100003``): the image encoder's code of the final-scale image against
        the text encoder's sentence code, same-class candidates excluded."""
        from sba_gan_tpu_torch.evaluation.r_precision import r_precision_from_codes

        s = self.state
        sampler, loader = self.sampler(), self._eval_loader()
        img_codes, sent_codes, cls_ids = [], [], []
        cnt = 0
        for r in range(rounds):
            for batch in loader:
                b = len(batch.keys)
                z, eps = sampler.draw_noise(b, 7700 + cnt + r * 100003)
                fakes, _ = sampler.launch_with_noise(batch.captions, batch.cap_lens, z, eps)
                with torch.inference_mode():
                    _, sent = s.text_encoder(batch.captions.to(self.device), batch.cap_lens)
                    _, code = s.image_encoder(fakes[-1])
                sent_codes.append(sent.float().cpu().numpy())
                img_codes.append(code.float().cpu().numpy())
                cls_ids.append(batch.class_ids.numpy())
                cnt += b
        return r_precision_from_codes(
            np.concatenate(img_codes), np.concatenate(sent_codes), np.random.default_rng(0),
            num_candidates=num_candidates, trials=trials, class_ids=np.concatenate(cls_ids))

    def gen_example(self, data_dic) -> str:
        """For each ``key -> (captions (N, T), cap_lens (N,), _)`` of
        ``data_dic``: ``gen_example/{key}/{j}_s_g{k}.png`` per caption j and
        stage k and ``attention_maps.png`` (noise from seed 0), and with
        ``TRAIN.MIXING`` the mixing sets.  Returns the root directory."""
        save_root = os.path.join(self.output_dir, "gen_example")
        sampler = self.sampler()
        for key, (captions, cap_lens, _) in data_dic.items():
            save_dir = os.path.join(save_root, key)
            os.makedirs(save_dir, exist_ok=True)
            captions = np.asarray(captions, np.int64)
            cap_lens = np.asarray(cap_lens, np.int64)
            z, eps = sampler.draw_noise(len(captions), 0)
            fakes, atts = sampler.with_noise(captions, cap_lens, z, eps)
            for k, stage in enumerate(fakes):
                for j in range(stage.shape[0]):
                    save_image(stage[j], os.path.join(save_dir, f"{j}_s_g{k}.png"))
            if atts:
                grid = build_super_images2(fakes[-1], captions, cap_lens, self.ixtoword,
                                           atts[-1])
                Image.fromarray(grid).save(os.path.join(save_dir, "attention_maps.png"))
            if self.cfg.TRAIN.MIXING:
                self._gen_mixing_variants(sampler, save_dir, captions, cap_lens)
        return save_root

    def mixing_noise(self, batch: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(z0, z1, eps) of the mixing sets: (B, Z), (B, Z), (B, CONDITION_DIM)
        in that order from a CPU generator seeded with ``JAX.SEED``."""
        gen = torch.Generator().manual_seed(int(self.cfg.JAX.SEED))
        z_dim = self.cfg.GAN.Z_DIM
        z0 = torch.randn((batch, z_dim), generator=gen)
        z1 = torch.randn((batch, z_dim), generator=gen)
        eps = torch.randn((batch, self.cfg.GAN.CONDITION_DIM), generator=gen)
        return z0, z1, eps

    def _gen_mixing_variants(self, sampler: Sampler, save_dir: str, captions, cap_lens):
        """The two style codes in both orders and each alone:
        ``{j}_mix_{AB,BA,A,B}.png``, the final-scale images."""
        z0, z1, eps = self.mixing_noise(len(captions))
        variants = {"AB": (z0, z1), "BA": (z1, z0), "A": (z0, z0), "B": (z1, z1)}
        for tag, pair in variants.items():
            fakes, _ = sampler.with_noise(captions, cap_lens, torch.stack(pair), eps)
            for j in range(fakes[-1].shape[0]):
                save_image(fakes[-1][j], os.path.join(save_dir, f"{j}_mix_{tag}.png"))
