"""Cases of the port's data parallelism (sba_gan_tpu_torch.parallel.dist),
for tests/test_torch_distributed.py.

Each case takes the global batch, made from a seed, runs this rank's rows
of it and returns what the test compares (tensors and floats).  Run in one
process (no group) it is the one-process reference; :func:`run_world` runs
a list of cases in every rank of a world of CPU processes over gloo,
started through ``torch.multiprocessing`` (spawn) on a free port, and
returns each rank's results.  Imports no JAX: the workers start from a
fresh interpreter.
"""

from __future__ import annotations

import copy
import os
import socket
import tempfile
import time
import traceback

import numpy as np
import torch

from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.parallel import dist

N_WORDS, B, T = 30, 8, 6
GAN_TINY = {"TREE": {"BRANCH_NUM": 2, "BASE_SIZE": 64},
            "GAN": {"GF_DIM": 8, "DF_DIM": 8, "Z_DIM": 8, "W_DIM": 16, "CONDITION_DIM": 8,
                    "R_NUM": 1},
            "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": T},
            "MODEL": {"INCEPTION_INPUT": 75},
            "TRAIN": {"BATCH_SIZE": B, "GENERATOR_LR": 2e-4, "DISCRIMINATOR_LR": 2e-4,
                      "SMOOTH": {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0,
                                 "LAMBDA": 5.0}}}
DAMSM_TINY = {"TREE": {"BRANCH_NUM": 1, "BASE_SIZE": 64},
              "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": T},
              "MODEL": {"INCEPTION_INPUT": 75},
              "TRAIN": {"BATCH_SIZE": B}}


def gan_cfg(accum: int = 1, mode: str = "window", dcgan: bool = False):
    """GAN_TINY, with ``dcgan`` as ``GAN.B_DCGAN`` at R_NUM 0 (GDCGAN, one
    D at the final scale, 128)."""
    raw = copy.deepcopy(GAN_TINY)
    raw["TRAIN"].update(GRAD_ACCUM=accum, GRAD_ACCUM_MODE=mode)
    if dcgan:
        raw["GAN"].update(B_DCGAN=True, R_NUM=0)
    return cfg_from_dict(raw)


def global_batch(branches: int, seed: int = 5):
    """Images per branch (B, S, S, 3) float64, captions (B, T), lengths 1..T,
    class ids with repeats; numpy."""
    rng = np.random.default_rng(seed)
    imgs = [rng.uniform(-1, 1, (B, s, s, 3)) for s in (64, 128, 256)[:branches]]
    cap_lens = np.array([T, 3, 1, 5, 2, T, 4, 1], np.int64)
    captions = np.zeros((B, T), np.int64)
    for i, n in enumerate(cap_lens):
        captions[i, :n] = rng.integers(1, N_WORDS, n)
    class_ids = np.array([0, 1, 0, 2, 3, 1, 4, 2], np.int64)
    return imgs, captions, cap_lens, class_ids


def mine(x):
    """This rank's rows of a global-batch array, as a tensor."""
    x = torch.as_tensor(x)
    return x[dist.rows(x.shape[0] // dist.world_size())]


def _double(*modules):
    for m in modules:
        m.double()


def gan_models(dcgan: bool = False):
    from sba_gan_tpu_torch.train.gan import build_models

    return build_models(gan_cfg(dcgan=dcgan), N_WORDS, seed=0)


def gan(accum: int = 1, mode: str = "window", noise=None, steps: int = 2,
        dcgan: bool = False):
    """``steps`` GAN steps in float64 from the seeded models: per step the
    logs and each network's gradient (``grad``, summed over ranks), then the
    state dict.  ``noise``: per step the global (z, eps), else the step's
    own draws for the global batch (float32, which the test's float64
    models take cast), kept in the result.  ``dcgan``: GDCGAN and its one
    D (:func:`gan_cfg`)."""
    from sba_gan_tpu_torch.train.gan import GANStep, init_gan_state

    cfg = gan_cfg(accum, mode, dcgan)
    models = gan_models(dcgan)
    _double(models.text_encoder, models.image_encoder, models.generator,
            *models.discriminators)
    state = init_gan_state(cfg, models, device="cpu")
    step = GANStep(cfg, state)
    imgs, captions, cap_lens, class_ids = global_batch(cfg.TREE.BRANCH_NUM)
    batch = ([mine(i) for i in imgs], mine(captions), mine(cap_lens), mine(class_ids))
    out = {"logs": [], "grads": [], "noise": []}
    for k in range(steps):
        if noise is None:
            z, eps = step.draw_noise(B)
        else:
            z, eps = (torch.from_numpy(np.array(a)) for a in noise[k])
        out["noise"].append((z.clone(), eps.clone()))
        logs = step(*batch, z=z.double(), eps=eps.double())
        out["logs"].append({n: float(v) for n, v in logs.items()})
        nets = {"G": state.generator, **{f"D{i}": d for i, d in enumerate(state.discriminators)}}
        out["grads"].append({f"{net}.{n}": p.grad.clone() for net, m in nets.items()
                             for n, p in m.named_parameters()})
    out["state"] = copy.deepcopy(state.state_dict())
    return out


def pretrain(steps: int = 2):
    """``steps`` DAMSM pretrain steps (RNN encoder with its dropout, the
    Inception's train-mode BatchNorms) in float64: per step the logs and
    the gradients (summed over ranks, the text side clipped), then both
    encoders' state dicts."""
    from sba_gan_tpu_torch.train.damsm import DAMSMTrainer, build_damsm_models

    cfg = cfg_from_dict(DAMSM_TINY)
    models = build_damsm_models(cfg, N_WORDS, seed=0)
    _double(models.text_encoder, models.image_encoder)
    trainer = DAMSMTrainer(cfg, models, device="cpu")
    imgs, captions, cap_lens, class_ids = global_batch(1)
    out = {"logs": [], "grads": []}
    for _ in range(steps):
        logs = trainer.train_step(mine(imgs[-1]), mine(captions), mine(cap_lens),
                                  mine(class_ids))
        out["logs"].append({n: float(v) for n, v in logs.items()})
        out["grads"].append(
            {f"text.{n}": p.grad.clone() for n, p in trainer.text_encoder.named_parameters()}
            | {f"image.{n}": p.grad.clone()
               for n, p in trainer.image_encoder.named_parameters() if p.grad is not None})
    out["state"] = copy.deepcopy({"text": trainer.text_encoder.state_dict(),
                                  "image": trainer.image_encoder.state_dict()})
    return out


def _leaf(x):
    return torch.as_tensor(x).clone().requires_grad_(True)


def batchnorm():
    """A train-mode BatchNorm on the global batch (8, 3, 4, 4), and on its
    first 7 rows (4 and 3 on two ranks): outputs (this rank's rows),
    the gradients of a global loss to the input rows, scale and offset
    (summed over ranks), and the running statistics."""
    from sba_gan_tpu_torch.models.norms import BatchNorm

    rng = np.random.default_rng(1)
    x = 2.0 * rng.standard_normal((B, 3, 4, 4)) + 0.5
    w = rng.standard_normal((B, 3, 4, 4))
    out = {}
    for name, rows in (("even", B), ("uneven", B - 1)):
        bn = BatchNorm(3).double().train()
        xl = _leaf(mine(x))
        wl = mine(w)
        n = max(0, min(xl.shape[0], rows - dist.rank() * xl.shape[0]))
        y = bn(xl[:n])
        loss = dist.reduce((y * wl[:n]).sum())
        params = [bn.weight, bn.bias]
        grads = list(torch.autograd.grad(loss, [xl] + params))
        dist.all_reduce_grads_(grads[1:])
        out[name] = {"y": y.detach(), "dx": grads[0][:n], "dweight": grads[1],
                     "dbias": grads[2], "running_mean": bn.running_mean.clone(),
                     "running_var": bn.running_var.clone()}
    return out


def wrong_pair():
    """``next_rows`` of the global batch and one D's loss (its wrong pairs
    across the rank boundary) with the D's gradients."""
    from sba_gan_tpu_torch.losses.gan import discriminator_loss
    from sba_gan_tpu_torch.models.discriminator import DNet64

    torch.manual_seed(0)
    d = DNet64(8, 32).double().train()
    rng = np.random.default_rng(2)
    real = mine(rng.uniform(-1, 1, (B, 3, 64, 64)))
    fake = mine(rng.uniform(-1, 1, (B, 3, 64, 64)))
    sent = mine(rng.standard_normal((B, 32)))
    loss = discriminator_loss(d, real, fake, sent)
    grads = list(torch.autograd.grad(loss, list(d.parameters())))
    dist.all_reduce_grads_(grads)
    return {"next_rows": dist.next_rows(mine(np.arange(B, dtype=np.float64))),
            "loss": float(loss.detach()),
            "grads": {n: g for (n, _), g in zip(d.named_parameters(), grads)}}


def damsm():
    """``damsm_losses`` on random regions, codes, words and sentences (the
    global (B, B) matrices): the four losses and the gradients of their sum
    to this rank's rows of every input; and K2's plain gradient of this
    rank's images for its columns of a cotangent."""
    from sba_gan_tpu_torch.losses.damsm import damsm_losses
    from sba_gan_tpu_torch.ops.damsm_sim import damsm_sim_dimg_plain

    rng = np.random.default_rng(3)
    r, dim = 9, 16
    region, code = rng.standard_normal((B, r, dim)), rng.standard_normal((B, dim))
    words, sent = rng.standard_normal((B, T, dim)), rng.standard_normal((B, dim))
    _, _, cap_lens, class_ids = global_batch(1)
    inputs = [_leaf(mine(a)) for a in (region, code, words, sent)]
    losses = damsm_losses(*inputs, mine(cap_lens), mine(class_ids), 4.0, 5.0, 10.0)
    grads = torch.autograd.grad(sum(losses), inputs)
    g = torch.as_tensor(rng.standard_normal((B, B)), dtype=torch.float32)
    cols = dist.rows(B // dist.world_size())
    k2 = damsm_sim_dimg_plain(torch.as_tensor(words, dtype=torch.float32),
                              mine(region).float(), torch.as_tensor(cap_lens),
                              g[:, cols].contiguous())
    return {"losses": [float(v.detach()) for v in losses],
            "grads": dict(zip(("region", "code", "words", "sent"), grads)), "k2": k2}


def collectives():
    """The three differentiable collectives against one process: a global
    loss of ``gather`` (replicated consumers), of ``share`` (a replicated
    value used by this rank's rows) and of ``reduce``, and their gradients
    to this rank's rows."""
    rng = np.random.default_rng(4)
    x, a, c = (rng.standard_normal((B, 3)) for _ in range(3))
    xl = _leaf(mine(x))
    full = dist.gather(xl)  # (B, 3) on every rank
    lg = (full ** 2 * torch.as_tensor(a)).sum()
    ls = dist.reduce((dist.share(full).sum(0) * mine(c)).sum())
    lr = dist.reduce((xl ** 3).sum())
    grads = {name: torch.autograd.grad(loss, xl, retain_graph=True)[0]
             for name, loss in (("gather", lg), ("share", ls), ("reduce", lr))}
    cols = dist.gather(xl.detach().T.contiguous(), dim=1)
    return {"losses": [float(v.detach()) for v in (lg, ls, lr)], "grads": grads, "cols": cols}


CASES = {f.__name__: f for f in (gan, pretrain, batchnorm, wrong_pair, damsm, collectives)}


def run_cases(cases):
    """The results of ``cases`` [(name, kwargs)] in this process, in order."""
    return [CASES[name](**kwargs) for name, kwargs in cases]


def _worker(rank: int, world: int, port: int, cases, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        with dist.distributed(device="cpu"):
            results = run_cases(cases)
        torch.save(results, os.path.join(out, f"{rank}.pt"))
    except BaseException:
        with open(os.path.join(out, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(cases, world: int = 2, timeout: float = 300.0):
    """Each rank's results of ``cases`` in a world of ``world`` CPU
    processes over gloo; raises if a rank fails or the world outlives
    ``timeout`` seconds (its processes are killed)."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out:
        port = free_port()
        procs = [ctx.Process(target=_worker, args=(r, world, port, cases, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join(10)
        errors = [open(os.path.join(out, n)).read() for n in sorted(os.listdir(out))
                  if n.endswith(".err")]
        if late or errors or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"world of {world}: {len(late)} ranks past {timeout} s, "
                               f"exit codes {[p.exitcode for p in procs]}\n"
                               + "\n".join(errors))
        return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False)
                for r in range(world)]
