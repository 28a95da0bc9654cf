"""Readings behind the bounds of ``chip_smoke.py``'s GAN-step check.

    python3 scripts/torch_gan_step_readings.py

Runs ``chip_smoke.py``'s comparison of one full-width GAN train step
(bird_style, WORDS_NUM 18, batch 8) on the card against the CPU for each of
SEEDS (each seed draws other weights, batch and noise) and prints one JSON
line of readings per seed.  Then, on the first seed's inputs, it runs the
card's still-D step and the DAMSM terms' image gradient with a fault put in
on purpose and prints what each reads against the CPU's: K2's image
gradient or K4's context scaled by 1 + delta, K2's gradient dropped, and
TF32 convolutions (against the CPU's float32 step, as a wrong precision).
The last line holds, per reading, the largest over the seeds (the least of
the shares).  Needs a CUDA card; float32 with TF32 off unless
stated.
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

SEEDS = range(5)
SCALAR = ("logs", "stats", "d_grads", "g_grads", "damsm_img_grad",
          "params_agreeing_excess", "params_adam_excess", "params_max_over_lr",
          "ema_excess")
SHARES = ("params_agree_share", "params_sign_share")
BOUNDED = ("d_grads", "g_grads", "damsm_img_grad")


def scaled(module, name, factor):
    """Patches ``module.name`` (a kernel launch) so that its first output
    is multiplied by ``factor``; returns the undo."""
    launch = getattr(module, name)

    def wrong(*args):
        out = launch(*args)
        if isinstance(out, tuple):
            return (out[0] * factor,) + out[1:]
        return out * factor
    setattr(module, name, wrong)
    return lambda: setattr(module, name, launch)


def faults(seed):
    """Each fault's readings against the CPU's still-D float32 step."""
    from sba_gan_tpu_torch.ops import damsm_sim as dsim
    from sba_gan_tpu_torch.ops import word_attention as wa
    from sba_gan_tpu_torch.train.gan import log_keys

    cfg, models, batch, z, eps = cs.gan_step_inputs(seed)
    still = cs.still_ds(cfg)
    keys = log_keys(cfg.TREE.BRANCH_NUM)
    with cs.tf32(cudnn=False, matmul=False):
        want = cs.gan_step_run(still, models, batch, z, eps, "cpu")
        want_damsm = cs.damsm_grad_run(cfg, models, batch, "cpu")
    cases = [("k2_x1.01", dsim, "launch_dimg", 1.01), ("k2_x1.1", dsim, "launch_dimg", 1.1),
             ("k2_x0", dsim, "launch_dimg", 0.0), ("k4_ctx_x1.01", wa, "_launch", 1.01),
             ("tf32_convolutions", None, None, None)]
    out = {}
    for label, module, name, factor in cases:
        undo = scaled(module, name, factor) if module is not None else (lambda: None)
        flags = cs.GAN_TF32 if module is None else dict(cudnn=False, matmul=False)
        try:
            with cs.tf32(**flags):
                got = cs.gan_step_run(still, models, batch, z, eps, "cuda")
                got_damsm = cs.damsm_grad_run(cfg, models, batch, "cuda")
        finally:
            undo()
        errs = cs.grad_errs(got, want)
        ok = cs.agreeing(got, want, list(want["grads"]))
        out[label] = {
            "logs": max(abs(got["logs"][k] - want["logs"][k]) / abs(want["logs"][k])
                        for k in keys),
            "d_grads": errs["d_grads"], "g_grads": errs["g_grads"],
            "damsm_img_grad": cs._norm_rel(got_damsm["grad"], want_damsm["grad"]),
            "grads_agree_share": sum(int(v.sum()) for v in ok.values())
            / sum(v.numel() for v in ok.values()),
        }
        print(json.dumps({"fault": label, **out[label]}), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gan_step_readings: CUDA is not available", file=sys.stderr)
        return 1
    cs.phase_device()
    cs.phase_build()
    per_seed = []
    for seed in SEEDS:
        cfg, runs = cs.gan_step_runs(seed)
        r = cs.gan_step_readings(cfg, runs)
        r["failures"] = cs.gan_step_failures(r)
        print(json.dumps({"seed": seed, **r}), flush=True)
        per_seed.append(r)
    wrong = faults(SEEDS[0])
    largest = {k: max(r[k] for r in per_seed) for k in SCALAR}
    largest.update({k: min(r[k] for r in per_seed) for k in SHARES})
    largest["float64"] = {side: {k: max(r["float64"][side][k] for r in per_seed)
                                 for k in BOUNDED} for side in ("card_f32", "cpu_f32")}
    largest["tf32"] = {k: max(r["tf32"][k] for r in per_seed) for k in cs.GAN_TF32_TOL}
    print(json.dumps({"seeds": list(SEEDS), "largest": largest, "faults": wrong}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
