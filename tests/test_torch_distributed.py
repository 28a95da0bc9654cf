"""The port's data parallelism (sba_gan_tpu_torch.parallel.dist): two ranks
over gloo, two CPU processes started through ``torch.multiprocessing`` on a
free port (tests/_torch_dist_cases.py, one world for the whole module,
300 s at most), against one process at the same global batch of 8; and
the 2-rank GAN step's logs against the JAX package's step at batch 8 (whose
8-device sharded step equals its one-device step,
tests/_mesh_cases.py:gan_sharded).

Cases, float64 modules (tiny widths: GF/DF 8, EMBEDDING 32, WORDS 6,
Inception input 75): two GAN steps (BRANCH_NUM 2) plain, and under
``GRAD_ACCUM`` 2 in 'window' and in 'dfresh'; two DAMSM pretrain steps
(the RNN encoder's dropout, the Inception's train-mode BatchNorms, the
clip); and units: the BatchNorm's statistics and gradients (4 + 4 rows,
and 4 + 3), the wrong pairs across the rank boundary with a D's loss and
gradients, the DAMSM matrices with K2's plain gradient of local columns,
and the three collectives' gradients.

The two ranks end bit-identical (logs, parameters, statistics, EMA,
accumulators).  Against one process, the sums run in another order; the
losses, the DAMSM similarity and its gradients compute in float32, the
rest in float64.  Tolerances, with the measured worst:

* logs rtol 2e-6 (1.9e-7);
* gradients (summed over ranks) of the first step atol 1e-6 of each
  tensor's largest entry (1.4e-7); of the second atol 1e-4 (3.7e-6): the
  first Adam update has moved the parameters apart;
* parameters, EMA and accumulators atol 0.1 lr (1.6e-2 lr): Adam divides
  each gradient by its size, so a 1e-7 relative gradient difference moves
  the update of an entry whose gradient is near 0 by a share of lr;
* running statistics atol 1e-5 of each tensor's largest entry (7.2e-7);
* the float64 units (BatchNorm, collectives) rtol 1e-12 (3e-16); the DAMSM
  losses and the gradients of regions, codes and sentences rtol 1e-6
  (equal), the words' gradient (K3's float32 sums) atol 1e-6 of its largest
  entry (1.7e-7); K2's plain gradient equal;
* the 2-rank step's logs against JAX's rtol 2e-5, as
  tests/test_torch_gan_step.py holds the one-process step.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_cases as C
from _torch_parity import jax_gan_state, rnn_encoder_key
from sba_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from sba_gan_tpu.train.gan import build_models as jax_build_models
from sba_gan_tpu.train.gan import make_gan_train_step as jax_make_step
from sba_gan_tpu.train.gan import noise_shape as jax_noise_shape
from sba_gan_tpu_torch.config import cfg_from_dict
from sba_gan_tpu_torch.data.pipeline import DataLoader, build_dataset
from sba_gan_tpu_torch.parallel import dist

LR = 2e-4
GAN_RUNS = {"plain": {}, "window": {"accum": 2}, "dfresh": {"accum": 2, "mode": "dfresh"}}
UNITS = ("batchnorm", "wrong_pair", "damsm", "collectives")
WORLD_TIMEOUT = 300.0


def _lower_jax_step():
    """JAX's step (float64) lowered on the port's seeded weights and the
    cases' global batch; its noise for two steps."""
    with jax.enable_x64(True):
        jcfg = jax_cfg_from_dict({**C.GAN_TINY, "JAX": {"DTYPE": "float64"}})
        jmodels = jax_build_models(jcfg, C.N_WORDS)
        state = jax_gan_state(jcfg, jmodels, C.gan_models(), rnn_encoder_key)
        imgs, captions, cap_lens, class_ids = C.global_batch(2)
        key = jax.random.PRNGKey(3)
        noise = []
        for k in range(2):  # the step's own draws: fold_in(rng, step), then z and eps
            r_z, r_ca = jax.random.split(jax.random.fold_in(key, k))
            noise.append((np.asarray(jax.random.normal(r_z, jax_noise_shape(jcfg, C.B),
                                                       jnp.float32)),
                          np.asarray(jax.random.normal(r_ca, (C.B, 8), jnp.float32))))
        args = (state, tuple(jnp.asarray(i) for i in imgs), jnp.asarray(captions, jnp.int32),
                jnp.asarray(cap_lens, jnp.int32), jnp.asarray(class_ids, jnp.int32), key)
        return jax.jit(jax_make_step(jcfg, jmodels)).lower(*args), args, noise


@pytest.fixture(scope="module")
def runs():
    """Every case in a world of two ranks and in this process, and JAX's
    step (compiled in a thread while the ranks and this process run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lowered, args, noise = _lower_jax_step()
        cases = [("gan", {**kw, **({"noise": noise} if name == "plain" else {})})
                 for name, kw in GAN_RUNS.items()]
        cases += [("pretrain", {})] + [(u, {}) for u in UNITS]
        with ThreadPoolExecutor(2) as pool:
            world = pool.submit(C.run_world, cases, 2, WORLD_TIMEOUT)
            compiling = pool.submit(lowered.compile)
            local = C.run_cases(cases)
            step = compiling.result()
            with jax.enable_x64(True):
                _, logs = step(*args)
                jax_logs = {k: float(v) for k, v in logs.items()}
            ranks = world.result()
    finally:
        torch.set_num_threads(threads)
    names = list(GAN_RUNS) + ["pretrain"] + list(UNITS)
    return {"ranks": [dict(zip(names, r, strict=True)) for r in ranks],
            "local": dict(zip(names, local, strict=True)), "jax": jax_logs}


def _rows(ranks, get):
    """The ranks' row blocks of one result, concatenated in rank order."""
    return torch.cat([get(r) for r in ranks])


def _close(got, want, rtol=0.0, atol_rel=0.0, what=""):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    atol = atol_rel * float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")


def _flat(state, prefix=""):
    """Floating tensors of a nested state dict, by dotted path."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            for i, x in enumerate(v):
                if isinstance(x, dict):
                    out.update(_flat(x, f"{prefix}{k}.{i}."))
        elif torch.is_tensor(v) and v.is_floating_point():
            out[f"{prefix}{k}"] = v
    return out


# ------------------------------------------------------------- train steps


@pytest.mark.parametrize("case", list(GAN_RUNS) + ["pretrain"])
def test_ranks_end_identical(runs, case):
    a, b = (r[case] for r in runs["ranks"])
    assert a["logs"] == b["logs"]
    fa, fb = _flat(a["state"]), _flat(b["state"])
    assert fa.keys() == fb.keys() and fa
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("case", list(GAN_RUNS) + ["pretrain"])
def test_logs_match_one_process(runs, case):
    got, want = runs["ranks"][0][case]["logs"], runs["local"][case]["logs"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=2e-6, err_msg=k)


@pytest.mark.parametrize("case", list(GAN_RUNS) + ["pretrain"])
def test_reduced_gradients_match_one_process(runs, case):
    for k, (got, want) in enumerate(zip(runs["ranks"][0][case]["grads"],
                                        runs["local"][case]["grads"])):
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            _close(got[name], w, atol_rel=1e-6 if k == 0 else 1e-4, what=f"step {k} {name}")


@pytest.mark.parametrize("case", list(GAN_RUNS) + ["pretrain"])
def test_state_matches_one_process(runs, case):
    """Parameters, EMA and accumulators atol 0.1 lr; running statistics
    atol 1e-5 of their largest entry (the optimizers' moments are what
    the gradients above already hold)."""
    got, want = _flat(runs["ranks"][0][case]["state"]), _flat(runs["local"][case]["state"])
    assert got.keys() == want.keys()
    checked = 0
    for name, w in want.items():
        if "opt." in name:
            continue
        if name.endswith(("running_mean", "running_var")):
            _close(got[name], w, atol_rel=1e-5, what=name)
        else:
            torch.testing.assert_close(got[name].double(), w.double(), rtol=0,
                                       atol=0.1 * LR, msg=lambda m, n=name: f"{n}: {m}")
        checked += 1
    assert checked > 100


@pytest.mark.parametrize("case", ["window", "dfresh"])
def test_ranks_draw_the_global_noise(runs, case):
    """The step's generator, seeded alike, draws the global batch's noise on
    every rank, as one process draws it."""
    want = runs["local"][case]["noise"]
    for r in runs["ranks"]:
        for (z, eps), (wz, weps) in zip(r[case]["noise"], want):
            assert z.shape == wz.shape == (C.B, 8)
            assert torch.equal(z, wz) and torch.equal(eps, weps)


def test_grad_accum_window_holds_until_its_end(runs):
    """Under GRAD_ACCUM 2 ('window') the state after the window carries an
    empty accumulator at micro-step 0, on both ranks as in one process."""
    for res in runs["ranks"] + [runs["local"]]:
        accum = res["window"]["state"]["accum"]
        assert accum["micro"] == 0
        assert all(not v.any() for v in accum["generator"].values())
        assert res["dfresh"]["state"]["accum"]["discriminators"] == [None, None]


def test_two_rank_step_matches_jax(runs):
    """The 2-rank step's logs (step 1, JAX's noise injected) against the
    JAX package's step at batch 8."""
    got, want = runs["ranks"][0]["plain"]["logs"][0], runs["jax"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=2e-5, err_msg=k)


# ------------------------------------------------------------------- units


@pytest.mark.parametrize("rows", ["even", "uneven"])
def test_batchnorm_global_statistics(runs, rows):
    """4 + 4 rows, and 4 + 3 (counts that differ by rank, as the wrong
    pairs give the conditional head's BatchNorm)."""
    ranks = [r["batchnorm"][rows] for r in runs["ranks"]]
    want = runs["local"]["batchnorm"][rows]
    for key in ("y", "dx"):
        _close(_rows(ranks, lambda r: r[key]), want[key], rtol=1e-12, what=key)
    for key in ("dweight", "dbias", "running_mean", "running_var"):
        for r in ranks:
            _close(r[key], want[key], rtol=1e-12, atol_rel=1e-15, what=key)


def test_wrong_pairs_cross_the_rank_boundary(runs):
    ranks = [r["wrong_pair"] for r in runs["ranks"]]
    want = runs["local"]["wrong_pair"]
    assert [r["next_rows"].tolist() for r in ranks] == [[1, 2, 3, 4], [5, 6, 7]]
    assert want["next_rows"].tolist() == list(range(1, 8))
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-6)
        for name, w in want["grads"].items():
            _close(r["grads"][name], w, atol_rel=1e-6, what=name)


def test_damsm_losses_over_the_global_matrix(runs):
    ranks = [r["damsm"] for r in runs["ranks"]]
    want = runs["local"]["damsm"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-6)
    for name in ("region", "code", "sent"):
        _close(_rows(ranks, lambda r: r["grads"][name]), want["grads"][name], rtol=1e-6,
               what=name)
    _close(_rows(ranks, lambda r: r["grads"]["words"]), want["grads"]["words"],
           atol_rel=1e-6, what="words")
    assert torch.equal(_rows(ranks, lambda r: r["k2"]), want["k2"])


@pytest.mark.parametrize("kind", ["gather", "share", "reduce"])
def test_collective_gradients(runs, kind):
    ranks = [r["collectives"] for r in runs["ranks"]]
    want = runs["local"]["collectives"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-12)
        assert torch.equal(r["cols"], want["cols"])
    _close(_rows(ranks, lambda r: r["grads"][kind]), want["grads"][kind], rtol=1e-12,
           what=kind)


# ------------------------------------------------- loader and configuration


def _tiny_cfg(**jax_keys):
    return cfg_from_dict({**C.GAN_TINY, "JAX": jax_keys})


def test_loader_shards_cover_the_global_batch():
    cfg = _tiny_cfg()
    ds = build_dataset(cfg, True, "train")
    whole = list(DataLoader(ds, 8, seed=3))
    shards = [list(DataLoader(ds, 8, seed=3, rank=r, world=2)) for r in range(2)]
    assert len(whole) == len(shards[0]) == len(shards[1]) == len(ds) // 8
    for k, batch in enumerate(whole):
        parts = [s[k] for s in shards]
        assert sum((p.keys for p in parts), ()) == batch.keys
        assert torch.equal(torch.cat([p.captions for p in parts]), batch.captions)
        assert torch.equal(torch.cat([p.cap_lens for p in parts]), batch.cap_lens)
        for b, img in enumerate(batch.imgs):
            assert torch.equal(torch.cat([p.imgs[b] for p in parts]), img)


def test_loader_refuses_ragged_batches_and_uneven_splits():
    ds = build_dataset(_tiny_cfg(), True, "train")
    with pytest.raises(ValueError, match="drop_last=False"):
        DataLoader(ds, 8, drop_last=False, rank=0, world=2)
    with pytest.raises(ValueError, match="not divisible"):
        DataLoader(ds, 9, rank=0, world=2)
    assert len(list(DataLoader(ds, 12, drop_last=False, shuffle=False))) == 3


@pytest.mark.parametrize("keys, error, match", [
    ({"MESH_DATA": 3}, ValueError, "MESH_DATA=3 differs from the world size 2"),
    ({"MESH_MODEL": 2}, NotImplementedError, "ROADMAP"),
])
def test_mesh_keys_are_checked_before_joining(monkeypatch, keys, error, match):
    """Under a torchrun environment of two ranks: a MESH_DATA other than -1
    or the world size, and MESH_MODEL 2, raise before any connection."""
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(C.free_port())).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(error, match=match):
        dist.init_distributed(_tiny_cfg(**keys), device="cpu")
    assert not dist.active()


def test_one_process_is_world_one():
    """No torchrun environment: no group, world size 1, rank 0, and every
    collective the identity; MESH_DATA 1 or -1 passes, 2 raises."""
    assert dist.init_distributed(_tiny_cfg(MESH_DATA=1), device="cpu") == torch.device("cpu")
    assert not dist.active() and dist.world_size() == 1 and dist.rank() == 0
    x = torch.arange(6.0).reshape(3, 2)
    assert dist.gather(x) is x and dist.reduce(x) is x and dist.share(x) is x
    assert torch.equal(dist.next_rows(x), x[1:])
    with pytest.raises(ValueError, match="MESH_DATA"):
        dist.init_distributed(_tiny_cfg(MESH_DATA=2), device="cpu")
    with pytest.raises(ValueError, match="not divisible by data-axis size 3"):
        dist.local_batch_size(8, 3)
