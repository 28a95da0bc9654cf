"""The port's profiling hooks against the JAX package's: ``StepTimer``'s
rolling window under one patched clock (ms/batch, images/s), and ``trace``
/ ``annotate`` on the CPU writing a Chrome trace that holds the annotated
range and the ops inside it."""

import glob
import json
import time

import numpy as np
import pytest
import torch

from sba_gan_tpu.utils import profiling as jax_profiling
from sba_gan_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs six
    test processes on the CPU, and small ops slow down by an order of
    magnitude when every process spins eight threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ticks(timer, monkeypatch, steps, **one_batch):
    """Tick ``timer`` at the times of ``steps`` ((seconds since the last
    tick, images), ...) on a patched clock, one step a tick."""
    now = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    timer.tick()
    readings = []
    for dt, images in steps:
        now[0] += dt
        timer.tick(images, **one_batch)
        readings.append((timer.ms_per_batch, timer.images_per_sec()))
    return readings


@pytest.mark.parametrize("window", [3, 50])
def test_step_timer_matches_jax(monkeypatch, window):
    rng = np.random.default_rng(window)
    steps = [(float(rng.uniform(0.01, 0.5)), int(rng.integers(8, 64))) for _ in range(60)]
    got = _ticks(profiling.StepTimer(window), monkeypatch, steps)
    want = _ticks(jax_profiling.StepTimer(window), monkeypatch, steps, n_batches=1)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert all(np.isfinite(r).all() for r in got)


def test_step_timer_before_a_window():
    timer = profiling.StepTimer()
    assert np.isnan(timer.ms_per_batch) and np.isnan(timer.images_per_sec())
    timer.tick(32)  # the first tick starts the clock and counts nothing
    assert np.isnan(timer.ms_per_batch) and np.isnan(timer.images_per_sec())


def test_trace_writes_the_annotated_range(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("data"):
            y = x @ x
        with profiling.annotate("step"):
            y = torch.relu(y).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"data", "step", "aten::mm", "aten::relu"} <= names
    data = next(e for e in events if e.get("name") == "data")
    mm = next(e for e in events if e.get("name") == "aten::mm")
    assert data["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= data["ts"] + data["dur"]
    assert {"data", "step"} <= {e.key for e in prof.key_averages()}


def test_annotate_outside_a_trace_is_free():
    with profiling.annotate("data"):
        assert float(torch.ones(3).sum()) == 3.0
