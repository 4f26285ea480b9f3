"""The port's input prefetch (``nylon_amt_tpu_torch/data/prefetch.py``)
against the JAX package's, on the CPU: the cases of
``tests/test_prefetch.py`` (order and completeness, the transfer on the
worker thread, a worker exception raised at the consumer, a prompt stop on
``close()``, run-ahead while the consumer works, and the trainer's epoch
through it), plus the host -> device transfer on CPU tensors and the
trainer's prefetched epoch bit for bit the synchronous one.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from nylon_amt_tpu.data.prefetch import prefetch as j_prefetch
from nylon_amt_tpu_torch import config as tconfig
from nylon_amt_tpu_torch.data.corpus import assemble_split
from nylon_amt_tpu_torch.data.prefetch import (DeviceTransfer, prefetch,
                                               prefetch_to_device)
from nylon_amt_tpu_torch.data.windows import WindowDataset
from nylon_amt_tpu_torch.train.loop import Trainer
from nylon_amt_tpu_torch.train.step import (create_train_state, to_device,
                                            train_step)

from test_torch_ablation import one_thread  # noqa: F401 (autouse)

TINY = dict(hid_dim=16, pf_dim=32, enc_layer=1, dec_layer=1, enc_head=2,
            dec_head=2, dropout=0.1)
FRAMES = 32     # windows of 32 + 64 frames keep the CPU's plain steps short


def test_order_and_completeness():
    items = list(range(57))
    got = list(prefetch(iter(items), depth=2))
    assert got == items == list(j_prefetch(iter(items), depth=2))
    assert list(prefetch(iter(items), depth=1)) == items
    with pytest.raises(ValueError, match="depth"):
        next(prefetch(iter(items), depth=0))


def test_transfer_runs_on_worker_thread():
    main_thread = threading.current_thread()
    seen = []

    def transfer(x):
        seen.append(threading.current_thread() is not main_thread)
        return x * 2

    got = list(prefetch(iter([1, 2, 3]), transfer=transfer))
    assert got == [2, 4, 6]
    assert seen == [True, True, True]


def test_exception_propagates():
    def gen():
        yield 1
        raise RuntimeError("gather failed")

    it = prefetch(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="gather failed"):
        list(it)


def test_early_close_stops_worker():
    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = prefetch(gen(), depth=2)
    assert next(it) == 0
    it.close()
    time.sleep(0.2)
    # the worker stopped: at most a few queue depths were produced
    assert len(produced) < 50
    assert not any(t.name == "input-prefetch" and t.is_alive()
                   for t in threading.enumerate())


def test_runahead_overlaps_consumer():
    """While the consumer works on item i, the worker gathers i+1, i+2."""
    timeline = []

    def gen():
        for i in range(4):
            timeline.append(time.perf_counter())
            yield i

    it = prefetch(gen(), depth=2)
    first = next(it)
    time.sleep(0.3)            # the consumer's "device work"
    t_resume = time.perf_counter()
    assert [first] + list(it) == [0, 1, 2, 3]
    assert sum(t < t_resume for t in timeline) >= 3


def _toy(tcfg, frames=60, seed=6):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((frames, 256)).astype(np.float32) - 4.0
    lab = {"onset": (rng.random((frames, 88)) > 0.97).astype(np.float32),
           "offset": (rng.random((frames, 88)) > 0.97).astype(np.float32),
           "mpe": rng.random((frames, 88)) > 0.8,
           "velocity": rng.integers(1, 127, (frames, 88)).astype(np.int8)}
    return assemble_split(tcfg, [feat], [lab])


def test_order_under_a_short_switch_interval():
    """Thread churn (a switch interval of 1 us) loses, repeats or reorders
    nothing, and the worker is gone once the consumer is done."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        items = list(range(20_000))
        assert list(prefetch(iter(items), transfer=lambda x: x + 1,
                             depth=3)) == [x + 1 for x in items]
    finally:
        sys.setswitchinterval(old)
    deadline = time.time() + 5
    while any(t.name == "input-prefetch" and t.is_alive()
              for t in threading.enumerate()) and time.time() < deadline:
        time.sleep(0.01)
    assert not any(t.name == "input-prefetch" and t.is_alive()
                   for t in threading.enumerate())


def test_device_transfer_on_the_cpu_is_to_device():
    """On the CPU the transfer is ``to_device``: the same tensors, and the
    worker hands them over ready to read."""
    cfg = tconfig.Config(input=tconfig.InputConfig(num_frame=FRAMES))
    ds = WindowDataset(_toy(cfg), cfg, n_slice=7)
    want = [to_device(b, "cpu") for b in ds.batches(3, pad_to_batch=True)]
    got = list(prefetch_to_device(ds.batches(3, pad_to_batch=True), "cpu"))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    t = DeviceTransfer("cpu")
    assert t.stream is None and not t.cuda


def test_trainer_epoch_uses_prefetch(tmp_path):
    """The trainer's epoch through the prefetch thread is bit for bit the
    synchronous loop (``prefetch_depth=0``) and a hand-written loop over
    the same shuffle and dropout seeds: losses, every parameter, Adam's
    moments, and both generators' states after the epoch."""
    cfg = tconfig.Config(input=tconfig.InputConfig(num_frame=FRAMES),
                         model=tconfig.ModelConfig(**TINY),
                         train=tconfig.TrainConfig(batch_size=2))
    ds = WindowDataset(_toy(cfg), cfg, n_slice=20)        # 3 windows

    def run(depth):
        trainer = Trainer(cfg, str(tmp_path / f"d{depth}"), device="cpu",
                          prefetch_depth=depth)
        state = create_train_state(cfg, 0, "cpu")
        rng, gen = np.random.default_rng(7), torch.Generator().manual_seed(1)
        state, loss = trainer.train_epoch(state, ds, rng, gen)
        return state, loss, rng, gen, trainer

    s2, loss2, rng2, gen2, trainer = run(2)
    s0, loss0, rng0, gen0, _ = run(0)

    state = create_train_state(cfg, 0, "cpu")
    rng, gen = np.random.default_rng(7), torch.Generator().manual_seed(1)
    losses = []
    for batch in ds.batches(2, shuffle=True, rng=rng, pad_to_batch=True):
        seeds = trainer.draw_seeds(cfg, gen)
        losses.append(train_step(cfg, state, to_device(batch, "cpu"), seeds,
                                 trainer.apply_fn)["loss"])
    manual = float(torch.stack(losses).sum()) / len(losses)
    assert state.step == s2.step == s0.step == 2
    assert loss2 == loss0 == manual
    for other in (s0, state):
        for (name, a), b in zip(s2.model.state_dict().items(),
                                other.model.state_dict().values()):
            assert torch.equal(a, b), name
        for p in s2.model.parameters():
            st2 = s2.optimizer.state[p]
            q = dict(zip(s2.model.parameters(), other.model.parameters()))[p]
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(st2[k], other.optimizer.state[q][k])
    assert rng2.bit_generator.state == rng0.bit_generator.state == \
        rng.bit_generator.state
    assert torch.equal(gen2.get_state(), gen.get_state())
    assert torch.equal(gen0.get_state(), gen.get_state())
