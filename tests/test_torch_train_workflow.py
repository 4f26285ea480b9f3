"""The port's training workflow beyond the core loop, on the CPU.

* ``train/metrics.py``: ``intervals_from_rolls`` equal to JAX's, and the
  test pass (``make_note_metrics_fn``) within 1e-6 per key of JAX's on the
  same weights (``params_from_jax``);
* the preemption guard: SIGUSR1 during epoch 1, then ``resume="auto"``,
  ends bit for bit as an uninterrupted run (as ``tests/test_train.py``
  holds the JAX trainer);
* ``cli train --init-from`` (a fresh state with the checkpoint's
  parameters) and its mismatch error, ``load_params`` / ``merge_params``;
* ``cli train --valid-test --test-metrics --trace``: ``loss_test`` every
  (epoch, div), ``test_performance.json``, a non-empty trace;
* ``cli transcribe --checkpoint DIR [--epoch E --div D]``: the best or
  the given checkpoint.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

import jax

from nylon_amt_tpu import config as jconfig
from nylon_amt_tpu.data.corpus import assemble_split as j_assemble
from nylon_amt_tpu.data.windows import WindowDataset as JWindowDataset
from nylon_amt_tpu.train import metrics as jmetrics
from nylon_amt_tpu.train.step import create_train_state as j_create_state
from nylon_amt_tpu_torch import cli
from nylon_amt_tpu_torch import config as tconfig
from nylon_amt_tpu_torch.data.corpus import assemble_split, write_manifest
from nylon_amt_tpu_torch.data.windows import WindowDataset
from nylon_amt_tpu_torch.models.convert import params_from_jax
from nylon_amt_tpu_torch.models.hft import HFT
from nylon_amt_tpu_torch.train import metrics as tmetrics
from nylon_amt_tpu_torch.train.checkpoint import load_params, merge_params
from nylon_amt_tpu_torch.train.loop import Trainer
from nylon_amt_tpu_torch.train.step import TrainState, make_optimizer
from nylon_amt_tpu_torch.utils import profiling
from nylon_amt_tpu_torch.utils.wavio import save_wav

from test_torch_ablation import one_thread  # noqa: F401 (autouse)

TINY = dict(hid_dim=16, pf_dim=32, enc_layer=1, dec_layer=1, enc_head=2,
            dec_head=2, dropout=0.0)
FRAMES = 32     # windows of 32 + 64 frames: the CPU's training steps are
#                 the kernels' plain twins, ~0.8 s a step of one window


def _configs(**train):
    """(JAX config, port config) of one tiny model."""
    return (jconfig.Config(input=jconfig.InputConfig(num_frame=FRAMES),
                           model=jconfig.ModelConfig(**TINY),
                           train=jconfig.TrainConfig(**train)),
            tconfig.Config(input=tconfig.InputConfig(num_frame=FRAMES),
                           model=tconfig.ModelConfig(**TINY),
                           train=tconfig.TrainConfig(**train)))


def _piece(rng, n):
    feat = rng.standard_normal((n, 256)).astype(np.float32) - 4.0
    lab = {"onset": (rng.random((n, 88)) > 0.97).astype(np.float32),
           "offset": (rng.random((n, 88)) > 0.97).astype(np.float32),
           "mpe": rng.random((n, 88)) > 0.8,
           "velocity": rng.integers(1, 127, (n, 88)).astype(np.int8)}
    return feat, lab


# ------------------------------------------------------------- metrics --

@pytest.mark.parametrize("threshold", [0.5, None])
def test_intervals_from_rolls_equals_jax(threshold):
    rng = np.random.default_rng(4)
    onset = rng.random((3, 40, 88)) ** 8
    offset = rng.random((3, 40, 88)) ** 8
    if threshold is None:       # the legacy rule: any nonzero value
        onset = np.where(onset > 0.6, onset, 0.0)
        offset = np.where(offset > 0.6, offset, 0.0)
    for args in ((0.016, 21, threshold), (512 / 44100, 0, threshold)):
        got = tmetrics.intervals_from_rolls(onset, offset, *args)
        want = jmetrics.intervals_from_rolls(onset, offset, *args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[0].shape[0] > 10
    empty = np.zeros((1, 8, 88))
    for g, w in zip(tmetrics.intervals_from_rolls(empty, empty, 0.016),
                    jmetrics.intervals_from_rolls(empty, empty, 0.016)):
        np.testing.assert_array_equal(g, w)


def test_note_metrics_fn_matches_jax():
    """The test pass on the same weights and windows (the last batch padded)
    against JAX's. The heads are scaled x40 on both sides so that no
    posterior sits within float noise of the 0.5 threshold."""
    jcfg, tcfg = _configs(batch_size=2)
    rng = np.random.default_rng(8)
    feat, lab = _piece(rng, 60)
    jds = JWindowDataset(j_assemble(jcfg, [feat], [lab]), jcfg, n_slice=20)
    tds = WindowDataset(assemble_split(tcfg, [feat], [lab]), tcfg,
                        n_slice=20)
    assert len(tds) == 3, "the test needs a padded last batch"

    jstate = j_create_state(jcfg, jax.random.key(3))
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    for name in ("fc_onset_time", "fc_offset_time"):    # the B heads
        head = params["decoder"][name]
        head["kernel"] = head["kernel"] * 40.0
        head["bias"] = head["bias"] + 1.5
    jstate = jstate.replace(params=jax.tree_util.tree_map(jax.numpy.asarray,
                                                          params))
    model = HFT(tcfg, "cpu")
    model.load_state_dict(params_from_jax(params, tcfg))
    tstate = TrainState(model, make_optimizer(tcfg, model.parameters()))

    want = jmetrics.make_note_metrics_fn(jcfg)(jstate, [jds])
    got = tmetrics.make_note_metrics_fn(tcfg)(tstate, [tds])
    assert set(got) == set(want) == {
        "precision", "recall", "f1", "precision_no_offset",
        "recall_no_offset", "f1_no_offset"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert 0.0 < want["f1_no_offset"] < 1.0


# ------------------------------------------------------------ trainer --

def _toy(tcfg):
    arrays = assemble_split(tcfg, *zip(_piece(np.random.default_rng(6), 40)))

    def provider(split, div):
        return WindowDataset(arrays, tcfg, n_slice=20)    # 2 windows

    return provider


class _Evicted:
    """A train shard that sends this process SIGUSR1 after its first
    batch: the eviction notice arrives in the middle of the shard."""

    def __init__(self, ds):
        self.ds = ds

    def batches(self, *args, **kwargs):
        for i, batch in enumerate(self.ds.batches(*args, **kwargs)):
            if i == 1:
                os.kill(os.getpid(), signal.SIGUSR1)
            yield batch


def test_preempted_resume_matches_uninterrupted(tmp_path):
    """SIGUSR1 in the middle of epoch 1 checkpoints the state from before
    the shard (tagged "preempted": model, Adam, step, the shuffle RNG and
    the dropout-seed generator) and returns; resume="auto" re-runs that
    shard and ends bit for bit as the uninterrupted run, with the same loss
    history. The trainer's signal handlers are gone afterwards."""
    _, tcfg = _configs(batch_size=1, epochs=2, seed=2, lr=1e-3)
    provider = _toy(tcfg)
    base = Trainer(tcfg, str(tmp_path / "base"), device="cpu")
    base_state = base.fit(provider)
    assert base_state.step == 4

    calls = {"n": 0}

    def preempting(split, div):
        ds = provider(split, div)
        if split == "train":
            calls["n"] += 1
            if calls["n"] == 2:           # epoch 1
                return _Evicted(ds)
        return ds

    handler = signal.getsignal(signal.SIGUSR1)
    run = Trainer(tcfg, str(tmp_path / "run"), device="cpu")
    run.fit(preempting)
    assert signal.getsignal(signal.SIGUSR1) == handler
    assert run.latest_checkpoint() == (1, 0)
    ckpt = tmp_path / "run" / "checkpoints"
    host = json.loads((ckpt / "model_001_000" / "host.json").read_text())
    before = json.loads((tmp_path / "base" / "checkpoints" / "model_000_000"
                         / "host.json").read_text())
    assert host["preempted"] is True
    assert host["np_rng"] == before["np_rng"]
    assert host["seed_gen"] == before["seed_gen"]
    opt = torch.load(ckpt / "model_001_000" / "optimizer.pt",
                     weights_only=True)
    assert opt["step"] == 2               # one step of epoch 1 undone
    saved = load_params(str(ckpt), 1, 0)
    for name, v in load_params(str(tmp_path / "base" / "checkpoints"),
                               0, 0).items():
        assert torch.equal(saved[name], v), name

    resumed = Trainer(tcfg, str(tmp_path / "run"), device="cpu")
    state = resumed.fit(provider, resume="auto")
    for (name, a), b in zip(base_state.model.state_dict().items(),
                            state.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert state.step == base_state.step
    assert resumed.performance["loss_train"] == \
        base.performance["loss_train"]
    assert len(resumed.performance["loss_train"]) == 2


def test_request_preemption_before_a_shard_saves_nothing_trained(tmp_path):
    _, tcfg = _configs(batch_size=2, epochs=2)
    run = Trainer(tcfg, str(tmp_path / "run"), device="cpu")
    provider = _toy(tcfg)

    def preempting(split, div):
        if split == "train":
            run.request_preemption()
        return provider(split, div)

    state = run.fit(preempting)
    assert state.step == 0
    assert run.latest_checkpoint() == (0, 0)
    assert run.performance["loss_train"] == []


def _corpus(tmp_path, tcfg):
    rng = np.random.default_rng(11)
    d = tmp_path / "corpus"
    for split, sizes in (("train", (16, 16)), ("valid", (16,)),
                         ("test", (20,))):
        pieces = [_piece(rng, n) for n in sizes]
        assemble_split(tcfg, [p[0] for p in pieces],
                       [p[1] for p in pieces]).save(str(d), split)
    write_manifest(tcfg, str(d))
    return d


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A 2-epoch run of ``cli train --valid-test --test-metrics --trace``:
    (directory, config path)."""
    tmp = tmp_path_factory.mktemp("workflow")
    _, tcfg = _configs(batch_size=2, seed=5, lr=1e-3)
    cfg_path = tmp / "config.json"
    tcfg.save(str(cfg_path))
    corpus = _corpus(tmp, tcfg)
    assert cli.main(["train", "--config", str(cfg_path), "--dataset",
                     str(corpus), "--out", str(tmp / "run"), "--epochs", "2",
                     "--n-slice", "8", "--valid-test", "--test-metrics",
                     "--trace", str(tmp / "trace"), "--device", "cpu"]) == 0
    return tmp, cfg_path


def test_valid_test_metrics_and_trace(run):
    tmp, _ = run
    perf = json.loads((tmp / "run" / "performance.json").read_text())
    assert len(perf["loss_test"]) == len(perf["loss_valid"]) == 2
    assert all(np.isfinite(perf["loss_test"]))
    assert perf["loss_test"] != perf["loss_valid"]
    scores = json.loads((tmp / "run" / "test_performance.json").read_text())
    assert set(scores) == {"precision", "recall", "f1", "precision_no_offset",
                           "recall_no_offset", "f1_no_offset"}
    assert all(0.0 <= v <= 1.0 for v in scores.values())
    trace = tmp / "trace" / profiling.TRACE_FILE
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_init_from_warm_starts_a_fresh_run(run, tmp_path):
    tmp, cfg_path = run
    ckpts = tmp / "run" / "checkpoints"
    corpus = tmp / "corpus"
    # lr 0: Adam moves nothing, so the run ends on the loaded parameters
    assert cli.main(["train", "--config", str(cfg_path), "--dataset",
                     str(corpus), "--out", str(tmp_path / "warm"),
                     "--epochs", "1", "--n-slice", "8", "--lr", "0",
                     "--init-from", str(ckpts), "--init-epoch", "0",
                     "--init-div", "0", "--device", "cpu"]) == 0
    warm = tmp_path / "warm" / "checkpoints" / "model_000_000"
    opt = torch.load(warm / "optimizer.pt", weights_only=True)
    assert opt["step"] == 2                     # one epoch: 2 steps of 2
    got = load_params(str(warm / "model.dat"))
    want = load_params(str(ckpts), 0, 0)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not all(torch.equal(got[k], v) for k, v in
                   load_params(str(ckpts), 1, 0).items())

    # another architecture: the run ends before any step
    wide = tconfig.Config(input=tconfig.InputConfig(num_frame=FRAMES),
                          model=tconfig.ModelConfig(**{**TINY,
                                                       "hid_dim": 32}))
    wide.save(str(tmp_path / "wide.json"))
    with pytest.raises(SystemExit, match="does not match this config's "
                       "architecture"):
        cli.main(["train", "--config", str(tmp_path / "wide.json"),
                  "--dataset", str(corpus), "--out", str(tmp_path / "w2"),
                  "--init-from", str(ckpts), "--device", "cpu"])
    assert not (tmp_path / "w2" / "checkpoints").exists()


def test_merge_params_is_a_subset_warm_start():
    fresh = {"a": torch.zeros(2), "b": torch.ones(3)}
    merged = merge_params(fresh, {"a": torch.full((2,), 7.0)})
    assert torch.equal(merged["a"], torch.full((2,), 7.0))
    assert merged["b"] is fresh["b"]
    with pytest.raises(ValueError, match="shape mismatch"):
        merge_params(fresh, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="lacks"):
        merge_params(fresh, {"c": torch.zeros(1)})


def test_transcribe_picks_the_best_or_the_given_checkpoint(run, tmp_path):
    tmp, cfg_path = run
    ckpts = tmp / "run" / "checkpoints"
    wav = tmp_path / "piece.wav"
    t = np.arange(3 * 16000) / 16000
    save_wav(str(wav), 0.3 * np.sin(2 * np.pi * 440 * t), 16000)

    def posteriors(out, *ckpt):
        assert cli.main(["transcribe", "--config", str(cfg_path),
                         "--checkpoint", *ckpt, "--wav", str(wav), "--out",
                         str(tmp_path / out), "--batch-windows", "2",
                         "--save-posteriors", "--device", "cpu"]) == 0
        return dict(np.load(tmp_path / out / "piece.post.npz"))

    best = json.loads((ckpts / "best.json").read_text())
    runs = {
        "dir_best": posteriors("a", str(ckpts)),
        "dat_best": posteriors("b", str(ckpts / f"model_{best['epoch']:03d}_"
                                         f"{best['div']:03d}" / "model.dat")),
        "dir_0": posteriors("c", str(ckpts), "--epoch", "0", "--div", "0"),
        "dat_0": posteriors("d", str(ckpts / "model_000_000" / "model.dat")),
        "dat_1": posteriors("e", str(ckpts / "model_001_000" / "model.dat"))}
    for a, b in (("dir_best", "dat_best"), ("dir_0", "dat_0")):
        for k in runs[a]:
            np.testing.assert_array_equal(runs[a][k], runs[b][k])
    assert not np.array_equal(runs["dir_0"]["onset_B"],
                              runs["dat_1"]["onset_B"])
