"""The port's device-resident window sampler
(``nylon_amt_tpu_torch/data/device_windows.py``) and the trainer's device
epoch, on the CPU (``DeviceWindowDataset(..., device="cpu")``).

The cases of ``tests/test_device_dataset.py``: the gather and the batch
stream equal to the host path's, with and without ``string``; refresh; the
gate that keeps a CPU split on the host; the device epoch against the host
loop; the trainer's cache; the hid >= 192 gate. Beside them: the gather bit
for bit JAX's ``DeviceWindowDataset.gather`` (JAX on the CPU), the device
epoch bit for bit the host loop (losses, parameters, Adam's moments and
both generators' states after 3 steps, one a padded tail), the LRU under
its budget, an evicted split admitted and counted again when it is read,
validation of a resident split equal to the host's, the epoch plan that
both paths share equal to JAX's batches, and ``NYLON_DEVICE_DATASET`` read
at every call and a bad value raising.
"""

import numpy as np
import pytest
import torch

from nylon_amt_tpu import config as jconfig
from nylon_amt_tpu.data.corpus import assemble_split as j_assemble
from nylon_amt_tpu.data.windows import WindowDataset as JWindowDataset
from nylon_amt_tpu.data.device_windows import (
    DeviceWindowDataset as JDeviceWindowDataset,
    split_nbytes as j_split_nbytes,
)
from nylon_amt_tpu_torch import config as tconfig
from nylon_amt_tpu_torch.data import device_windows as dw
from nylon_amt_tpu_torch.data.corpus import assemble_split
from nylon_amt_tpu_torch.data.device_windows import (
    DeviceWindowDataset,
    as_device_dataset,
    host_input_is_hidden,
    split_nbytes,
)
from nylon_amt_tpu_torch.data.windows import WindowDataset, epoch_plan
from nylon_amt_tpu_torch.train import loop as tloop
from nylon_amt_tpu_torch.train.loop import Trainer
from nylon_amt_tpu_torch.train.step import create_train_state, eval_step

from test_torch_ablation import one_thread  # noqa: F401 (autouse)

FRAMES = 32     # windows of 32 + 64 frames keep the CPU's plain steps short
TINY = dict(hid_dim=16, pf_dim=32, enc_layer=1, dec_layer=1, enc_head=2,
            dec_head=2)


def _pieces(n_pieces=2, frames=300, seed=0, string=False):
    rng = np.random.default_rng(seed)
    feats, labels = [], []
    for _ in range(n_pieces):
        feats.append(rng.standard_normal((frames, 256)).astype(np.float32))
        lab = {
            "onset": (rng.random((frames, 88)) > 0.97).astype(np.float32),
            "offset": (rng.random((frames, 88)) > 0.97).astype(np.float32),
            "mpe": rng.random((frames, 88)) > 0.9,
            "velocity": rng.integers(0, 127, (frames, 88)).astype(np.int8),
        }
        if string:
            lab["string"] = rng.integers(0, 7, (frames, 88)).astype(np.int8)
        labels.append(lab)
    return feats, labels


def _arrays(cfg, **kw):
    return assemble_split(cfg, *_pieces(**kw))


def _equal(a: dict, b: dict):
    """Two batches bit for bit: the same keys, dtypes, shapes and values."""
    assert set(a) == set(b)
    for k in a:
        x, y = (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for v in (a[k], b[k]))
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("string", [False, True])
def test_gather_matches_host_and_jax(string):
    """The device gather is the port's host gather and JAX's device
    gather, bit for bit, with and without the string targets; ``spec`` is
    contiguous (the TMA-fed kernels read whole rows)."""
    cfg = tconfig.Config()
    arrays = _arrays(cfg, string=string)
    host = WindowDataset(arrays, cfg, n_slice=3)
    dev = DeviceWindowDataset(arrays, cfg, n_slice=3, device="cpu")
    jarrays = j_assemble(jconfig.Config(), *_pieces(string=string))
    jdev = JDeviceWindowDataset(jarrays, jconfig.Config(), n_slice=3)
    assert len(host) == len(dev) == len(jdev)
    pos = np.array([0, 5, len(host) - 1, 5])
    got = dev.gather(pos)
    assert ("string" in got) == string
    assert got["spec"].is_contiguous()
    assert got["spec"].device.type == "cpu"
    _equal(got, host.gather(pos))
    _equal(got, {k: np.asarray(v) for k, v in jdev.gather(pos).items()})
    assert split_nbytes(arrays) == j_split_nbytes(jarrays) == \
        dev.cached_nbytes


def test_batches_stream_matches_host():
    """A whole shuffled epoch, the padded tail and its ``valid`` mask
    included."""
    cfg = tconfig.Config()
    arrays = _arrays(cfg)
    host = WindowDataset(arrays, cfg, n_slice=2)
    dev = DeviceWindowDataset(arrays, cfg, n_slice=2, device="cpu")
    kw = dict(batch_size=7, shuffle=True, pad_to_batch=True)
    hb = list(host.batches(rng=np.random.default_rng(3), **kw))
    db = list(dev.batches(rng=np.random.default_rng(3), **kw))
    assert len(hb) == len(db) > 1
    assert not hb[-1]["valid"].all()
    for a, b in zip(hb, db):
        _equal(a, b)


def test_refresh_delete_and_ensure_resident():
    cfg = tconfig.Config()
    dev = DeviceWindowDataset(_arrays(cfg), cfg, device="cpu")
    pos = np.array([0, 3])
    before = {k: v.clone() for k, v in dev.gather(pos).items()}
    dev.refresh()
    _equal(before, dev.gather(pos))
    dev.delete()
    assert dev._dev == {}
    _equal(before, dev.gather(pos))       # uploaded again on use
    assert dev._dev


def test_as_device_dataset_keeps_cpu_splits_on_the_host(monkeypatch):
    cfg = tconfig.Config()
    ds = WindowDataset(_arrays(cfg), cfg, n_slice=4)
    monkeypatch.setenv("NYLON_DEVICE_DATASET", "1")
    assert as_device_dataset(ds, cfg, "cpu") is ds
    dev = DeviceWindowDataset(ds.arrays, cfg, device="cpu")
    assert as_device_dataset(dev, cfg, "cuda") is dev   # already resident
    assert as_device_dataset(object, cfg, "cuda") is object
    assert split_nbytes(ds.arrays) > 0


def test_override_read_at_call_time_and_bad_values_raise(monkeypatch):
    """``NYLON_DEVICE_DATASET`` and both budgets are read when asked, not
    at import; a value other than "0", "1" or unset raises (also on the
    CPU, before the device is looked at)."""
    small = tconfig.Config(model=tconfig.ModelConfig(hid_dim=64))
    paper = tconfig.Config(model=tconfig.ModelConfig.paper_scale())
    monkeypatch.delenv("NYLON_DEVICE_DATASET", raising=False)
    assert dw.forced() is None
    assert dw.promotion_wanted(small) and not dw.promotion_wanted(paper)
    monkeypatch.setenv("NYLON_DEVICE_DATASET", "1")
    assert dw.forced() is True and dw.promotion_wanted(paper)
    monkeypatch.setenv("NYLON_DEVICE_DATASET", "0")
    assert dw.forced() is False and not dw.promotion_wanted(small)
    monkeypatch.setenv("NYLON_DEVICE_DATASET", "")
    assert dw.forced() is None
    ds = WindowDataset(_arrays(small, n_pieces=1), small)
    for bad in ("true", "off", "2", " 1"):
        monkeypatch.setenv("NYLON_DEVICE_DATASET", bad)
        with pytest.raises(ValueError, match="NYLON_DEVICE_DATASET"):
            dw.promotion_wanted(small)
        with pytest.raises(ValueError, match="NYLON_DEVICE_DATASET"):
            as_device_dataset(ds, small, "cpu")
    monkeypatch.delenv("NYLON_DEVICE_DATASET")
    assert dw.split_max_bytes() == 4e9 and dw.device_dataset_budget() == 8e9
    monkeypatch.setenv("NYLON_DEVICE_DATASET_MAX_BYTES", "123")
    monkeypatch.setenv("NYLON_DEVICE_DATASET_TOTAL_BYTES", "456")
    assert dw.split_max_bytes() == 123.0
    assert dw.device_dataset_budget() == 456.0


def test_epoch_device_matches_host_loop(tmp_path):
    """The device epoch (starts and valid uploaded once, windows gathered
    per step, losses fetched once) is bit for bit the host loop after 3
    steps (5 windows at batch 2: a padded tail), at dropout 0.1: the loss,
    every parameter, Adam's moments and both generators' states. JAX's own
    test holds its scan to the host loop within 1e-5 (another compilation);
    here the same ops run, so nothing may differ."""
    cfg = tconfig.Config(
        input=tconfig.InputConfig(num_frame=FRAMES),
        model=tconfig.ModelConfig(hid_dim=16, pf_dim=32, enc_layer=1,
                                  dec_layer=1, enc_head=2, dec_head=2,
                                  dropout=0.1),
        train=tconfig.TrainConfig(epochs=1, batch_size=2))
    arrays = _arrays(cfg, n_pieces=1, frames=90, seed=4)
    host = WindowDataset(arrays, cfg, n_slice=18)           # 5 windows
    dev = DeviceWindowDataset(arrays, cfg, n_slice=18, device="cpu")
    assert len(host) == 5
    out = []
    for ds in (host, dev):
        tr = Trainer(cfg, str(tmp_path), device="cpu")
        state = create_train_state(cfg, 1, "cpu")
        rng, gen = np.random.default_rng(5), torch.Generator().manual_seed(3)
        state, loss = tr.train_epoch(state, ds, rng, gen)
        out.append((state, loss, rng, gen))
    (sh, lh, rh, gh), (sd, ld, rd, gd) = out
    assert sh.step == sd.step == 3
    assert lh == ld
    for (name, a), b in zip(sh.model.state_dict().items(),
                            sd.model.state_dict().values()):
        assert torch.equal(a, b), name
    for p, q in zip(sh.model.parameters(), sd.model.parameters()):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sh.optimizer.state[p][k],
                               sd.optimizer.state[q][k])
    assert rh.bit_generator.state == rd.bit_generator.state
    assert torch.equal(gh.get_state(), gd.get_state())


def test_trainer_uses_device_dataset_cache(tmp_path, monkeypatch):
    """``_wrap_ds``: on the CPU it keeps the host split and caches nothing;
    with promotion (here made on the CPU) the same arrays give one cached
    split with the caller's n_slice table, and the least recently used
    split is evicted when the total budget would be passed."""
    cfg = tconfig.Config(model=tconfig.ModelConfig(hid_dim=16, pf_dim=32,
                                                   enc_layer=1, dec_layer=1,
                                                   enc_head=2, dec_head=2),
                         train=tconfig.TrainConfig(epochs=1, batch_size=2))
    a1, a2 = _arrays(cfg, seed=1), _arrays(cfg, seed=2)
    tr = Trainer(cfg, str(tmp_path), device="cpu")
    ds1 = WindowDataset(a1, cfg, n_slice=4)
    assert tr._wrap_ds(ds1) is ds1 and tr._dev_cache == {}

    def promote(ds, config, device):
        dev = DeviceWindowDataset(ds.arrays, config, device="cpu")
        dev.idx = ds.idx
        return dev

    monkeypatch.setattr(tloop, "as_device_dataset", promote)
    out1 = tr._wrap_ds(ds1)
    assert isinstance(out1, DeviceWindowDataset) and len(out1) == len(ds1)
    ds2 = WindowDataset(a1, cfg, n_slice=2)
    out2 = tr._wrap_ds(ds2)
    assert out2 is out1 and len(out2) == len(ds2)
    assert len(tr.uploads) == 1 and tr.uploads[0][0] == split_nbytes(a1)
    # a budget of one split: the second split evicts the first
    monkeypatch.setenv("NYLON_DEVICE_DATASET_TOTAL_BYTES",
                       str(split_nbytes(a1) + 1))
    out3 = tr._wrap_ds(WindowDataset(a2, cfg))
    assert list(tr._dev_cache) == [id(a2)]
    assert out1._dev == {} and out3._dev
    assert tr._dev_cache_bytes == split_nbytes(a2)


def test_host_input_hidden_heuristic():
    """The JAX gate: paper-class models (hid 256) keep the host path, the
    reduced recipe (hid 64) is promoted; the same answers as JAX's."""
    from nylon_amt_tpu.data.device_windows import (
        host_input_is_hidden as j_hidden)

    for m, want in ((dict(hid_dim=256, pf_dim=512, enc_layer=3, dec_layer=3,
                          enc_head=4, dec_head=4), True),
                    (dict(hid_dim=64, pf_dim=128, enc_layer=2, dec_layer=2,
                          enc_head=2, dec_head=2), False),
                    (dict(hid_dim=192, pf_dim=384, enc_head=4,
                          dec_head=4), True)):
        t = tconfig.Config(model=tconfig.ModelConfig(**m))
        j = jconfig.Config(model=jconfig.ModelConfig(**m))
        assert host_input_is_hidden(t) is j_hidden(j) is want


def _promote_on_the_cpu(monkeypatch):
    """``as_device_dataset`` promoting every split on the CPU, as it does
    on the card."""
    def promote(ds, config, device):
        dev = DeviceWindowDataset(ds.arrays, config, device="cpu")
        dev.idx = ds.idx
        return dev

    monkeypatch.setattr(tloop, "as_device_dataset", promote)


def test_evicted_split_is_admitted_again_and_counted(tmp_path, monkeypatch):
    """A split that the LRU evicted and that is read again (a validation
    split after a train split took its room) is uploaded through the cache:
    the other split is evicted, the resident bytes stay under the budget,
    and the upload is counted and timed."""
    cfg = tconfig.Config(input=tconfig.InputConfig(num_frame=FRAMES),
                         model=tconfig.ModelConfig(**TINY),
                         train=tconfig.TrainConfig(batch_size=2))
    a1, a2 = (_arrays(cfg, n_pieces=1, frames=120, seed=s) for s in (1, 2))
    _promote_on_the_cpu(monkeypatch)
    budget = split_nbytes(a1) + 1
    monkeypatch.setenv("NYLON_DEVICE_DATASET_TOTAL_BYTES", str(budget))
    tr = Trainer(cfg, str(tmp_path), device="cpu")
    assert tr.prefetch_depth == 0        # the step loop is the default
    valid = tr._wrap_ds(WindowDataset(a1, cfg, n_slice=8))
    train = tr._wrap_ds(WindowDataset(a2, cfg, n_slice=8))
    assert not valid.resident and train.resident and len(tr.uploads) == 2
    state = create_train_state(cfg, 0, "cpu")
    loss, n = tr.valid_epoch(state, valid)
    assert n > 0 and np.isfinite(loss)
    assert valid.resident and not train.resident
    assert list(tr._dev_cache) == [id(a1)]
    assert tr._dev_cache_bytes == split_nbytes(a1) <= budget
    assert [b for b, _ in tr.uploads] == [split_nbytes(a) for a in
                                          (a1, a2, a1)]
    tr.valid_epoch(state, valid)         # resident: no upload
    assert len(tr.uploads) == 3


def test_valid_epoch_of_a_resident_split_matches_host(tmp_path,
                                                      monkeypatch):
    """Validation of a resident split (the starts uploaded once, the
    windows gathered per batch) gives the host path's summed loss and
    batch count bit for bit, the padded tail included, and its batches are
    the ones :func:`eval_step` is given on the host."""
    cfg = tconfig.Config(input=tconfig.InputConfig(num_frame=FRAMES),
                         model=tconfig.ModelConfig(**TINY),
                         train=tconfig.TrainConfig(batch_size=2))
    arrays = _arrays(cfg, n_pieces=1, frames=90, seed=4)
    host = WindowDataset(arrays, cfg, n_slice=18)            # 5 windows
    state = create_train_state(cfg, 0, "cpu")
    want = Trainer(cfg, str(tmp_path / "h"), device="cpu").valid_epoch(
        state, host)
    _promote_on_the_cpu(monkeypatch)
    tr = Trainer(cfg, str(tmp_path / "d"), device="cpu")
    dev = tr._wrap_ds(host)
    assert isinstance(dev, DeviceWindowDataset)
    assert tr.valid_epoch(state, dev) == want and want[1] == 3
    got = list(tr._batches(dev, shuffle=False))
    ref = [{k: torch.as_tensor(v) for k, v in b.items()}
           for b in host.batches(2, pad_to_batch=True)]
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        _equal(a, b)
        assert torch.equal(eval_step(cfg, state, a)["loss"],
                           eval_step(cfg, state, b)["loss"])


@pytest.mark.parametrize("shuffle,drop_last,pad_to_batch", [
    (True, False, True), (False, False, True), (True, True, False),
    (True, False, False)])
def test_epoch_plan_matches_jax_batches(shuffle, drop_last, pad_to_batch):
    """The plan that the host batches and the device epoch share gives
    JAX's ``WindowDataset.batches`` (the same windows in the same order,
    the tail padded, dropped or ragged, the ``valid`` mask) and leaves the
    shuffle generator in JAX's state."""
    cfg = tconfig.Config(input=tconfig.InputConfig(num_frame=FRAMES))
    jcfg = jconfig.Config(input=jconfig.InputConfig(num_frame=FRAMES))
    host = WindowDataset(_arrays(cfg, n_pieces=1, frames=90, seed=5), cfg,
                         n_slice=11)
    jds = JWindowDataset(j_assemble(jcfg, *_pieces(n_pieces=1, frames=90,
                                                   seed=5)), jcfg, 11)
    assert len(host) == len(jds) and len(host) % 3
    rng, jrng = np.random.default_rng(9), np.random.default_rng(9)
    plan = epoch_plan(len(host), 3, shuffle, rng, drop_last, pad_to_batch)
    want = list(jds.batches(3, shuffle=shuffle, rng=jrng, drop_last=drop_last,
                            pad_to_batch=pad_to_batch))
    assert len(plan) == len(want) > 1
    for (pos, valid), b in zip(plan, want):
        got = dict(host.gather(pos), valid=valid)
        _equal(got, {k: np.asarray(v) for k, v in b.items()})
    assert rng.bit_generator.state == jrng.bit_generator.state
