"""The slice as a whole: WAV -> log-mel -> windowed transcription -> notes ->
MIDI through the port (CPU, plain versions) and through the JAX package's
``Transcriber(use_engine=True)``, on the same weights."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from nylon_amt_tpu.config import Config, ModelConfig
from nylon_amt_tpu.infer.decode import mpe2note as j_mpe2note
from nylon_amt_tpu.infer.transcribe import Transcriber as JaxTranscriber
from nylon_amt_tpu.midi.smf import MidiFile
from nylon_amt_tpu.models.hft import init_params
from nylon_amt_tpu.models.init import reference_initialize
from nylon_amt_tpu.ops.resample import resample as j_resample
from nylon_amt_tpu.utils import wavio as j_wavio
from nylon_amt_tpu_torch import cli
from nylon_amt_tpu_torch.infer import engine as tengine
from nylon_amt_tpu_torch.infer.decode import mpe2note as t_mpe2note
from nylon_amt_tpu_torch.infer.transcribe import Transcriber
from nylon_amt_tpu_torch.models.convert import params_from_jax
from nylon_amt_tpu_torch.models.hft import HFT
from nylon_amt_tpu_torch.ops.resample import resample as t_resample
from nylon_amt_tpu_torch.utils import wavio as t_wavio

SR = 16000
BATCH = 2       # windows per batch: the 3-window run ends in a padded batch
N_OFFSET = 32


def _config():
    return Config(model=ModelConfig(hid_dim=32, pf_dim=64, enc_layer=2,
                                    dec_layer=2, enc_head=2, dec_head=2,
                                    dropout=0.0))


def _synth(seconds=6.0, seed=0):
    """Decaying sines at a few pitches over a noise floor."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    wav = 0.05 * rng.standard_normal(n)
    for i, start in enumerate(np.arange(0.0, seconds - 0.5, 0.5)):
        f = 440.0 * 2 ** ((60 + 4 * (i % 4) - 69) / 12)
        s = int(start * SR)
        tt = t[s:s + SR // 2] - start
        wav[s:s + SR // 2] += 0.3 * np.exp(-4 * tt) * np.sin(2 * np.pi * f * tt)
    return wav.astype(np.float32)


class _Recording(Transcriber):
    """Keeps every batch of windows it runs."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.batches = []

    def _run_batch(self, windows):
        self.batches.append(windows.numpy().copy())
        return super()._run_batch(windows)


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    cfg = _config()
    # init_params(cfg, key) with the flax init jitted: the same values, in a
    # fraction of the eager time
    key = jax.random.key(2)
    params = reference_initialize(
        jax.jit(lambda k: init_params(cfg, k, reference_init=False))(key), key)
    model = HFT(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg), strict=True)
    model.eval()
    tmp = tmp_path_factory.mktemp("slice")
    wav = str(tmp / "piece.wav")
    j_wavio.save_wav(wav, _synth(), SR)
    port = _Recording(cfg, model, "cpu", batch_windows=BATCH)
    ref = JaxTranscriber(cfg, params, batch_windows=BATCH, use_engine=True)
    feat_t, feat_j = port.wav2feature(wav), ref.wav2feature(wav)
    runs = {}
    for mode in ("plain", "stride"):
        port.batches.clear()
        if mode == "plain":
            got, want = port.transcript(feat_t), ref.transcript(feat_j)
        else:
            got = port.transcript_stride(feat_t, N_OFFSET)
            want = ref.transcript_stride(feat_j, N_OFFSET)
        # the port's velocity logits of the same windows: where their top-two
        # margin is > 1e-3 (well above the 2e-4 the two sides' logits may
        # differ by), both sides must pick the same velocity class
        windows = torch.from_numpy(np.concatenate(port.batches))
        logits = tengine.forward(port.packed, windows, cfg)
        runs[mode] = (got, want, {
            fam: logits[f"velocity_{fam}"].float().numpy()
            for fam in ("A", "B")})
    return SimpleNamespace(cfg=cfg, params=params, model=model, tmp=tmp,
                           wav=wav, feat_t=feat_t, feat_j=feat_j, runs=runs,
                           n_frames=feat_j.shape[0])


def test_features_match_jax(slice_run):
    assert slice_run.feat_t.shape == slice_run.feat_j.shape
    np.testing.assert_allclose(slice_run.feat_t, slice_run.feat_j, atol=2e-4)


def _top2_margin(logits):
    top = np.sort(logits, axis=-1)
    return top[..., -1] - top[..., -2]


@pytest.mark.parametrize("mode", ["plain", "stride"])
def test_posteriors_match_jax_transcriber(slice_run, mode):
    got, want, vel_logits = slice_run.runs[mode]
    assert set(got) == set(want)
    T, half = slice_run.n_frames, slice_run.cfg.input.num_frame // 2
    for k in want:
        assert got[k].shape == want[k].shape, k
        if not k.startswith("velocity"):
            np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32),
                                       atol=2e-4, err_msg=k)
            continue
        assert got[k].dtype == np.int8
        margin = _top2_margin(vel_logits[k[-1]])   # [N_padded, frames, notes]
        n_windows = len(range(0, T, half if mode == "stride" else 2 * half))
        margin = margin[:n_windows]
        if mode == "stride":
            margin = margin[:, N_OFFSET:N_OFFSET + half]
        margin = margin.reshape(-1, margin.shape[-1])[: got[k].shape[0]]
        decided = margin > 1e-3
        assert decided.mean() > 0.9
        np.testing.assert_array_equal(got[k][decided], want[k][decided],
                                      err_msg=k)


@pytest.mark.parametrize("use_native", [None, False])
def test_decode_copy_gives_identical_notes(slice_run, use_native):
    _, post, _ = slice_run.runs["plain"]
    for fam in ("A", "B"):
        args = [np.asarray(post[f"{k}_{fam}"], np.float32)
                for k in ("onset", "offset", "mpe")]
        args.append(post[f"velocity_{fam}"])
        for kw in ({}, dict(thred_onset=0.6, thred_offset=0.55,
                            thred_mpe=0.45, mode_offset="longer")):
            want = j_mpe2note(slice_run.cfg, *args, use_native=use_native,
                              **kw)
            got = t_mpe2note(slice_run.cfg, *args, use_native=use_native,
                             **kw)
            assert got == want
            assert want


def test_host_copies_are_bit_identical(tmp_path):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(22050) * 0.3).astype(np.float32)
    for orig, new in ((44100, 16000), (22050, 16000), (48000, 16000),
                      (16000, 16000), (8000, 16000)):
        np.testing.assert_array_equal(t_resample(x, orig, new),
                                      j_resample(x, orig, new))
    stereo = (rng.standard_normal((11025, 2)) * 0.3).astype(np.float32)
    path = str(tmp_path / "stereo.wav")
    t_wavio.save_wav(path, stereo, 22050)
    data_t, sr_t = t_wavio.load_wav(path)
    data_j, sr_j = j_wavio.load_wav(path)
    assert sr_t == sr_j == 22050
    np.testing.assert_array_equal(data_t, data_j)
    np.testing.assert_array_equal(t_wavio.load_mono(path, SR),
                                  j_wavio.load_mono(path, SR))


@pytest.mark.parametrize("fmt", ["dat", "state_dict"])
def test_cli_transcribe_on_cpu_writes_midi(slice_run, fmt):
    tmp = slice_run.tmp
    sd = slice_run.model.state_dict()
    ckpt = str(tmp / f"model_{fmt}.dat")
    torch.save({"model_dict": sd} if fmt == "dat" else sd, ckpt)
    config = str(tmp / "config.json")
    slice_run.cfg.save(config)
    out = tmp / f"out_{fmt}"
    rc = cli.main(["transcribe", "--checkpoint", ckpt, "--config", config,
                   "--wav", slice_run.wav, "--out", str(out),
                   "--batch-windows", "4", "--device", "cpu"])
    assert rc == 0
    midi = MidiFile.read(str(out / "piece.mid"))
    assert midi.tracks
    for name in ("piece.notes.json", "piece_1st.notes.json",
                 "piece_2nd.notes.json"):
        assert (out / name).exists()
