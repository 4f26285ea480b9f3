"""Multi-stream serving of the port (``infer/serve.py``, ``cli serve``): the
batched pumps equal each stream's offline decode, on the JAX tests' tiny
model with the JAX package's weights (CPU, plain versions)."""

import json

import numpy as np
import pytest
import torch

import jax

from nylon_amt_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from nylon_amt_tpu.models.hft import init_params
from nylon_amt_tpu.models.init import reference_initialize
from nylon_amt_tpu_torch import Config, ModelConfig
from nylon_amt_tpu_torch.infer.serve import StreamServer
from nylon_amt_tpu_torch.infer.transcribe import Transcriber
from nylon_amt_tpu_torch.models.convert import params_from_jax
from nylon_amt_tpu_torch.models.hft import HFT

TINY = dict(hid_dim=16, pf_dim=32, enc_layer=1, dec_layer=1, enc_head=2,
            dec_head=2, dropout=0.0)
SR = 16000


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: many small ops, and the suite's workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = JConfig(model=JModelConfig(**TINY)), Config(
        model=ModelConfig(**TINY))
    key = jax.random.key(0)
    params = reference_initialize(jax.jit(
        lambda k: init_params(jcfg, k, reference_init=False))(key), key)
    model = HFT(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg), strict=True)
    # the random stage-2 onset posteriors peak just under 0.5 on this audio;
    # lift their logits by 0.2 so that the decode finds a few notes a stream
    with torch.no_grad():
        model.decoder_spec2midi.fc_onset_time.bias += 0.2
    model.eval()
    return cfg, model, Transcriber(cfg, model, "cpu", batch_windows=4)


def _audio(rng, seconds, f0):
    t = np.arange(int(seconds * SR)) / SR
    wav = 0.2 * np.sin(2 * np.pi * f0 * t) * (np.sin(2 * np.pi * 0.7 * t) > 0)
    return (wav + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def _offline_notes(tr, wav):
    post = tr.transcript(tr.frontend(wav).numpy())
    return tr.mpe2note(post["onset_B"], post["offset_B"], post["mpe_B"],
                       post["velocity_B"])


def _assert_notes_equal(got, ref, atol=1e-9):
    # by pitch: across pitches equal onsets may swap by one float ulp
    order = lambda x: (x["pitch"], x["onset"], x["offset"])
    got, ref = sorted(got, key=order), sorted(ref, key=order)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["pitch"] == r["pitch"] and g["velocity"] == r["velocity"]
        assert abs(g["onset"] - r["onset"]) < atol
        assert abs(g["offset"] - r["offset"]) < atol


# note times, served against offline, on the CPU: the plain featurizer's f32
# matmuls run over other frame counts for a stream's segments than for the
# whole file, so their rows part by up to ~5e-7 in log-mel, the posteriors
# by as much, and the decoder's sub-frame onset and offset times by ~1e-8 s
# (on the card K1's rows, and so the notes, are bit for bit: chip_smoke.py
# (x) holds them to 1e-9 s)
CPU_TIME_ATOL = 1e-6


def test_two_streams_interleaved_match_offline(tiny):
    """Two streams of different lengths and content, fed interleaved and
    pumped through shared batched forwards, each equal their own offline
    decode: no cross-talk, nothing lost at close."""
    cfg, _, tr = tiny
    rng = np.random.default_rng(21)
    wavs = {0: _audio(rng, 4.5, 440.0), 1: _audio(rng, 3.0, 330.0)}
    srv = StreamServer(cfg, transcriber=tr)
    sids = {k: srv.open() for k in wavs}
    collected = {sid: [] for sid in sids.values()}
    chunk, pos, done = 8000, {k: 0 for k in wavs}, set()
    while len(done) < len(wavs) or srv.session_ids:
        for k, wav in wavs.items():
            if k in done:
                continue
            srv.feed(sids[k], wav[pos[k]: pos[k] + chunk])
            pos[k] += chunk
            if pos[k] >= wav.shape[0]:
                srv.close(sids[k])
                done.add(k)
        for sid, notes in srv.pump():
            collected[sid].extend(notes)
    for k, wav in wavs.items():
        ref = _offline_notes(tr, wav)
        assert ref
        _assert_notes_equal(collected[sids[k]], ref, CPU_TIME_ATOL)


def _spy(monkeypatch, obj, name):
    """Record each call's first argument's shape; call through."""
    calls, orig = [], getattr(obj, name)

    def spy(x, *args, **kwargs):
        calls.append(tuple(np.shape(x)))
        return orig(x, *args, **kwargs)

    monkeypatch.setattr(obj, name, spy)
    return calls


def test_pump_batches_across_sessions(tiny, monkeypatch):
    """One pump with three ready sessions: one featurizer call of exactly
    three segments (no padding rows) and one ``_run_all`` over their three
    windows; a closed session is removed while the others go on."""
    cfg, _, tr = tiny
    rng = np.random.default_rng(22)
    srv = StreamServer(cfg, transcriber=tr)
    sids = [srv.open() for _ in range(3)]
    wavs = [_audio(rng, 3.0, 300.0 + 50 * i) for i in range(3)]
    for sid, wav in zip(sids, wavs):
        srv.feed(sid, wav)                           # one ready block each
    feats = _spy(monkeypatch, tr.frontend, "features_from_sample_blocks")
    runs = _spy(monkeypatch, tr, "_run_all")
    srv.pump()
    assert [c[0] for c in feats] == [3] and len(runs) == 1
    assert runs[0][0] == 3
    srv.close(sids[0])
    got = [n for sid, notes in srv.pump() if sid == sids[0] for n in notes]
    assert srv.session_ids == sids[1:]
    _assert_notes_equal(got, _offline_notes(tr, wavs[0]), CPU_TIME_ATOL)
    for sid in sids[1:]:
        srv.close(sid)
    srv.pump()
    assert srv.session_ids == []


def test_pump_featurizes_once_per_segment_length(tiny, monkeypatch):
    """Sessions that pend segments of different lengths in one pump: one
    featurizer call per distinct (bucketed) length, each with exactly the
    sessions of that length: no padding rows, no power-of-two batch."""
    cfg, _, tr = tiny
    rng = np.random.default_rng(23)
    srv = StreamServer(cfg, transcriber=tr)
    sids = [srv.open() for _ in range(3)]
    # session 0 reaches its first block alone; 1 and 2 pend more audio
    # (two blocks' worth) before the next pump
    for sid, sec in zip(sids, (2.7, 4.7, 4.7)):
        srv.feed(sid, _audio(rng, sec, 400.0))
    feats = _spy(monkeypatch, tr.frontend, "features_from_sample_blocks")
    srv.pump()
    lengths = [c[1] for c in feats]
    assert sorted(c[0] for c in feats) == [1, 2]
    assert len(set(lengths)) == len(lengths) == 2
    for sid in sids:
        srv.close(sid)
    srv.pump()
    assert srv.session_ids == []


def test_cli_serve_writes_jsonl_and_midi(tiny, tmp_path, capsys):
    """``cli serve --wav --device cpu``: one JSON note a line on stdout, the
    latency line on stderr, the MIDI file; the notes are those that a
    ``StreamingTranscriber`` fed the same chunks pops."""
    from nylon_amt_tpu_torch.infer.stream import StreamingTranscriber
    from nylon_amt_tpu_torch import cli
    from nylon_amt_tpu_torch.midi.smf import MidiFile
    from nylon_amt_tpu_torch.utils.wavio import load_mono, save_wav

    cfg, model, tr = tiny
    cfg.save(str(tmp_path / "config.json"))
    torch.save({"model_dict": model.state_dict()}, tmp_path / "model.dat")
    wav = _audio(np.random.default_rng(24), 4.0, 440.0)
    save_wav(str(tmp_path / "in.wav"), wav, SR)
    rc = cli.main(["serve", "--config", str(tmp_path / "config.json"),
                   "--checkpoint", str(tmp_path / "model.dat"), "--wav",
                   str(tmp_path / "in.wav"), "--chunk-ms", "250",
                   "--midi", str(tmp_path / "out.mid"), "--device", "cpu"])
    out, err = capsys.readouterr()
    assert rc == 0
    notes = [json.loads(line) for line in out.splitlines()]
    assert notes and all(set(n) >= {"pitch", "onset", "offset", "velocity"}
                         for n in notes)
    assert f"# {len(notes)} notes, latency" in err
    assert MidiFile.read(str(tmp_path / "out.mid")).tracks
    wav = load_mono(str(tmp_path / "in.wav"), SR)    # as the CLI reads it
    st = StreamingTranscriber(cfg, model, "cpu", batch_windows=1)
    want = []
    for i in range(0, wav.shape[0], 4000):
        if st.feed(wav[i: i + 4000]):
            want += st.pop_stable_notes()
    st.flush()
    assert notes == want + st.pop_stable_notes(final=True)
