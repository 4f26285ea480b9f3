"""Streaming transcription of the port (``infer/stream.py``) against the JAX
package's ``StreamingTranscriber`` on the same weights and audio, and
against the port's own offline ``Transcriber.transcript`` (CPU, plain
versions): feed-in-any-chunking + flush == offline whole-file."""

import numpy as np
import pytest
import torch

import jax

from nylon_amt_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from nylon_amt_tpu.infer.stream import StreamingTranscriber as JStream
from nylon_amt_tpu.infer.transcribe import Transcriber as JTranscriber
from nylon_amt_tpu.models.hft import init_params
from nylon_amt_tpu.models.init import reference_initialize
from nylon_amt_tpu_torch import Config, ModelConfig
from nylon_amt_tpu_torch.infer.stream import StreamingTranscriber
from nylon_amt_tpu_torch.infer.transcribe import Transcriber
from nylon_amt_tpu_torch.models.convert import params_from_jax
from nylon_amt_tpu_torch.models.hft import HFT

TINY = dict(hid_dim=16, pf_dim=32, enc_layer=1, dec_layer=1, enc_head=2,
            dec_head=2, dropout=0.0)
CHUNKS = (160, 4096, 100_000)
SECONDS = 5.3          # ~332 frames = 3 blocks
ATOL = 2e-5            # posteriors: stream vs offline, within one package
# posteriors, the port's stream vs JAX's: the two frontends' f32 DFTs part by
# up to 1.3e-4 in log-mel on this audio, and the offline transcripts of the
# two packages by up to 3.6e-5 (with the same features: 1.4e-5)
ATOL_JAX = 5e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: many small ops, and the suite's workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _audio(rng, seconds, sr, f0=440.0):
    t = np.arange(int(seconds * sr)) / sr
    wav = 0.2 * np.sin(2 * np.pi * f0 * t) * (np.sin(2 * np.pi * 0.7 * t)
                                              > 0)
    return (wav + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    """The JAX tests' tiny model, its weights carried to the port."""
    jcfg, cfg = JConfig(model=JModelConfig(**TINY)), Config(
        model=ModelConfig(**TINY))
    # init_params(jcfg, key) with the flax init jitted: the same values
    key = jax.random.key(0)
    params = reference_initialize(jax.jit(
        lambda k: init_params(jcfg, k, reference_init=False))(key), key)
    model = HFT(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg), strict=True)
    model.eval()
    return jcfg, params, cfg, model


def _stream(st, wav, chunk):
    live = 0
    for i in range(0, wav.shape[0], chunk):
        live += len(st.feed(wav[i: i + chunk]))
    st.flush()
    return live


@pytest.fixture(scope="module")
def runs(tiny):
    """Per chunk size: the port's and JAX's streamed posteriors, the port's
    notes and block paths; and the port's offline transcript."""
    jcfg, params, cfg, model = tiny
    wav = _audio(np.random.default_rng(1234), SECONDS, cfg.feature.sr)
    tr = Transcriber(cfg, model, "cpu", batch_windows=2)
    jtr = JTranscriber(jcfg, params=params, batch_windows=2)
    out = {"wav": wav, "tr": tr,
           "offline": tr.transcript(tr.frontend(wav).numpy())}
    fused = None
    for chunk in CHUNKS:
        st = StreamingTranscriber(cfg, transcriber=tr)
        live = _stream(st, wav, chunk)
        jst = JStream(jcfg, params=params, transcriber=jtr)
        # one jitted block step for the three JAX streams (the same config
        # and transcriber): compiled once per shape, not once per stream
        jst._fused_step = fused
        _stream(jst, wav, chunk)
        fused = jst._fused_step
        out[chunk] = dict(post=st.posteriors(), notes=st.notes(), live=live,
                          paths=dict(st.paths), frames=st.frames_emitted,
                          jax=jst.posteriors())
    return out


def _assert_posteriors_close(got, want, atol, what):
    assert set(got) == set(want), what
    for key, ref in want.items():
        ref = np.asarray(ref)
        assert got[key].shape == ref.shape, (what, key)
        if key.startswith("velocity"):
            np.testing.assert_array_equal(got[key], ref,
                                          err_msg=f"{what} {key}")
        else:
            np.testing.assert_allclose(got[key], ref, atol=atol,
                                       err_msg=f"{what} {key}")


@pytest.mark.parametrize("chunk", CHUNKS)
def test_stream_matches_jax_stream(runs, chunk):
    r = runs[chunk]
    _assert_posteriors_close(r["post"], r["jax"], ATOL_JAX,
                             f"chunk {chunk}")


@pytest.mark.parametrize("chunk", CHUNKS)
def test_stream_matches_offline(runs, chunk):
    """The port's stream equals the port's offline transcript, and its
    notes the decode of its posteriors; blocks were emitted before the
    flush, the steady state by the one-copy block path."""
    r, offline, tr = runs[chunk], runs["offline"], runs["tr"]
    assert r["frames"] == offline["onset_A"].shape[0]
    assert r["live"] >= 1
    assert r["paths"]["fused"] >= (1 if chunk < 10_000 else 0)
    assert sum(r["paths"].values()) == r["frames"] // 128
    _assert_posteriors_close(r["post"], offline, ATOL, f"chunk {chunk}")
    post = r["post"]
    assert r["notes"] == tr.mpe2note(post["onset_B"], post["offset_B"],
                                     post["mpe_B"], post["velocity_B"])


def test_segment_features_match_jax(tiny):
    """``features_from_sample_blocks`` (un-centred segments, one call for
    all) and ``features_from_frames`` against JAX's, within 2e-4 (the
    f32 DFT's summation orders differ)."""
    from nylon_amt_tpu.ops.mel import MelFrontend as JMel
    from nylon_amt_tpu_torch.ops.mel import MelFrontend

    jcfg, _, cfg, _ = tiny
    rng = np.random.default_rng(7)
    segs = _audio(rng, 3 * 2.6, cfg.feature.sr).reshape(3, -1)[:, :(
        150 - 1) * 256 + 2048]
    got = MelFrontend(cfg.feature, "cpu").features_from_sample_blocks(segs)
    want = np.asarray(JMel(jcfg.feature).features_from_sample_blocks(segs))
    assert got.shape == want.shape == (3, 150, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    frames = segs[:, :2048]
    got = MelFrontend(cfg.feature, "cpu").features_from_frames(frames)
    want = np.asarray(JMel(jcfg.feature).features_from_frames(frames))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_streamed_features_match_the_whole_file(tiny):
    """The finalized frames' rows equal the whole-file frontend's (the plain
    f32 matmuls over other frame counts: reduction-order ulps)."""
    _, _, cfg, model = tiny
    wav = _audio(np.random.default_rng(5), 2.0, cfg.feature.sr)
    tr = Transcriber(cfg, model, "cpu")
    st = StreamingTranscriber(cfg, transcriber=tr)
    for i in range(0, wav.shape[0], 3333):
        st.feed(wav[i: i + 3333])
    full = tr.frontend(wav).numpy()
    n = st._next_frame
    assert 0 < n < full.shape[0] + 1
    st._featurize_pending()
    np.testing.assert_allclose(st._feat, full[st._feat_start: n], atol=3e-4)
    st.flush()
    assert st._next_frame == full.shape[0]


@pytest.mark.parametrize("seconds", [0.0, 0.05, 2.048])
def test_stream_edge_lengths(tiny, seconds):
    """Empty, shorter than one STFT frame, exactly one block of hops: the
    flushed stream still equals the offline path."""
    _, _, cfg, model = tiny
    rng = np.random.default_rng(11)
    wav = (0.1 * rng.standard_normal(int(seconds * cfg.feature.sr))
           ).astype(np.float32)
    tr = Transcriber(cfg, model, "cpu", batch_windows=2)
    st = StreamingTranscriber(cfg, transcriber=tr)
    if wav.size:
        st.feed(wav)
    st.feed(np.zeros(0, np.float32))      # empty feeds are no-ops
    st.flush()
    offline = tr.transcript(tr.frontend(wav).numpy())
    _assert_posteriors_close(st.posteriors(), offline, ATOL, f"{seconds} s")


def test_stream_single_sample_feeds(tiny):
    _, _, cfg, model = tiny
    rng = np.random.default_rng(12)
    wav = (0.1 * rng.standard_normal(int(0.2 * cfg.feature.sr))
           ).astype(np.float32)
    tr = Transcriber(cfg, model, "cpu", batch_windows=1)
    st = StreamingTranscriber(cfg, transcriber=tr)
    for s in wav:
        st.feed(np.asarray([s]))
    st.flush()
    _assert_posteriors_close(st.posteriors(),
                             tr.transcript(tr.frontend(wav).numpy()), ATOL,
                             "single samples")


def test_feed_after_flush_raises(tiny):
    _, _, cfg, model = tiny
    st = StreamingTranscriber(cfg, model, "cpu", batch_windows=1)
    assert st.flush() != [] and st.flush() == []
    with pytest.raises(RuntimeError):
        st.feed(np.zeros(100, np.float32))
    with pytest.raises(ValueError):
        StreamingTranscriber(cfg, device="cpu")


def test_pop_stable_notes_matches_offline(runs, tiny):
    """The pops during the stream plus the final pop equal the offline
    decode of the whole stream (times to a float add), no duplicates."""
    _, _, cfg, _ = tiny
    wav, tr = runs["wav"], runs["tr"]
    st = StreamingTranscriber(cfg, transcriber=tr)
    popped = []
    for i in range(0, wav.shape[0], 4000):
        if st.feed(wav[i: i + 4000]):
            popped.extend(st.pop_stable_notes())
    st.flush()
    popped.extend(st.pop_stable_notes(final=True))
    off = runs["offline"]
    ref = tr.mpe2note(off["onset_B"], off["offset_B"], off["mpe_B"],
                      off["velocity_B"])
    _assert_notes_equal(popped, ref)
    assert ref


def _assert_notes_equal(got, ref):
    # by pitch: across pitches equal onsets may swap by one float ulp
    order = lambda x: (x["pitch"], x["onset"], x["offset"])
    got, ref = sorted(got, key=order), sorted(ref, key=order)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["pitch"] == r["pitch"] and g["velocity"] == r["velocity"]
        assert abs(g["onset"] - r["onset"]) < 1e-9
        assert abs(g["offset"] - r["offset"]) < 1e-9


def _block_post(cfg, pitch):
    nf, nn = cfg.input.num_frame, cfg.midi.num_note
    onset, offset, mpe = (np.zeros((1, nf, nn), np.float32) for _ in range(3))
    vel = np.zeros((1, nf, nn), np.int8)
    onset[0, 10, pitch], offset[0, 40, pitch] = 0.9, 0.9
    mpe[0, 10:41, pitch] = 0.9
    vel[0, 10, pitch] = 80
    return {"onset_A": onset, "offset_A": offset, "mpe_A": mpe,
            "velocity_A": vel}


@pytest.mark.parametrize("mode", ["single", "combination"])
def test_pop_stable_notes_prunes(tiny, mode):
    """Deferred sessions with injected posteriors (one clear note a block;
    A heads only, so "combination" must pick the family from the stored
    keys): the retained posteriors and the per-pitch state stay bounded on
    a long stream, and every injected note is popped once."""
    _, _, cfg, model = tiny
    st = StreamingTranscriber(cfg, model, "cpu", mode=mode, defer=True)
    hop, nf = cfg.feature.hop_sample, cfg.input.num_frame
    popped, max_blocks, max_keys = [], 0, 0
    for _ in range(24):
        st.feed(np.zeros(nf * hop, np.float32))
        blocks = st._ready_block_ids(final=False)
        for k in blocks:
            st.accept_posteriors([k], _block_post(cfg, 40))
        if blocks:
            popped += st.pop_stable_notes()
            max_blocks = max(max_blocks, len(st._posteriors))
            max_keys = max(max_keys, len(st._frontier))
    assert len(popped) >= 20
    assert all(n["pitch"] == 40 + cfg.midi.note_min for n in popped)
    assert len({round(n["onset"], 4) for n in popped}) == len(popped)
    assert max_blocks <= 4 and st._post_start > 0
    assert max_keys == 1          # one (family, pitch) entry


def _dense_post(rng, cfg, levels=(0.0, 0.3, 0.6, 0.7)):
    """One block of random posteriors with many notes: every head drawn
    from a few levels, so equal neighbours (plateaus) are common."""
    nf, nn = cfg.input.num_frame, cfg.midi.num_note
    draw = lambda p: np.asarray(levels, np.float32)[rng.choice(
        len(levels), size=(1, nf, nn), p=p)]
    return {"onset_A": draw([0.85, 0.05, 0.05, 0.05]),
            "offset_A": draw([0.85, 0.05, 0.05, 0.05]),
            "mpe_A": draw([0.3, 0.1, 0.3, 0.3]),
            "velocity_A": rng.integers(0, 128, (1, nf, nn)).astype(np.int8)}


def test_pop_stable_notes_dense_matches_the_full_decode(tiny):
    """Injected dense posteriors (~100 notes a second, two-frame plateaus
    that give two notes of one pitch at one onset time): the notes popped
    over a long stream, with pruning, are exactly the decode of all the
    posteriors the stream emitted."""
    _, _, cfg, model = tiny
    rng = np.random.default_rng(31)
    st = StreamingTranscriber(cfg, model, "cpu", mode="single", defer=True)
    hop, nf = cfg.feature.hop_sample, cfg.input.num_frame
    blocks, popped = [], []
    for _ in range(40):
        st.feed(np.zeros(nf * hop // 2, np.float32))
        for k in st._ready_block_ids(final=False):
            blocks.append(_dense_post(rng, cfg))
            st.accept_posteriors([k], blocks[-1])
        popped += st.pop_stable_notes()
    st.flush()
    for k in st._ready_block_ids(final=True):
        blocks.append(_dense_post(rng, cfg))
        st.accept_posteriors([k], blocks[-1])
    popped += st.pop_stable_notes(final=True)
    post = {k: np.concatenate([b[k][0] for b in blocks]) for k in blocks[0]}
    ref = st.tr.mpe2note(post["onset_A"], post["offset_A"], post["mpe_A"],
                         post["velocity_A"])
    assert st._post_start > 0 and len(ref) > 1000
    _assert_notes_equal(popped, ref)
