"""Import hygiene and the no-fallback rule of the port, each checked in a
fresh interpreter (this test process has JAX loaded already)."""

import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _python(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _last_json(proc) -> dict:
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_never_imports_jax():
    """After every module of the port is imported, no module of JAX, flax or
    the JAX package (``nylon_amt_tpu``, ``nylon_amt_tpu.*``) is loaded."""
    out = _last_json(_python(
        "import importlib, json, pkgutil, sys\n"
        "import nylon_amt_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,"
        " 'nylon_amt_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = lambda m: m in ('jax', 'jaxlib', 'flax', 'nylon_amt_tpu') or"
        " m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'nylon_amt_tpu')\n"
        "print(json.dumps({'modules': names,"
        " 'loaded': sorted(m for m in sys.modules if bad(m))}))\n"))
    for name in ("ops.layer_fused", "ops.layer_fused_train", "ops.attention",
                 "models.fused_train", "train.step", "train.loop",
                 "train.checkpoint", "train.importer", "config", "midi.smf",
                 "native.build", "data.corpus", "data.windows", "cli",
                 "ops.layer_fused_q8", "data.lists", "infer.tab",
                 "infer.sheet", "labels", "labels.midi2note", "metrics",
                 "metrics.transcription", "metrics.multipitch",
                 "metrics.harness", "models.hft", "models.ablation",
                 "models.convert", "models.init", "labels.note2label",
                 "labels.note2ref", "train.metrics", "utils.profiling",
                 "tools.proof_corpus", "tools.learning_proof",
                 "infer.stream", "infer.serve", "tools.stream_bench",
                 "data.prefetch", "data.device_windows",
                 "tools.guitar_proof"):
        assert f"nylon_amt_tpu_torch.{name}" in out["modules"], name
    assert out["loaded"] == []


def test_chip_smoke_imports_no_jax_package():
    """chip_smoke.py imports nothing of JAX or the JAX package (checked
    without running it: its module body only defines functions)."""
    out = _last_json(_python(
        "import json, runpy, sys\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'flax', 'nylon_amt_tpu'))))\n"))
    assert out == []


def test_kernel_load_raises_without_nvcc(tmp_path):
    out = _last_json(_python(
        "import json\n"
        "from pathlib import Path\n"
        "from nylon_amt_tpu_torch import kernels\n"
        f"kernels.BUILD_ROOT = Path({str(tmp_path)!r})\n"
        "kernels.find_nvcc = lambda: None\n"
        "try:\n"
        "    lib = kernels.load()\n"
        "    res = {'raised': False, 'returned': repr(lib)}\n"
        "except RuntimeError as e:\n"
        "    res = {'raised': True, 'msg': str(e)}\n"
        "print(json.dumps(res))\n"))
    assert out["raised"], out
    assert "nvcc not found" in out["msg"]


# The child of test_off_cpu_tensors_never_take_the_plain_path. A CUDA
# tensor cannot be made on a machine without a card, so a meta tensor stands
# in for one: the device checks take meta for the card (the dtype, shape and
# contiguity checks stay), the device guard and the stream are stubs, and
# the kernel loader finds no nvcc. A wrapper whose gates let its inputs pass
# then raises the loader's RuntimeError.
_OFF_CPU_CHILD = """
import contextlib, json, torch
from pathlib import Path
from nylon_amt_tpu_torch import Config, kernels
from nylon_amt_tpu_torch.ops import layer_fused as lf
from nylon_amt_tpu_torch.ops import attention as att
from nylon_amt_tpu_torch.ops import layer_fused_train as lt
from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq
from nylon_amt_tpu_torch.ops.mel import MelFrontend
from nylon_amt_tpu_torch.ops.spectrogram import log_mel, log_mel_segments
kernels.BUILD_ROOT = Path('@BUILD@')
kernels.find_nvcc = lambda: None


def check_cuda(name, t, dtype, ndim=None):
    if t.device.type != 'meta':
        raise ValueError(f'{name}: expected a meta tensor, got {t.device}')
    if t.dtype != dtype:
        raise ValueError(f'{name}: expected {dtype}, got {t.dtype}')
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f'{name}: expected {ndim} dims')
    if not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')


kernels.check_cuda = check_cuda
kernels.stream_of = lambda t: 0
torch.cuda.device = lambda d: contextlib.nullcontext()
try:
    torch.zeros(1, device='cuda')
    cuda_tensor = 'made'
except (RuntimeError, AssertionError):
    cuda_tensor = 'raised'


def t(*s, dt):
    return torch.empty(s, dtype=dt, device='meta')


f32 = lambda *s: t(*s, dt=torch.float32)
i8 = lambda *s: t(*s, dt=torch.int8)


def geometry(dt, hid, heads, pf):
    a = lambda *s: t(*s, dt=dt)
    tag = f'/D{hid // heads}'
    ep = lf.EncoderLayerParams(a(hid, 3*hid), a(3*hid), a(hid, hid), a(hid),
                               f32(hid), f32(hid), a(hid, pf), a(pf),
                               a(pf, hid), a(hid))
    cp = lf.CrossLayerParams(a(hid, 3*hid), a(3*hid), a(hid, hid), a(hid),
                             a(hid, hid), a(hid), a(hid, 2*hid), a(2*hid),
                             a(hid, hid), a(hid), f32(hid), f32(hid),
                             a(hid, pf), a(pf), a(pf, hid), a(hid))
    ef = lf.EncoderLayerParams(*(f32(*x.shape) for x in ep))
    df = lt.DecLayerParams(*(f32(*x.shape) for x in cp))
    zf = lt.DecZeroParams(*df[4:])
    eq = lq.quantize_encoder_params(ep)
    eq = eq._replace(**{f: i8(*getattr(eq, f).shape) for f in eq._fields
                        if f.startswith('w')})
    cq = lq.quantize_cross_params(cp)
    cq = cq._replace(**{f: i8(*getattr(cq, f).shape) for f in cq._fields
                        if f.startswith('w')})
    ew, cw = lq.pack_wt(eq), lq.pack_wt(cq)  # as pack_params hands them
    n = 2
    stem = (f32(n, 192, 256), f32(65, hid), f32(hid), a(256, hid))
    x, trg, enc = a(n, 256, hid), a(n, 88, hid), a(n, 256, hid)
    calls = {
        'encoder_layer_with_stem': lambda: lf.encoder_layer_with_stem(
            *stem, ep, heads, 128, dt),
        'encoder_layer': lambda: lf.encoder_layer(x, ep, heads),
        'decoder_layer_zero': lambda: lf.decoder_layer_zero(
            trg, enc, cp, heads),
        'decoder_layer': lambda: lf.decoder_layer(trg, enc, cp, heads),
        'hash_keep_mask': lambda: att.hash_keep_mask(
            1, 2, 0, (n, 256, hid), 0.1, dt, 'meta'),
        'apply_keep_mask': lambda: att.apply_keep_mask(x, 1, 6, 0.1),
        'encoder_layer_train': lambda: lt.encoder_layer_train(
            x, ef, 3, heads, 0.1, True),
        'decoder_layer_zero_train': lambda: lt.decoder_layer_zero_train(
            trg, enc, zf, 3, heads, 0.1),
        'decoder_layer_train': lambda: lt.decoder_layer_train(
            trg, enc, df, 3, heads, 0.1),
        'encoder_layer_with_stem_q8': lambda: lq.encoder_layer_with_stem_q8(
            *stem, eq, heads, 128, dt, wt=ew),
        'encoder_layer_q8': lambda: lq.encoder_layer_q8(x, eq, heads, wt=ew),
        'decoder_layer_zero_q8': lambda: lq.decoder_layer_zero_q8(
            trg, enc, cq, heads, wt=cw),
        'decoder_layer_q8': lambda: lq.decoder_layer_q8(trg, enc, cq, heads,
                                                        wt=cw),
        'fused_mha': lambda: att.fused_mha(trg, enc, enc, heads, 0.125),
        'fused_mha_with_probs': lambda: att.fused_mha_with_probs(
            trg, enc, enc, heads, 0.125),
        'fused_mha_dropout': lambda: att.fused_mha_dropout(
            trg, enc, enc, heads, 0.125, 0.1, 7),
        'dropout': lambda: att.dropout(trg, 7, 1, 0.1),
    }
    return {name + tag: call for name, call in calls.items()}


out = {}
for dt_name in ('bfloat16', 'float32', 'float16'):
    dt = getattr(torch, dt_name)
    calls = {'log_mel': lambda: log_mel(f32(16000),
                                        MelFrontend(Config().feature, 'cpu')),
             'log_mel_segments': lambda: log_mel_segments(
                 f32(3, 8192), MelFrontend(Config().feature, 'cpu'))}
    calls.update(geometry(dt, 256, 4, 512))  # head_dim 64, the paper widths
    calls.update(geometry(dt, 64, 2, 128))   # head_dim 32, the default widths
    res = {'cuda_tensor': cuda_tensor}
    for name, call in calls.items():
        try:
            call()
            res[name] = ['returned', '']
        except (RuntimeError, ValueError) as e:
            res[name] = [type(e).__name__, str(e)]
    res['launches'] = dict(kernels.launches)
    out[dt_name] = res
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=1)
def _off_cpu_results() -> dict:
    """The child's results for every dtype (one interpreter for all)."""
    with tempfile.TemporaryDirectory() as build:
        return _last_json(_python(_OFF_CPU_CHILD.replace("@BUILD@", build)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_off_cpu_tensors_never_take_the_plain_path(dtype):
    """A tensor that is not on the CPU goes to the kernel route, which
    raises here (no card, no nvcc); the launch counts stay 0. For bfloat16
    and float32 activations, at head_dim 64 and at head_dim 32 (the default
    widths; int8 included), every layer, attention and mask wrapper gets
    past its dtype and geometry gates to the kernel loader and raises its
    "nvcc not found"; float16 activations stop at the dtype gate with a
    ValueError: no cast to another dtype, no plain path."""
    out = dict(_off_cpu_results()[dtype])
    launches = out.pop("launches")
    assert out.pop("cuda_tensor") == "raised"
    assert "encoder_layer_train_bwd" in launches
    assert "fused_mha_dropout_bwd" in launches
    assert set(launches.values()) == {0}
    assert out.pop("log_mel")[0] in ("RuntimeError", "ValueError")
    assert out.pop("log_mel_segments")[0] in ("RuntimeError", "ValueError")
    assert len(out) == 2 * 17, sorted(out)
    for name, (kind, msg) in out.items():
        if dtype == "float16":
            assert kind == "ValueError" and "float16" in msg, (name, msg)
        else:
            assert kind == "RuntimeError", (name, kind, msg)
            assert "nvcc not found" in msg, (name, msg)


# The child of test_cli_corpus_never_takes_the_plain_path: `cli corpus` on
# --device cuda (no card here) and on --device meta, a meta tensor standing
# in for a card's as above (device checks, guard and stream stubbed, no
# nvcc).
_CORPUS_CHILD = """
import contextlib, json, os, sys, torch
from pathlib import Path
from nylon_amt_tpu_torch import cli, kernels
kernels.BUILD_ROOT = Path(sys.argv[1])
kernels.find_nvcc = lambda: None


def check_cuda(name, t, dtype, ndim=None):
    if t.device.type != 'meta' or t.dtype != dtype:
        raise ValueError(f'{name}: expected a meta {dtype} tensor')


kernels.check_cuda = check_cuda
kernels.stream_of = lambda t: 0
torch.cuda.device = lambda d: contextlib.nullcontext()
out = {}
for device in ('cuda', 'meta'):
    d = os.path.join(sys.argv[3], device)
    try:
        rc = cli.main(['corpus', '--lists', sys.argv[2], '--out', d,
                       '--device', device])
        out[device] = ['returned', str(rc)]
    except (RuntimeError, AssertionError, ValueError) as e:
        out[device] = [type(e).__name__, str(e)]
    out[device].append(sorted(f for f in os.listdir(d) if f.endswith('.npy'))
                       if os.path.isdir(d) else [])
out['launches'] = kernels.launches['log_mel']
print(json.dumps(out))
"""


def test_cli_corpus_never_takes_the_plain_path(tmp_path):
    """``cli corpus --device cuda`` without a card raises, and on a meta
    device (a card's stand-in) the log-mel kernel's route reaches the
    loader's "nvcc not found": no features are computed on the CPU instead
    and no split array is written."""
    import numpy as np

    from nylon_amt_tpu_torch.midi.smf import write_notes
    from nylon_amt_tpu_torch.utils.wavio import save_wav

    save_wav(str(tmp_path / "p.wav"),
             0.3 * np.sin(np.arange(16000) * 0.1).astype(np.float32), 16000)
    write_notes(str(tmp_path / "p.mid"), [{"pitch": 60, "onset": 0.1,
                                           "offset": 0.5, "velocity": 80}])
    (tmp_path / "lists").mkdir()
    (tmp_path / "lists" / "train.tsv").write_text(
        f"p\t{tmp_path / 'p.wav'}\t{tmp_path / 'p.mid'}\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _CORPUS_CHILD, str(tmp_path / "build"),
         str(tmp_path / "lists"), str(tmp_path / "out")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    out = _last_json(proc)
    assert out["launches"] == 0
    kind, msg, written = out["cuda"]
    assert kind in ("RuntimeError", "AssertionError") and written == [], msg
    assert out["meta"] == ["RuntimeError", out["meta"][1], []]
    assert "nvcc not found" in out["meta"][1]


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    # alone in a directory, without the package beside it
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
