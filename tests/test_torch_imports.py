"""Import hygiene and the no-fallback rule of the port, each checked in a
fresh interpreter (this test process has JAX loaded already)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

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
                 "models.convert", "models.init"):
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


def test_off_cpu_tensors_never_take_the_plain_path():
    """A tensor that is not on the CPU goes to the kernel route, which
    raises here (no card, no nvcc); the launch counts stay 0. On this
    machine a CUDA tensor cannot even be made, so a meta tensor stands in."""
    out = _last_json(_python(
        "import json, torch\n"
        "from nylon_amt_tpu_torch import Config, kernels\n"
        "from nylon_amt_tpu_torch.ops import layer_fused as lf\n"
        "from nylon_amt_tpu_torch.ops import attention as att\n"
        "from nylon_amt_tpu_torch.ops import layer_fused_train as lt\n"
        "from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq\n"
        "from nylon_amt_tpu_torch.ops.mel import MelFrontend\n"
        "from nylon_amt_tpu_torch.ops.spectrogram import log_mel\n"
        "res = {}\n"
        "try:\n"
        "    torch.zeros(1, device='cuda')\n"
        "    res['cuda_tensor'] = 'made'\n"
        "except (RuntimeError, AssertionError) as e:\n"
        "    res['cuda_tensor'] = 'raised'\n"
        "hid, pf, n = 256, 512, 2\n"
        "def t(*s, dt=torch.bfloat16):\n"
        "    return torch.empty(s, dtype=dt, device='meta')\n"
        "ep = lf.EncoderLayerParams(t(hid, 3*hid), t(3*hid), t(hid, hid),"
        " t(hid), t(hid, dt=torch.float32), t(hid, dt=torch.float32),"
        " t(hid, pf), t(pf), t(pf, hid), t(hid))\n"
        "cp = lf.CrossLayerParams(t(hid, 3*hid), t(3*hid), t(hid, hid),"
        " t(hid), t(hid, hid), t(hid), t(hid, 2*hid), t(2*hid),"
        " t(hid, hid), t(hid), t(hid, dt=torch.float32),"
        " t(hid, dt=torch.float32), t(hid, pf), t(pf), t(pf, hid), t(hid))\n"
        "calls = {\n"
        "  'encoder_layer_with_stem': lambda: lf.encoder_layer_with_stem("
        "t(n, 192, 256, dt=torch.float32), t(65, hid, dt=torch.float32),"
        " t(hid, dt=torch.float32), t(256, hid), ep, 4, 128,"
        " torch.bfloat16),\n"
        "  'encoder_layer': lambda: lf.encoder_layer(t(n, 256, hid), ep, 4),\n"
        "  'decoder_layer_zero': lambda: lf.decoder_layer_zero("
        "t(n, 88, hid), t(n, 256, hid), cp, 4),\n"
        "  'decoder_layer': lambda: lf.decoder_layer("
        "t(n, 88, hid), t(n, 256, hid), cp, 4),\n"
        "  'log_mel': lambda: log_mel(t(16000, dt=torch.float32),"
        " MelFrontend(Config().feature, 'cpu')),\n"
        "  'hash_keep_mask': lambda: att.hash_keep_mask(1, 2, 0,"
        " (n, 256, hid), 0.1, torch.bfloat16, 'meta'),\n"
        "  'apply_keep_mask': lambda: att.apply_keep_mask(t(n, 256, hid), 1,"
        " 6, 0.1),\n"
        "  'encoder_layer_train': lambda: lt.encoder_layer_train("
        "t(n, 256, hid), ef, 3, 4, 0.1, True),\n"
        "  'decoder_layer_zero_train': lambda: lt.decoder_layer_zero_train("
        "t(n, 88, hid), t(n, 256, hid), zf, 3, 4, 0.1),\n"
        "  'decoder_layer_train': lambda: lt.decoder_layer_train("
        "t(n, 88, hid), t(n, 256, hid), df, 3, 4, 0.1),\n"
        "  'encoder_layer_with_stem_q8': lambda: lq.encoder_layer_with_stem_q8("
        "t(n, 192, 256, dt=torch.float32), t(65, hid, dt=torch.float32),"
        " t(hid, dt=torch.float32), t(256, hid), eq, 4, 128,"
        " torch.bfloat16),\n"
        "  'encoder_layer_q8': lambda: lq.encoder_layer_q8(t(n, 256, hid), eq,"
        " 4),\n"
        "  'decoder_layer_zero_q8': lambda: lq.decoder_layer_zero_q8("
        "t(n, 88, hid), t(n, 256, hid), cq, 4),\n"
        "  'decoder_layer_q8': lambda: lq.decoder_layer_q8("
        "t(n, 88, hid), t(n, 256, hid), cq, 4),\n"
        "  'fused_mha': lambda: att.fused_mha(t(n, 88, hid), t(n, 256, hid),"
        " t(n, 256, hid), 4, 0.125),\n"
        "  'fused_mha_with_probs': lambda: att.fused_mha_with_probs("
        "t(n, 88, hid), t(n, 256, hid), t(n, 256, hid), 4, 0.125),\n"
        "  'fused_mha_dropout': lambda: att.fused_mha_dropout("
        "t(n, 88, hid), t(n, 256, hid), t(n, 256, hid), 4, 0.125, 0.1, 7),\n"
        "  'dropout': lambda: att.dropout(t(n, 88, hid), 7, 1, 0.1),\n"
        "}\n"
        "i8 = lambda *s: t(*s, dt=torch.int8)\n"
        "f32 = lambda *s: t(*s, dt=torch.float32)\n"
        "ef = lf.EncoderLayerParams(*(f32(*x.shape) for x in ep))\n"
        "df = lt.DecLayerParams(*(f32(*x.shape) for x in cp))\n"
        "zf = lt.DecZeroParams(*df[4:])\n"
        "eq = lq.quantize_encoder_params(ef)\n"
        "eq = eq._replace(**{f: i8(*getattr(eq, f).shape) for f in"
        " eq._fields if f.startswith('w')})\n"
        "cq = lq.quantize_cross_params(df)\n"
        "cq = cq._replace(**{f: i8(*getattr(cq, f).shape) for f in"
        " cq._fields if f.startswith('w')})\n"
        "for name, call in calls.items():\n"
        "    try:\n"
        "        call()\n"
        "        res[name] = 'returned'\n"
        "    except (RuntimeError, ValueError) as e:\n"
        "        res[name] = 'raised'\n"
        "res['launches'] = kernels.launches\n"
        "print(json.dumps(res))\n"))
    launches = out.pop("launches")
    assert "encoder_layer_train_bwd" in launches
    assert "fused_mha_dropout_bwd" in launches
    assert set(launches.values()) == {0}
    assert set(out.values()) == {"raised"}, out


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
