"""A/B a train step between source trees in one run on the card, its time
split into host and device time: the default configuration's float32
step, or (``--config``) the paper configuration's bf16 step through the
fused layers (``paper``, ``chip_smoke.py`` (j)) or through the per-site
path with ``--remat`` (``remat``, (l)).

Each tree is a checkout of this repository (the working tree, a parent
commit unpacked with ``git archive`` under ``build/``). Each run is an
interpreter of its own, started from that tree's root, so that it imports
that tree's package and builds that tree's kernels (under its own
``build/``); the runs go in the order A B B A (``--order``), so that a
drift of the card shows as two readings of one tree that differ.

A run takes the seeded batch that ``chip_smoke.py`` (n) times (the
configuration's own: batch 8, dropout on; the tree's own ``chip_smoke.py``
makes it), warms up, and then reads over ``--steps`` steps, ``--reps``
times:

* ``wall_ms``: the step's time by CUDA events (the card's clock);
* ``host_ms``: the host's time to issue a step, the loop timed without a
  synchronisation inside it (when it equals ``wall_ms`` the host sets
  the pace);
* ``busy_ms``: the kernels' device time per step, by ``torch.profiler``
  over ``--steps`` more steps, and ``idle`` = 1 - busy / wall.

Each run prints a line ``STEP_AB {json}``; the summary gives each tree's
median. With ``--twice`` each tree's step runs instead twice from one
saved state (``chip_smoke.py``'s ``step_twice``, this checkout's), and
the line names the gradients and parameters whose bits differ between
the two runs. Run from the root of a checkout on the card::

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python -m nylon_amt_tpu_torch.tools.step_ab new=. old=build/parent
    python -m nylon_amt_tpu_torch.tools.step_ab new=. old=build/parent \
        --config paper --twice

It prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

_CHILD = r"""
import dataclasses, json, sys, tempfile, time
from pathlib import Path
import numpy as np
import torch
sys.path.insert(0, str(Path.cwd()))
import chip_smoke as cs
from nylon_amt_tpu_torch import Config, ModelConfig
from nylon_amt_tpu_torch.data.corpus import SplitArrays
from nylon_amt_tpu_torch.data.windows import WindowDataset
from nylon_amt_tpu_torch.ops.mel import MelFrontend
from nylon_amt_tpu_torch.train import step as st
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

steps, reps, which = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dev = torch.device("cuda:0")
cfg = Config() if which == "default" else Config(model=dataclasses.replace(
    ModelConfig.paper_scale(), compute_dtype="bfloat16",
    remat=which == "remat"))
audio = cs.synth_audio(cs.AUDIO_SEC, np.random.default_rng(cs.SEED))
feat = MelFrontend(cfg.feature, dev)(torch.from_numpy(audio).to(dev))
(Path.cwd() / "build").mkdir(exist_ok=True)
with tempfile.TemporaryDirectory(dir=Path.cwd() / "build") as tmp:
    cs.write_corpus(cfg, feat, Path(tmp) / "corpus")
    ds = WindowDataset(SplitArrays.load(str(Path(tmp) / "corpus"), "train"),
                       cfg, n_slice=cfg.train.n_slice)
    first = next(ds.batches(cfg.train.batch_size))
if len(sys.argv) > 4:  # --twice: the step_twice of the given chip_smoke.py
    import runpy
    twice = runpy.run_path(sys.argv[4])["step_twice"](cfg, first, dev)
    print("STEP_TWICE " + json.dumps(dict(twice, tree=str(Path.cwd()))),
          flush=True)
    sys.exit(0)
state = st.create_train_state(cfg, cs.SEED, dev)
batch = st.to_device(first, dev)
gen = torch.Generator().manual_seed(cs.SEED)
apply, draw = st.make_apply(cfg)


def step():
    st.train_step(cfg, state, batch, draw(cfg, gen), apply)


for _ in range(3):
    step()
torch.cuda.synchronize()
wall, host = [], []
for _ in range(reps):
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    host.append((time.perf_counter() - t0) * 1e3 / steps)
    e1.record()
    torch.cuda.synchronize()
    wall.append(e0.elapsed_time(e1) / steps)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
busy = sum(e.self_device_time_total for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA) / 1e3 / steps
w = sorted(wall)[len(wall) // 2]
print("STEP_AB " + json.dumps({
    "tree": str(Path.cwd()), "wall_ms": w, "wall_ms_all": wall,
    "host_ms": sorted(host)[len(host) // 2], "host_ms_all": host,
    "busy_ms": busy, "idle": 1 - busy / w}), flush=True)
"""


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not found"


# what --config times: the default Config() (f32), the paper config (bf16)
# through the fused layers, and through the per-site path with --remat
CONFIGS = {"default": "default Config() f32 train step",
           "paper": "paper bf16 fused train step",
           "remat": "paper bf16 --remat per-site train step"}


# the chip_smoke.py whose step_twice --twice runs in every tree
_SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"


def run(tree: Path, steps: int, reps: int, which: str = "default",
        twice: bool = False) -> dict:
    """One timed run of ``tree``'s step in a fresh interpreter (with
    ``twice``, one ``step_twice`` of it instead)."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    tag = "STEP_TWICE " if twice else "STEP_AB "
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(steps),
                           str(reps), which] + ([str(_SMOKE)] if twice
                                                else []),
                          cwd=tree, env=env, capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(tag)]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{tree}: rc {proc.returncode}\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len(tag):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="NAME=PATH of each tree")
    ap.add_argument("--order", default="ABBA",
                    help="the runs, a letter a tree in the order given")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--config", choices=tuple(CONFIGS), default="default")
    ap.add_argument("--twice", action="store_true",
                    help="instead of timing: run one step twice from one "
                    "saved state in each tree (chip_smoke.py's step_twice) "
                    "and print the tensors that differ")
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.trees)
    names = list(trees)
    print(_card(), flush=True)
    if args.twice:
        for name in names:
            r = run(Path(trees[name]).resolve(), 0, 0, args.config, True)
            print(f"STEP_TWICE {name} " + json.dumps(r), flush=True)
            print(f"step_twice {name}: {CONFIGS[args.config]} (batch 8) "
                  f"run twice from one state: loss {r['loss']}, "
                  f"{len(r['grads'])} of {r['tensors']} gradients and "
                  f"{len(r['params'])} parameters differ; gradients "
                  f"{r['grads']}", flush=True)
        return 0
    out = {n: [] for n in names}
    for letter in args.order:
        name = names[ord(letter) - ord("A")]
        r = run(Path(trees[name]).resolve(), args.steps, args.reps,
                args.config)
        out[name].append(r)
        print(f"STEP_AB {name} " + json.dumps(r), flush=True)
    for name, rs in out.items():
        med = {k: statistics.median(r[k] for r in rs)
               for k in ("wall_ms", "host_ms", "busy_ms", "idle")}
        print(f"step_ab {name}: {CONFIGS[args.config]} (batch 8) wall "
              f"{med['wall_ms']:.3f} ms, host {med['host_ms']:.3f} ms "
              f"to issue, device-busy {med['busy_ms']:.3f} ms, idle "
              f"{med['idle']:.1%} (medians of {len(rs)} runs)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
