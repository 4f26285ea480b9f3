"""A/B two or more builds of the bf16 layer GEMMs (``csrc/layer_fused.cu``)
in one run on the card.

Each variant is a directory holding a ``layer_fused.cu`` and the headers it
includes (a ``csrc/`` of some tree: the working tree's, a parent commit's
unpacked with ``git archive`` under ``build/``, a patched copy). All of
them build at once, with ``kernels.NVCC_FLAGS``, into their own libraries
under ``build/gemm_ab/``, load side by side through ctypes, and are:

* held against the plain twins (``ops.layer_fused.gemm_bias_plain`` /
  ``gemm_res_ln_plain``) at small and ragged shapes, dropout sites and
  ``pre_out`` included: at most 4 bf16 ulps, two runs bit-identical;
* compared with the first variant bit for bit (``--same``);
* timed at the GEMM shapes of the paper batch-32 forward, in the order
  A B ... B A (CUDA events; the best of the two), beside bf16
  ``torch.matmul`` of the same product and the bound.

Run from the root of a checkout on the card::

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python -m nylon_amt_tpu_torch.tools.gemm_ab \\
        new=nylon_amt_tpu_torch/csrc old=build/parent/nylon_amt_tpu_torch/csrc

It prints the card's name and power limit first. A variant that fails to
build or to check is reported and left out of the timings.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
import time
from pathlib import Path

ENTRIES = ("nylon_gemm_bias", "nylon_gemm_bias_drop", "nylon_gemm_res_ln",
           "nylon_gemm_res_ln_train")
ULPS = 4

# (kernel, M, K, N, ReLU, dropout, pre_out, out): one tile, ragged K, M and
# N, several tiles a block at every tile width, the training variants
CHECKS = [
    ("bias", 128, 64, 64, 0, 0, 0, 1), ("bias", 200, 96, 288, 0, 0, 0, 1),
    ("bias", 777, 160, 160, 1, 0, 0, 1), ("bias", 333, 32, 8, 1, 0, 0, 1),
    ("bias", 5000, 256, 512, 1, 1, 0, 1), ("bias", 300000, 64, 192, 0, 0, 0, 1),
    ("bias", 300000, 64, 64, 1, 0, 0, 1), ("bias", 300001, 96, 288, 0, 0, 0, 1),
    ("bias", 300000, 256, 768, 0, 0, 0, 1), ("bias", 300000, 64, 128, 0, 1, 0, 1),
    ("ln", 128, 64, 64, 0, 0, 0, 1), ("ln", 333, 32, 8, 0, 0, 0, 1),
    ("ln", 777, 160, 96, 0, 0, 0, 1), ("ln", 300000, 512, 256, 0, 0, 0, 1),
    ("ln", 300001, 160, 96, 0, 0, 0, 1), ("ln", 300000, 64, 64, 0, 0, 0, 1),
    ("ln", 5000, 256, 256, 0, 1, 0, 1), ("ln", 5000, 256, 256, 0, 1, 1, 1),
    ("ln", 5000, 512, 256, 0, 1, 1, 0), ("ln", 777, 96, 96, 0, 0, 1, 1),
]
# (label, M, K, N, ReLU, launches per batch-32 forward) of the paper model
PAPER = [
    ("bias qkv freq", 1048576, 256, 768, 0, 3),
    ("bias ffn1 freq", 1048576, 256, 512, 1, 3),
    ("bias kv cross", 1048576, 256, 512, 0, 3),
    ("bias q cross", 360448, 256, 256, 0, 3),
    ("bias qkv note/time", 360448, 256, 768, 0, 5),
    ("bias ffn1 note/time", 360448, 256, 512, 1, 6),
    ("ln o freq", 1048576, 256, 256, 0, 3),
    ("ln ffn2 freq", 1048576, 512, 256, 0, 3),
    ("ln o note/time", 360448, 256, 256, 0, 8),
    ("ln ffn2 note/time", 360448, 512, 256, 0, 6),
]
HBM_BPS, BF16_FLOPS = 3.35e12, 989e12  # H100 SXM, published


def build(variants: dict, out_dir: Path) -> dict:
    """``{name: library path or None}``: every variant's layer_fused.cu,
    each in its own nvcc, all started together."""
    from nylon_amt_tpu_torch import kernels

    nvcc = kernels.find_nvcc()
    if nvcc is None:
        raise SystemExit("gemm_ab: no nvcc")
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        lib = out_dir / f"{name}.so"
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(lib),
               str(Path(src) / "layer_fused.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        (out_dir / f"{name}.log").write_text(log)
        libs[name] = lib if proc.returncode == 0 else None
        if proc.returncode:
            print(f"{name}: build failed (exit {proc.returncode}); "
                  f"{out_dir / name}.log:\n{log[-3000:]}", flush=True)
    return libs


class Lib:
    """One variant's library: the four GEMM entry points on tensors."""

    def __init__(self, path: Path):
        from nylon_amt_tpu_torch import kernels

        self.lib = ctypes.CDLL(str(path))
        for e in ENTRIES:
            getattr(self.lib, e).argtypes = kernels._SIGNATURES[e]
            getattr(self.lib, e).restype = ctypes.c_int
        self.lib.nylon_error_string.argtypes = [ctypes.c_int]
        self.lib.nylon_error_string.restype = ctypes.c_char_p

    def _call(self, name, *args):
        status = getattr(self.lib, name)(*args)
        if status:
            msg = self.lib.nylon_error_string(status).decode()
            raise RuntimeError(f"{name}: CUDA error {status} ({msg})")

    def bias(self, a, w, b, relu=0, site=None):
        import torch

        (m, k), n = a.shape, w.shape[1]
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
        s = torch.cuda.current_stream().cuda_stream
        args = (a.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), m,
                n, k, relu)
        if site is None:
            self._call("nylon_gemm_bias", *args, s)
        else:
            self._call("nylon_gemm_bias_drop", *args, *site, s)
        return [out]

    def res_ln(self, a, w, b, res, g, be, site=None, pre=0, out=1):
        import torch

        from nylon_amt_tpu_torch.ops.layer_fused_train import _NO_SITE

        (m, k), n = a.shape, w.shape[1]
        s = torch.cuda.current_stream().cuda_stream
        y = torch.empty((m, n), dtype=a.dtype, device=a.device) if out \
            else None
        p = torch.empty((m, n), dtype=a.dtype, device=a.device) if pre \
            else None
        ptrs = (a.data_ptr(), w.data_ptr(), b.data_ptr(), res.data_ptr(),
                g.data_ptr(), be.data_ptr())
        if site is None and not pre:
            self._call("nylon_gemm_res_ln", *ptrs, y.data_ptr(), m, n, k,
                       1e-5, s)
        else:
            self._call("nylon_gemm_res_ln_train", *ptrs,
                       None if y is None else y.data_ptr(),
                       None if p is None else p.data_ptr(), m, n, k, 1e-5,
                       int(site is not None), *(site or _NO_SITE), s)
        return [t for t in (y, p) if t is not None]


def inputs(m, k, n, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    return dict(a=r(m, k).bfloat16(), w=(r(k, n) / math.sqrt(k)).bfloat16(),
                b=(0.1 * r(n)).bfloat16(), res=r(m, n).bfloat16(),
                g=1.0 + 0.1 * r(n), be=0.1 * r(n))


def _run(lib: Lib, case, x, site):
    kind, relu, pre, out = case[0], case[4], case[6], case[7]
    if kind == "bias":
        return lib.bias(x["a"], x["w"], x["b"], relu, site)
    return lib.res_ln(x["a"], x["w"], x["b"], x["res"], x["g"], x["be"],
                      site, pre, out)


def check(libs: dict) -> dict:
    """Hold every variant against the plain twins at CHECKS; returns
    ``{name: passed}``. With two or more, also reports whether each
    variant's outputs equal the first one's bit for bit."""
    import torch

    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops.layer_fused_train import _site

    ok = {name: True for name in libs}
    differ = {name: 0 for name in libs}
    for case in CHECKS:
        kind, m, k, n, relu, drop, pre, out = case
        x = inputs(m, k, n, seed=m + k + n)
        site = _site(77, 3, n, 0.1, torch.bfloat16) if drop else None
        if kind == "bias":
            want = [lf.gemm_bias_plain(x["a"], x["w"], x["b"], relu, site)]
        else:
            y, p = lf.gemm_res_ln_plain(x["a"], x["w"], x["b"], x["res"],
                                        x["g"], x["be"], site)
            want = ([y] if out else []) + ([p] if pre else [])
        first = None
        for name, lib in libs.items():
            try:
                got, again = _run(lib, case, x, site), _run(lib, case, x, site)
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"check {name} {case}: {e}", flush=True)
                ok[name] = False
                continue
            worst = 0.0
            for g_, a_, w_ in zip(got, again, want):
                top = w_.float().abs().max().item()
                ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
                worst = max(worst, (g_.float() - w_.float()).abs().max()
                            .item() / ulp)
                ok[name] &= torch.equal(g_.view(torch.int16),
                                        a_.view(torch.int16))
            ok[name] &= worst <= ULPS
            if first is None:
                first = got
            elif not all(torch.equal(a_.view(torch.int16),
                                     b_.view(torch.int16))
                         for a_, b_ in zip(got, first)):
                differ[name] += 1
            print(f"check {name} {case}: {worst:.2f} ulps from the plain "
                  f"twin", flush=True)
    for name in libs:
        print(f"check {name}: {'passed' if ok[name] else 'FAILED'}"
              + (f"; {differ[name]} of {len(CHECKS)} cases differ from the "
                 f"first variant's bits" if name != next(iter(libs)) else ""),
              flush=True)
    return ok


def cuda_ms(fn, iters=10, warmup=2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timing(libs: dict) -> None:
    """Each variant at PAPER, in the order A B .. B A, beside bf16
    torch.matmul of the same product (and + F.layer_norm for the LayerNorm
    GEMM) and the bound; and the totals of one forward."""
    import torch
    import torch.nn.functional as F

    names = list(libs)
    total = dict.fromkeys(names + ["bound", "matmul"], 0.0)
    for label, m, k, n, relu, count in PAPER:
        x = inputs(m, k, n)
        case = ("ln" if label.startswith("ln") else "bias", m, k, n, relu, 0,
                0, 1)
        ms = {}
        for name in names + names[::-1]:
            ms.setdefault(name, []).append(
                cuda_ms(lambda: _run(libs[name], case, x, None)))
        mm = cuda_ms(lambda: x["a"] @ x["w"])
        lib = f"matmul {mm:.3f}"
        ln = case[0] == "ln"
        if ln:
            g16, b16 = x["g"].bfloat16(), x["be"].bfloat16()
            lib += ", matmul + layer_norm " + format(cuda_ms(
                lambda: F.layer_norm(x["a"] @ x["w"] + x["b"] + x["res"],
                                     (n,), g16, b16, 1e-5)), ".3f")
        nbytes = 2 * (m * k + k * n + m * n) + (2 * m * n if ln else 0)
        bound = max(nbytes / HBM_BPS, 2 * m * k * n / BF16_FLOPS) * 1e3
        print(f"time {label} [{m},{k},{n}] x{count}: " + "; ".join(
            f"{name} {min(t):.3f} ms ({bound / min(t):.1%} of the bound)"
            for name, t in ms.items())
              + f"; {lib} ms; bound {bound:.3f} ms", flush=True)
        for name, t in ms.items():
            total[name] += count * min(t)
        total["bound"] += count * bound
        total["matmul"] += count * mm
        del x
        torch.cuda.empty_cache()
    print("time of one forward's 43 GEMMs (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in total.items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="+", metavar="NAME=CSRC_DIR")
    ap.add_argument("--out", default="build/gemm_ab")
    ap.add_argument("--no-time", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gemm_ab: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    variants = dict(v.split("=", 1) for v in args.variants)
    t0 = time.perf_counter()
    built = build(variants, Path(args.out))
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    libs = {name: Lib(path) for name, path in built.items() if path}
    ok = check(libs)
    good = {name: lib for name, lib in libs.items() if ok[name]}
    if good and not args.no_time:
        timing(good)
    return 0 if len(good) == len(variants) else 1


if __name__ == "__main__":
    sys.exit(main())
