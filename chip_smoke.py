#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure ends the run with a non-zero exit and no result line):

1. device   - needs CUDA; prints the card's name and power limit as
              ``nvidia-smi --query-gpu=name,power.limit`` gives them.
2. build    - compiles every kernel under sdnq_tpu_torch/csrc with nvcc
              (one process per source, all at once) into the package's
              ignored _build/ directory.
3. kernels  - calls each kernel's wrapper at the shapes of the FLUX.1-dev
              paths, holds it against its plain PyTorch version on the
              same inputs, times kernel, plain version and a one-call
              PyTorch yardstick with CUDA events, and computes the bound
              (bytes over 3.35 TB/s or operations over the H100's peak for
              their type, the larger).  Prints one {"kernels": [...]} line
              for the kernels of the paths.
4. int8     - FLUX.1-dev at full width and depth (19 double + 38 single
              blocks) with random int8 weights from a seeded generator:
              2 requests of 4 flow-matching Euler steps at 1024x1024 (4096
              image tokens), 512 text tokens, guidance 3.5.  Launch counts
              are zeroed just before and read just after; every kernel of
              the path must have launched.
4b. uint4   - the same model quantized to uint4 + SVD rank 32 (the
              published 4-bit recipe) on the weight-only route: 2 requests
              x 4 steps; B5, B6 and attention must launch.
4c. uint4 q - the same stored tensors on the quantized-matmul route
              (``use_quantized_matmul`` set on each QTensor's meta): 1
              request x 2 steps; B7, B6 and the requantize fallback (B1 +
              B4, for the 96- and 120-group layers) must launch.
5. slice    - each model cut to 1 double + 2 single blocks, one forward at
              1024x1024 with 512 text tokens through the kernels against
              the all-plain path, both on the card (the check swaps each
              wrapper for its plain version for the reference run and
              verifies no kernel launched in it): int8, uint4 weight-only
              and uint4 quantized matmul, each with its own limit.
6. profile  - one Euler step of the full int8 model and one of the uint4
              weight-only model traced with torch.profiler: device time by
              kernel group, idle share.
7. faults   - broken copies of the kernel sources (FAULTS: a skipped KV
              tile, a missing rescale, a dropped K stage, a short warp
              reduction, round-half-away, the other nibble decoded, a
              neighbouring group's scale, the other field's bits kept),
              built with the real ones; phases 3 and 5 rerun with each in
              turn.  Phase 3 must fail for the broken kernel; phase 5's
              reading is printed beside its limit.

The last line is {"ok": true, "device": {...}}.  Numbers are this card's,
at the power limit printed beside them.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and operations/s
HBM_BPS = 3.35e12
PEAK = {"int8": 1979e12, "fp8": 1979e12, "bf16": 989e12, "fp32": 67e12}

FAILURES: list[str] = []


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str):
    log(("ok   " if ok else "FAIL ") + what)
    if not ok:
        FAILURES.append(what)


def bound_ms(bytes_moved: float, ops: float = 0.0, kind: str = "bf16"):
    t_bytes = bytes_moved / HBM_BPS
    t_ops = ops / PEAK[kind] if ops else 0.0
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the main path's shapes
# ---------------------------------------------------------------------------

def kernel_phase(torch, dev, timed: bool = True):
    """Each kernel against its plain version; with ``timed`` False only the
    comparison runs (the times are None)."""
    import torch.nn.functional as F
    from sdnq_tpu_torch.kernels import attention as ka
    from sdnq_tpu_torch.kernels import dequant_mm as kd
    from sdnq_tpu_torch.kernels import scaled_mm as ks
    from sdnq_tpu_torch.packing import pack_codes_halfsplit
    from sdnq_tpu_torch.quant.core import quantize_int_mm

    g = torch.Generator(device=dev).manual_seed(1234)
    rows = []

    def t(fn, reps: int = 10):
        return time_ms(fn, reps=reps) if timed else None

    def record(name, route, source, replaces, err, tol, ms, plain_ms,
               bnd, library_ms, shape, on_path=True, path="int8"):
        check(err <= tol,
              f"{name} {shape}: max_abs_err {err:.3e} <= {tol:.3e}")
        rows.append(dict(name=name, route=route, source=source,
                         replaces=replaces, launches=0, max_abs_err=err,
                         tolerance=tol, ms=ms, plain_ms=plain_ms,
                         bound_ms=bnd[0], bound_by=bnd[1],
                         library_ms=library_ms, shape=shape,
                         on_main_path=on_path, path=path))

    m = 4608
    # B1, quantize half: fp32 rows into qkv / linear1 / fc1 (K 3072) and
    # bf16 rows into linear2 (K 15360)
    for k, dt in ((3072, torch.float32), (15360, torch.bfloat16)):
        x = torch.randn(m, k, device=dev, generator=g).to(dt)
        got = ks.quantize_rows(x)
        want = ks.quantize_rows_plain(x)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got[:2], want[:2]))
        record("quantize_rows", "cuda", "sdnq_tpu_torch/csrc/quantize_rows.cu",
               "sdnq_tpu/kernels/scaled_mm.py:230", err, 0.0,
               t(lambda: ks.quantize_rows(x)),
               t(lambda: ks.quantize_rows_plain(x), reps=3),
               bound_ms(m * k * (x.element_size() + 1) + m * 4,
                        3 * m * k, "fp32"),
               None, f"M{m} K{k} {str(dt)[6:]}")

    # B4 / B1 GEMM half: int8 x int8 -> int32, epilogue, bf16 out
    for k, n in ((3072, 9216), (3072, 21504), (15360, 3072)):
        a = torch.randint(-128, 128, (m, k), device=dev, generator=g,
                          dtype=torch.int8)
        b = torch.randint(-128, 128, (n, k), device=dev, generator=g,
                          dtype=torch.int8)
        xs = torch.rand(m, 1, device=dev, generator=g) * 0.02 + 1e-3
        ws = torch.rand(n, device=dev, generator=g) * 2e-4 + 1e-5
        bias = torch.randn(n, device=dev, generator=g)
        got = ks.scaled_gemm(a, b, torch.bfloat16, xs, ws, bias)
        want = ks.scaled_gemm_plain(a, b, torch.bfloat16, xs, ws, bias)
        err = float((got.float() - want.float()).abs().max())

        def library():
            acc = torch._int_mm(a, b.t())
            return ((acc.float() * xs) * ws + bias).to(torch.bfloat16)
        record("scaled_gemm", "cuda", "sdnq_tpu_torch/csrc/scaled_mm.cu",
               "sdnq_tpu/kernels/scaled_mm.py:57", err,
               # bit-exact expected; one bf16 ulp (at most 2^-7 relative)
               # of the largest output
               float(want.float().abs().max()) * 2 ** -7,
               t(lambda: ks.scaled_gemm(a, b, torch.bfloat16, xs, ws,
                                        bias)),
               t(lambda: ks.scaled_gemm_plain(a, b, torch.bfloat16, xs,
                                              ws, bias), reps=3),
               bound_ms(m * k + n * k + m * n * 2 + (m + 2 * n) * 4,
                        2 * m * n * k, "int8"),
               t(library), f"M{m} K{k} N{n} int8")
        del a, b

    # B4 bf16 flavour (the 16-bit family; not on this main path)
    a = torch.randn(m, 3072, device=dev, generator=g).bfloat16()
    b = torch.randn(3072, 3072, device=dev, generator=g).bfloat16()
    got = ks.scaled_gemm(a, b, torch.float32)
    want = ks.scaled_gemm_plain(a, b, torch.float32)
    tol = float(1e-4 * (a.float().abs() @ b.float().abs().T).max())
    record("scaled_gemm", "cuda", "sdnq_tpu_torch/csrc/scaled_mm.cu",
           "sdnq_tpu/kernels/scaled_mm.py:57",
           float((got - want).abs().max()), tol,
           t(lambda: ks.scaled_gemm(a, b, torch.float32)),
           t(lambda: ks.scaled_gemm_plain(a, b, torch.float32), reps=3),
           bound_ms(2 * (m * 3072 + 3072 * 3072) + m * 3072 * 4,
                    2 * m * 3072 * 3072, "bf16"),
           t(lambda: F.linear(a, b).float()), f"M{m} K3072 N3072 bf16",
           on_path=False)
    del a, b

    # B1/B4 fp8 e4m3 mode (fp8 weights; not on this main path)
    k, n = 3072, 9216
    x = torch.randn(m, k, device=dev, generator=g).bfloat16()
    got = ks.quantize_rows(x, "float8_e4m3fn")
    want = ks.quantize_rows_plain(x, "float8_e4m3fn")
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got[:2], want[:2]))
    record("quantize_rows", "cuda", "sdnq_tpu_torch/csrc/quantize_rows.cu",
           "sdnq_tpu/kernels/scaled_mm.py:230", err, 0.0,
           t(lambda: ks.quantize_rows(x, "float8_e4m3fn")),
           t(lambda: ks.quantize_rows_plain(x, "float8_e4m3fn"), reps=3),
           bound_ms(m * k * 3 + m * 4, 3 * m * k, "fp32"), None,
           f"M{m} K{k} bfloat16 fp8", on_path=False)
    a = got[0]
    b = (torch.randn(n, k, device=dev, generator=g) * 50).to(
        torch.float8_e4m3fn)
    xs, ws = got[1], torch.rand(n, device=dev, generator=g) * 1e-3
    got = ks.scaled_gemm(a, b, torch.bfloat16, xs, ws)
    want = ks.scaled_gemm_plain(a, b, torch.bfloat16, xs, ws)
    tol = float(1e-5 * ((a.float().abs() @ b.float().abs().T) * xs
                        * ws).max() + want.float().abs().max() * 2 ** -7)
    record("scaled_gemm", "cuda", "sdnq_tpu_torch/csrc/scaled_mm.cu",
           "sdnq_tpu/kernels/scaled_mm.py:57",
           float((got.float() - want.float()).abs().max()), tol,
           t(lambda: ks.scaled_gemm(a, b, torch.bfloat16, xs, ws)),
           t(lambda: ks.scaled_gemm_plain(a, b, torch.bfloat16, xs, ws),
             reps=3),
           bound_ms(m * k + n * k + m * n * 2 + (m + n) * 4, 2 * m * n * k,
                    "fp8"),
           t(lambda: torch._scaled_mm(
               a, b.t(), scale_a=xs, scale_b=ws[None, :],
               out_dtype=torch.bfloat16)),
           f"M{m} K{k} N{n} fp8", on_path=False)
    del a, b, x

    # B2: M = 1 modulation GEMV, fp32 rows, int8 codes, bf16 out
    k, o = 3072, 18432
    x = torch.randn(1, k, device=dev, generator=g)
    w = torch.randint(-128, 128, (o, k), device=dev, generator=g,
                      dtype=torch.int8)
    s = torch.rand(o, device=dev, generator=g) * 1e-3
    bias = torch.randn(o, device=dev, generator=g)
    got = kd.dequant_gemv(x, w, s, None, bias, torch.bfloat16)
    want = kd.dequant_gemv_plain(x, w, s, None, bias, torch.bfloat16)
    tol = float(1e-4 * ((x.abs() @ w.float().abs().T) * s).max()
                + want.float().abs().max() * 2 ** -7)
    w_deq = (w.float() * s[:, None]).bfloat16()
    xb = x.bfloat16()
    record("dequant_gemv", "cuda", "sdnq_tpu_torch/csrc/dequant_gemv.cu",
           "sdnq_tpu/kernels/dequant_mm.py:60",
           float((got.float() - want.float()).abs().max()), tol,
           t(lambda: kd.dequant_gemv(x, w, s, None, bias,
                                    torch.bfloat16), reps=20),
           t(lambda: kd.dequant_gemv_plain(x, w, s, None, bias,
                                          torch.bfloat16), reps=5),
           bound_ms(o * k + k * 4 + o * 2 + 2 * o * 4, 2 * o * k, "fp32"),
           t(lambda: F.linear(xb, w_deq, bias.bfloat16()), reps=20),
           f"M1 K{k} O{o} int8")
    del w, w_deq

    # B3: joint attention, 24 heads, 4608 tokens, head dim 128.  Kernel and
    # plain version round P to bf16 against a running and the final row max
    # respectively; the bf16 outputs then differ by about one ulp.  The
    # limit is two ulps of the largest output (2^-6 of it): with 4608 keys
    # the outputs are small (about 0.1), so a limit tied to |v| would pass
    # a kernel that dropped a whole KV tile.
    def attn_tol(want):
        return 2 ** -6 * float(want.float().abs().max())

    bh, n, d = 24, 4608, 128
    q = torch.randn(bh, n, d, device=dev, generator=g)
    kk = torch.randn(bh, n, d, device=dev, generator=g)
    v = torch.randn(bh, n, d, device=dev, generator=g).bfloat16()
    sm = d ** -0.5
    qb = (q * (sm * ka.LOG2E)).bfloat16()
    kb = kk.bfloat16()
    flops = 4 * bh * n * n * d
    sdpa = (lambda: F.scaled_dot_product_attention(
        q.bfloat16()[None], kb[None], v[None], scale=sm))
    got = ka.flash_attention(qb, kb, v)
    want = ka.flash_attention_plain(qb, kb, v)
    record("flash_attention", "cuda", "sdnq_tpu_torch/csrc/flash_attn.cu",
           "sdnq_tpu/kernels/attention.py:67",
           float((got.float() - want.float()).abs().max()), attn_tol(want),
           t(lambda: ka.flash_attention(qb, kb, v)),
           t(lambda: ka.flash_attention_plain(qb, kb, v), reps=3),
           bound_ms(4 * bh * n * d * 2, flops, "bf16"), t(sdpa),
           f"BH{bh} N{n} D{d} bf16")
    # int8-QK mode (the "auto" policy takes it at d <= 64; not on this path)
    qq, qs = quantize_int_mm(q)
    kq, kss = quantize_int_mm(kk)
    qs = (qs[..., 0] * sm) * ka.LOG2E
    kss = kss[..., 0]
    got = ka.flash_attention(qq, kq, v, qs, kss)
    want = ka.flash_attention_plain(qq, kq, v, qs, kss)
    record("flash_attention", "cuda", "sdnq_tpu_torch/csrc/flash_attn.cu",
           "sdnq_tpu/kernels/attention.py:67",
           float((got.float() - want.float()).abs().max()), attn_tol(want),
           t(lambda: ka.flash_attention(qq, kq, v, qs, kss)),
           t(lambda: ka.flash_attention_plain(qq, kq, v, qs, kss),
             reps=3),
           # Q.K^T at the int8 rate, P.V at the bf16 rate: in bf16 terms
           # 1/4 + 1/2 of the bf16 mode's operations
           bound_ms(bh * n * d * (1 + 1 + 2 + 2) + 2 * bh * n * 4,
                    0.75 * flops, "bf16"), t(sdpa),
           f"BH{bh} N{n} D{d} int8-QK", on_path=False)
    del q, kk, v, qb, kb, qq, kq

    # B5 / B6 / B7 on uint4 half-split codes, group 128 (the uint4 + SVD
    # recipe), with a zero point about 8 steps below the codes.  The plain
    # versions round only the inputs and the output, as the kernels do:
    # B7 sums exact integers and folds in the same fp32 order (bit-equal
    # expected), B5 and B6 sum fp32 in another order.  The limit is one
    # bf16 ulp of the largest output (2^-7 of it) for all three.
    def ulp_tol(want):
        return float(want.float().abs().max()) * 2 ** -7

    def uint4_weight(n, k, gsize=128):
        codes = torch.randint(0, 16, (n, k), device=dev, generator=g,
                              dtype=torch.int32)
        scale = torch.rand(n, k // gsize, device=dev, generator=g) * 2e-3 \
            + 1e-3
        zpc = -8 * scale * (1 + 0.1 * torch.randn(
            n, k // gsize, device=dev, generator=g))
        w_deq = (codes.float().reshape(n, k // gsize, gsize) * scale[..., None]
                 + zpc[..., None]).reshape(n, k).bfloat16()
        return pack_codes_halfsplit(codes, 4), scale, zpc, w_deq

    def halfsplit_bytes(n, k, gsize=128):
        return n * k // 2 + 2 * n * (k // gsize) * 4 + n * 4

    for m, k, n in ((4608, 3072, 21504), (4608, 15360, 3072),
                    (512, 3072, 9216)):
        packed, scale, zpc, w_deq = uint4_weight(n, k)
        x = torch.randn(m, k, device=dev, generator=g).bfloat16()
        bias = torch.randn(n, device=dev, generator=g)
        args = (x, packed, scale, zpc, bias, 4, torch.bfloat16)
        got = kd.groupdot_mm(*args)
        want = kd.groupdot_mm_plain(*args)
        record("groupdot_mm", "cuda", "sdnq_tpu_torch/csrc/groupdot_mm.cu",
               "sdnq_tpu/kernels/dequant_mm.py:355",
               float((got.float() - want.float()).abs().max()),
               ulp_tol(want), t(lambda: kd.groupdot_mm(*args)),
               t(lambda: kd.groupdot_mm_plain(*args), reps=3),
               bound_ms(m * k * 2 + halfsplit_bytes(n, k) + m * n * 2,
                        2 * m * n * k, "bf16"),
               t(lambda: F.linear(x, w_deq, bias.bfloat16())),
               f"M{m} K{k} N{n} uint4 g128", path="uint4_wo")
        del packed, w_deq, x

    for k, n in ((3072, 18432), (256, 3072)):
        packed, scale, zpc, w_deq = uint4_weight(n, k)
        x = torch.randn(1, k, device=dev, generator=g)
        bias = torch.randn(n, device=dev, generator=g)
        args = (x, packed, scale, zpc, bias, 4, torch.bfloat16)
        got = kd.blockdiag_mm(*args)
        want = kd.blockdiag_mm_plain(*args)
        xb = x.bfloat16()
        record("blockdiag_mm", "cuda", "sdnq_tpu_torch/csrc/blockdiag_mm.cu",
               "sdnq_tpu/kernels/dequant_mm.py:593",
               float((got.float() - want.float()).abs().max()),
               ulp_tol(want), t(lambda: kd.blockdiag_mm(*args), reps=20),
               t(lambda: kd.blockdiag_mm_plain(*args), reps=5),
               bound_ms(halfsplit_bytes(n, k) + k * 4 + n * 2, 2 * n * k,
                        "fp32"),
               t(lambda: F.linear(xb, w_deq, bias.bfloat16()), reps=20),
               f"M1 K{k} N{n} uint4 g128", path="uint4_wo")
        del packed, w_deq

    for m, k, n in ((4608, 3072, 21504), (4096, 3072, 9216)):
        packed, scale, zpc, w_deq = uint4_weight(n, k)
        xq = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                           dtype=torch.int8)
        xs = torch.rand(m, 1, device=dev, generator=g) * 0.02 + 1e-3
        bias = torch.randn(n, device=dev, generator=g)
        args = (xq, xs, packed, scale, zpc, bias, 4, torch.bfloat16)
        got = kd.groupdot_i8_mm(*args)
        want = kd.groupdot_i8_mm_plain(*args)
        xb = (xq.float() * xs).bfloat16()
        record("groupdot_i8_mm", "cuda", "sdnq_tpu_torch/csrc/groupdot_mm.cu",
               "sdnq_tpu/kernels/dequant_mm.py:741",
               float((got.float() - want.float()).abs().max()),
               ulp_tol(want), t(lambda: kd.groupdot_i8_mm(*args)),
               t(lambda: kd.groupdot_i8_mm_plain(*args), reps=3),
               bound_ms(m * k + halfsplit_bytes(n, k) + m * 4 + m * n * 2,
                        2 * m * n * k, "int8"),
               t(lambda: F.linear(xb, w_deq, bias.bfloat16())),
               f"M{m} K{k} N{n} uint4 g128", path="uint4_qmm")
        del packed, w_deq, xq, xb
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5
# ---------------------------------------------------------------------------

def build_model(torch, dev, qconfig, label):
    """FLUX.1-dev at full width and depth, bf16 weights from a seeded
    generator on the card, quantized layer by layer with ``qconfig``; the
    bf16 model is freed afterwards."""
    from sdnq_tpu_torch import quantize_model
    from sdnq_tpu_torch.models import FLUX_DEV_CONFIG
    from sdnq_tpu_torch.models.dit import init_dit

    t0 = time.perf_counter()
    params = init_dit(FLUX_DEV_CONFIG, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    qparams, _ = quantize_model(
        params, qconfig, arch="FluxTransformer2DModel", device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"{label}: FLUX.1-dev weights built in {t1 - t0:.1f} s, quantized "
        f"in {time.perf_counter() - t1:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return qparams


def denoise_path(torch, dev, qparams, label, requests, steps, required):
    """``flux_denoise`` at 1024x1024, 512 text tokens, guidance 3.5:
    ``requests`` requests of ``steps`` steps with the launch counts zeroed
    just before and read just after; every kernel in ``required`` must
    have launched.  Returns the counts."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models import FLUX_DEV_CONFIG
    from sdnq_tpu_torch.pipeline import flux_denoise

    cfg = FLUX_DEV_CONFIG
    g = torch.Generator(device=dev).manual_seed(7)
    txt_len, side = 512, 1024
    txt = torch.randn(1, txt_len, cfg.txt_dim, device=dev, generator=g)
    pooled = torch.randn(1, cfg.vec_dim, device=dev, generator=g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    outs, times = [], []
    for r in range(requests):
        gen = torch.Generator(device=dev).manual_seed(100 + r)
        t1 = time.perf_counter()
        lat = flux_denoise(qparams, txt, pooled, cfg, steps=steps,
                           height=side, width=side, guidance=3.5,
                           generator=gen, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        outs.append(lat)
    counts = launch_counts()
    n_img = (side // 16) ** 2
    forwards = requests * steps
    log(f"{label}: {requests} requests x {steps} steps, {n_img} image + "
        f"{txt_len} text tokens, depth {cfg.depth_double}+{cfg.depth_single}")
    for r, t in enumerate(times):
        log(f"{label}: request {r}: {t:.3f} s, {t / steps * 1e3:.1f} ms/step, "
            f"{n_img * steps / t:.0f} image tokens/s")
    log(f"{label}: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{label}: launches " + json.dumps(counts) + " per forward "
        + json.dumps({k: v / forwards for k, v in counts.items()}))
    for name in required:
        check(counts[name] > 0, f"{label} path launched {name}")
    for lat in outs:
        check(tuple(lat.shape) == (1, n_img, cfg.in_channels)
              and bool(torch.isfinite(lat).all()),
              f"{label} output {tuple(lat.shape)} finite")
    if requests > 1:
        check(not torch.equal(outs[0], outs[1]),
              f"{label}: requests differ by their noise")
    return counts


def with_quantized_matmul(qparams):
    """The same stored tensors with ``meta.use_quantized_matmul`` set where
    the quantizer's policy allows it: quantize_tensor stores identical
    tensors under both settings (tests/test_torch_formats_quant.py)."""
    import dataclasses
    from sdnq_tpu_torch import QTensor
    from sdnq_tpu_torch.policy import quantized_matmul_allowed

    def conv(x):
        if isinstance(x, QTensor):
            use = quantized_matmul_allowed(True, *x.meta.original_shape[:2])
            return dataclasses.replace(x, meta=dataclasses.replace(
                x.meta, use_quantized_matmul=use))
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x
    return conv(qparams)


@contextlib.contextmanager
def plain_versions():
    """Route the model through the kernels' plain versions, on the card.

    Every wrapper launches its kernel on a CUDA tensor, so the reference
    run of phase 5 swaps each wrapper for its plain version where the
    model's modules look it up, and restores them afterwards."""
    from sdnq_tpu_torch.kernels import attention as ka
    from sdnq_tpu_torch.kernels import dequant_mm as kd
    from sdnq_tpu_torch.kernels import scaled_mm as ks
    swaps = [(ks, "quantize_rows", ks.quantize_rows_plain),
             (ks, "scaled_gemm", ks.scaled_gemm_plain),
             (kd, "dequant_gemv", kd.dequant_gemv_plain),
             (kd, "groupdot_mm", kd.groupdot_mm_plain),
             (kd, "blockdiag_mm", kd.blockdiag_mm_plain),
             (kd, "groupdot_i8_mm", kd.groupdot_i8_mm_plain),
             (ka, "flash_attention", ka.flash_attention_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def dit_inputs(torch, dev, cfg, side: int = 1024, txt_len: int = 512,
               seed: int = 11):
    """One denoise step's inputs at 1024x1024 (4096 image tokens) with 512
    text tokens, t = 0.7, guidance 3.5, from a seeded generator."""
    from sdnq_tpu_torch.models.dit import make_rope_freqs
    g = torch.Generator(device=dev).manual_seed(seed)
    hw = (side // 16, side // 16)
    return dict(
        img=torch.randn(1, hw[0] * hw[1], cfg.in_channels, device=dev,
                        generator=g),
        txt=torch.randn(1, txt_len, cfg.txt_dim, device=dev, generator=g),
        pooled=torch.randn(1, cfg.vec_dim, device=dev, generator=g),
        t=torch.full((1,), 0.7, device=dev),
        guidance=torch.full((1,), 3.5, device=dev),
        freqs=make_rope_freqs(cfg, txt_len, hw, device=dev))


def forward(params, cfg, inp, dev):
    from sdnq_tpu_torch.models.dit import dit_forward
    return dit_forward(params, inp["img"], inp["txt"], inp["t"],
                       inp["pooled"], cfg, guidance=inp["guidance"],
                       freqs=inp["freqs"], device=dev)


# Limits of the slice check, each about twice its sound reading on the
# H100.  int8: 9.0e-3 and 1.03e-2; bf16 rounding differences flip int8
# activation codes, and the flips compound over the blocks.  uint4
# weight-only: 2.9e-3, bf16 rounding alone (no activation codes).  uint4
# with the quantized matmul: 1.08e-2, int8 activation codes again.
SLICE_TOL = {"int8": 2e-2, "uint4_wo": 6e-3, "uint4_qmm": 2.2e-2}


def cut(qparams):
    """1 double + 2 single blocks of a model, and the matching config."""
    import dataclasses
    from sdnq_tpu_torch.models import FLUX_DEV_CONFIG
    cfg = dataclasses.replace(FLUX_DEV_CONFIG, depth_double=1,
                              depth_single=2)
    return dict(qparams,
                transformer_blocks=qparams["transformer_blocks"][:1],
                single_transformer_blocks=qparams[
                    "single_transformer_blocks"][:2]), cfg


def slice_phase(torch, dev, sliced, label) -> float:
    """Kernel path against the all-plain path, both on the card, on a model
    cut by ``cut``; returns the largest error over the largest output."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts

    params, cfg = sliced
    inp = dit_inputs(torch, dev, cfg)
    out = forward(params, cfg, inp, dev).float()
    reset_launch_counts()
    with plain_versions():
        ref = forward(params, cfg, inp, dev).float()
    launched = launch_counts()
    check(not any(launched.values()),
          f"slice {label}: the plain path launched no kernel "
          + json.dumps(launched))
    rel = float((out - ref).abs().max() / ref.abs().max())
    tol = SLICE_TOL[label]
    log(f"slice {label}: 1 double + 2 single blocks at full width, "
        f"{inp['img'].shape[1]} image + {inp['txt'].shape[1]} text tokens, "
        "kernels against plain versions")
    check(rel <= tol and bool(torch.isfinite(out).all()),
          f"slice {label}: kernel path vs plain path rel err {rel:.3e} <= "
          f"{tol:.1e}")
    return rel


# ---------------------------------------------------------------------------
# phase 6: where one denoise step spends its device time
# ---------------------------------------------------------------------------

_GROUPS = (
    ("B1 quantize_rows", ("quantize_rows_kernel",)),
    ("B4 scaled_gemm (B1 GEMM half)", ("scaled_mm_kernel",)),
    ("B2 dequant_gemv", ("dequant_gemv_kernel",)),
    ("B3 flash_attention", ("flash_attn_kernel",)),
    ("B5 groupdot_mm", ("groupdot_mm_kernel<0",)),
    ("B6 blockdiag_mm", ("blockdiag_mm_kernel",)),
    ("B7 groupdot_i8_mm", ("groupdot_mm_kernel<1",)),
    ("cuBLAS (unquantized linears, SVD factors)", (
        "gemm", "gemv", "cutlass", "xmma", "nvjet")),
    ("torch elementwise / reductions", ("elementwise", "reduce", "cat",
                                        "Copy", "copy", "index")),
)


def profile_phase(torch, dev, qparams, label):
    """Trace one Euler step of the full model with torch.profiler after
    three untraced ones; print the step's host-clock time, device busy time
    (kernel times summed on the one stream), the idle share and device time
    by kernel group."""
    from collections import defaultdict
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sdnq_tpu_torch.models import FLUX_DEV_CONFIG

    cfg = FLUX_DEV_CONFIG
    inp = dit_inputs(torch, dev, cfg)

    def step():
        return inp["img"] + (-0.25) * forward(qparams, cfg, inp, dev).float()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_group, by_count = defaultdict(float), defaultdict(int)
    by_name = defaultdict(float)
    for e in kernels:
        grp = next((grp for grp, keys in _GROUPS
                    if any(k in e.name for k in keys)), "other")
        ms = e.time_range.elapsed_us() / 1e3
        by_group[grp] += ms
        by_count[grp] += 1
        by_name[e.name[:90]] += ms
    busy_ms = sum(by_group.values())
    untraced = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        untraced.append((time.perf_counter() - t1) * 1e3)
    if not kernels:  # a measurement, not a check: say so and go on
        log(f"profile {label}: the profiler recorded no device kernels; "
            "device time not measured")
        return
    log(f"profile {label}: " + json.dumps({
        "traced_step_ms": wall_ms, "untraced_step_ms": sorted(untraced),
        "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms,
        "kernels_traced": len(kernels),
        "device_ms_by_group": dict(sorted(by_group.items(),
                                          key=lambda kv: -kv[1])),
        "launches_by_group": dict(by_count),
        "top_kernels_ms": [[n, round(ms, 3)] for n, ms in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:12]]}))


# ---------------------------------------------------------------------------
# phase 7: planted bugs that the checks of phases 3 and 5 must see
# ---------------------------------------------------------------------------

# (tag, source, kernel, slice, [(text, broken text)]): each a bug a kernel
# could ship with, and the slice check that runs it.  The broken sources
# are built beside the real ones, swapped in one at a time, and phases 3
# and 5 rerun against them.
FAULTS = (
    ("attn_skips_first_kv_tile", "flash_attn", "flash_attention", "int8",
     [("int kv0 = 0; kv0 < KN", "int kv0 = BKV; kv0 < KN")]),
    ("attn_no_running_max_rescale_of_o", "flash_attn", "flash_attention",
     "int8", [("*= al0;", "*= 1.f;"), ("*= al1;", "*= 1.f;")]),
    ("gemm_drops_last_k_stage", "scaled_mm", "scaled_gemm", "int8",
     [("const int nk = Kb / BKB;", "const int nk = Kb / BKB - 1;")]),
    ("gemv_reduce_one_shuffle_short", "dequant_gemv", "dequant_gemv", "int8",
     [("off > 0; off >>= 1", "off > 1; off >>= 1")]),
    ("quantize_rounds_half_away", "quantize_rows", "quantize_rows", "int8",
     [("rintf(__fdiv_rn(v, scale))", "roundf(__fdiv_rn(v, scale))")]),
    ("groupdot_decodes_the_other_nibble", "groupdot_mm", "groupdot_mm",
     "uint4_wo", [("bfr[ni][0] = dec_bf16x2<BITS>(w0, sh);",
                   "bfr[ni][0] = dec_bf16x2<BITS>(w0, sh ^ 4);")]),
    ("blockdiag_scale_of_the_previous_group", "blockdiag_mm", "blockdiag_mm",
     "uint4_wo", [("const float sc = scale[(size_t)o * G + gi];",
                   "const float sc = scale[(size_t)o * G + (gi + G - 1) % G];"
                   )]),
    ("groupdot_i8_keeps_the_other_field_bits", "groupdot_mm",
     "groupdot_i8_mm", "uint4_qmm",
     [("return (v >> sh) & MASK4;", "return (v >> sh) & 0xffffffffu;")]),
)


def start_fault_builds():
    """Write each broken source into _build/faults/<tag>/ and start its
    nvcc; returns {tag: (process, library path)}."""
    from sdnq_tpu_torch.kernels import _build
    csrc = ROOT / "sdnq_tpu_torch" / "csrc"
    procs = {}
    for tag, src, _, _, edits in FAULTS:
        d = _build.build_dir() / "faults" / tag
        d.mkdir(parents=True, exist_ok=True)
        text = (csrc / f"{src}.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"fault {tag}: {old!r} not in {src}.cu")
            text = text.replace(old, new)
        (d / f"{src}.cu").write_text(text)
        (d / "common.cuh").write_text((csrc / "common.cuh").read_text())
        lib = d / f"lib{src}.so"
        with open(d / "build.log", "w") as out:
            procs[tag] = (subprocess.Popen(
                _build.command(d / f"{src}.cu", lib), stdout=out,
                stderr=subprocess.STDOUT), lib)
    return procs


@contextlib.contextmanager
def library_swapped(name, lib_path):
    """Route the wrappers of csrc/<name>.cu to another build of it."""
    import ctypes
    from sdnq_tpu_torch.kernels import _build
    real = _build.library(name)

    def use(lib):
        _build._libs[name] = lib
        for key in [k for k in _build._fns if k[0] == name]:
            del _build._fns[key]
    use(ctypes.CDLL(str(lib_path)))
    try:
        yield
    finally:
        use(real)


def fault_phase(torch, dev, slices, procs):
    """Rerun phases 3 (untimed) and 5 with each planted fault in place.
    Phase 3 must fail for the broken kernel; phase 5's reading (on the
    slice whose path runs the kernel) is reported beside its limit."""
    for tag, (proc, _) in procs.items():
        if proc.wait() != 0:
            check(False, f"fault {tag}: broken source built")
    if FAILURES:
        return
    results = []
    for tag, src, kernel, label, _ in FAULTS:
        sound = list(FAILURES)
        with library_swapped(src, procs[tag][1]):
            rows = kernel_phase(torch, dev, timed=False)
            rel = slice_phase(torch, dev, slices[label], label)
        FAILURES[:] = sound  # the checks were meant to fail here
        caught = [r for r in rows if r["max_abs_err"] > r["tolerance"]]
        results.append(dict(
            fault=tag, kernel=kernel,
            phase3_failed=[f"{r['name']} {r['shape']}: {r['max_abs_err']:.3e}"
                           f" > {r['tolerance']:.3e}" for r in caught],
            slice=label, slice_rel_err=rel, slice_tol=SLICE_TOL[label],
            slice_caught=rel > SLICE_TOL[label]))
        check(any(r["name"] == kernel for r in caught),
              f"fault {tag}: phase 3 fails {kernel}")
    log("faults: " + json.dumps(results))


def main() -> int:
    if not (ROOT / "sdnq_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(sdnq_tpu_torch/ not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    # the plain versions' fp32 products in full fp32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    log(smi[0] if smi else "nvidia-smi: no output")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from sdnq_tpu_torch import QuantConfig
    from sdnq_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    fault_procs = start_fault_builds()
    try:
        secs = _build.build()
        log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
            + json.dumps({k: round(v, 1) for k, v in secs.items()}))
        rows = kernel_phase(torch, dev)

        counts, slices = {}, {}
        qparams = build_model(
            torch, dev,
            QuantConfig(weights_dtype="int8", use_quantized_matmul=True),
            "int8")
        counts["int8"] = denoise_path(
            torch, dev, qparams, "int8", 2, 4,
            ("quantize_rows", "scaled_gemm", "dequant_gemv",
             "flash_attention"))
        slices["int8"] = cut(qparams)
        slice_phase(torch, dev, slices["int8"], "int8")
        profile_phase(torch, dev, qparams, "int8")
        del qparams
        torch.cuda.empty_cache()

        qparams = build_model(
            torch, dev,
            QuantConfig(weights_dtype="uint4", use_svd=True, svd_rank=32),
            "uint4_wo")
        counts["uint4_wo"] = denoise_path(
            torch, dev, qparams, "uint4_wo", 2, 4,
            ("groupdot_mm", "blockdiag_mm", "flash_attention"))
        qmm = with_quantized_matmul(qparams)
        counts["uint4_qmm"] = denoise_path(
            torch, dev, qmm, "uint4_qmm", 1, 2,
            ("groupdot_i8_mm", "blockdiag_mm", "quantize_rows",
             "scaled_gemm", "flash_attention"))
        slices["uint4_wo"] = cut(qparams)
        slices["uint4_qmm"] = cut(qmm)
        slice_phase(torch, dev, slices["uint4_wo"], "uint4_wo")
        slice_phase(torch, dev, slices["uint4_qmm"], "uint4_qmm")
        profile_phase(torch, dev, qparams, "uint4_wo")
        del qparams, qmm
        torch.cuda.empty_cache()

        for row in rows:
            row["launches"] = (counts[row["path"]][row["name"]]
                               if row["on_main_path"] else 0)
        fault_phase(torch, dev, slices, fault_procs)
    finally:  # no compiler outlives the script
        for proc, _ in fault_procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    path = [r for r in rows if r["on_main_path"]]
    for r in rows:
        if not r["on_main_path"]:
            log("off-path kernel mode: " + json.dumps(r))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": path}))
    if FAILURES:
        print("chip_smoke.py: failed: " + "; ".join(FAILURES),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
