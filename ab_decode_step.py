"""Time the port's Llama-3-8B int8 decode step in one or more checkouts,
in turn, on one card.

    python3 ab_decode_step.py DIR [DIR ...] [--steps N]

Each DIR is the root of a checkout of the repository (it holds
``sdnq_tpu_torch/``).  The runs go in the order given (give A B B A to
compare two checkouts on the same card), each in a process of its own that
imports the port from its DIR and builds there the one kernel the step
runs (B2's GEMV, ``csrc/dequant_gemv.cu``).  A run draws Llama-3-8B at full
width and depth from a seeded generator, quantizes it to int8 (quantized
matmul; the decode step takes the weight-only GEMV at 4 rows) as
``chip_smoke.py`` does, and takes the decode step of ``chip_smoke.py``'s
phase 6 (4 requests, 1 token each at position 896 of an int8 KV cache of
1024 slots): 5 warm steps, then ``--steps`` steps timed one by one on the
host clock with the card synchronised before and after; then one step
traced by torch.profiler (device ms of the GEMV's kernels and of all
kernels), and the GEMV wrapper's host time a call at the step's four
shapes (median of 200 calls, not synchronised).  Prints one JSON line a
run, then the card's name and power limit and one line that sums up each
DIR.  Needs a CUDA card; the cache starts at zeros (no prefill), which
changes no shape the step runs.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BATCH, POS, SLOTS = 4, 896, 1024


def child(root: str, steps: int) -> dict:
    sys.path.insert(0, root)
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import sdnq_tpu_torch
    from sdnq_tpu_torch import QuantConfig, quantize_model
    from sdnq_tpu_torch.kernels import _build
    from sdnq_tpu_torch.kernels import dequant_mm as kd
    from sdnq_tpu_torch.models import (LLAMA3_8B_CONFIG, init_cache,
                                       init_llm, llm_forward)
    from sdnq_tpu_torch.models.llm import init_llm_layer

    assert Path(sdnq_tpu_torch.__file__).resolve().is_relative_to(
        Path(root).resolve()), sdnq_tpu_torch.__file__
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build_s = _build.build(("dequant_gemv",))["dequant_gemv"]
    cfg = dataclasses.replace(LLAMA3_8B_CONFIG, kv_cache_dtype="int8")
    qc = QuantConfig(weights_dtype="int8", use_quantized_matmul=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    params = init_llm(dataclasses.replace(cfg, num_layers=0), generator=gen,
                      device=dev, dtype=torch.bfloat16)
    for _ in range(cfg.num_layers):
        layer = init_llm_layer(cfg, generator=gen, device=dev,
                               dtype=torch.bfloat16)
        q, _ = quantize_model({"layers": [layer]}, qc,
                              arch="LlamaForCausalLM", device=dev)
        params["layers"].append(q["layers"][0])
        del layer, q
    params, _ = quantize_model(params, qc, arch="LlamaForCausalLM",
                               device=dev)
    ids = torch.randint(0, cfg.vocab_size, (BATCH, 1), device=dev,
                        generator=gen)
    caches = [c[:-1] + (POS,) for c in init_cache(cfg, BATCH, SLOTS,
                                                  device=dev)]
    positions = torch.full((BATCH, 1), POS, device=dev)

    @torch.no_grad()
    def step():
        return llm_forward(params, ids, cfg, caches=caches, device=dev,
                           positions=positions)[0]

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    gemv = [e for e in kern if "dequant_gemv" in e.name]

    g = torch.Generator(device=dev).manual_seed(5)
    host = {}
    for k, o in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)):
        x = torch.randn(BATCH, k, device=dev, generator=g).bfloat16()
        codes = torch.randint(-127, 128, (o, k), device=dev, generator=g,
                              dtype=torch.int8)
        scale = torch.rand(o, 1, device=dev, generator=g) * 1e-2

        def call():
            return kd.dequant_gemv(x, codes, scale, out_dtype=torch.bfloat16)
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        per = []
        for _ in range(200):
            t1 = time.perf_counter()
            call()
            per.append((time.perf_counter() - t1) * 1e3)
            torch.cuda.synchronize()
        host[f"{k}->{o}"] = statistics.median(per)
    return {"root": root, "build_s": build_s, "setup_s": setup_s,
            "step_ms": times, "step_ms_median": statistics.median(times),
            "traced_device_ms": sum(e.time_range.elapsed_us()
                                    for e in kern) / 1e3,
            "gemv_device_ms": sum(e.time_range.elapsed_us()
                                  for e in gemv) / 1e3,
            "gemv_launches": len(gemv), "gemv_host_ms": host}


def main() -> int:
    args = sys.argv[1:]
    steps = 20
    if "--steps" in args:
        i = args.index("--steps")
        steps = int(args[i + 1])
        del args[i:i + 2]
    if args[:1] == ["--child"]:
        print(json.dumps(child(args[1], steps)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ab_decode_step.py: no CUDA device", file=sys.stderr)
        return 2
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in args:
        if not (Path(root) / "sdnq_tpu_torch").is_dir():
            print(f"ab_decode_step.py: no sdnq_tpu_torch/ in {root}",
                  file=sys.stderr)
            return 2
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(Path(root).resolve()),
             "--steps", str(steps)], capture_output=True, text=True,
            timeout=900)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    summary = {}
    for r in runs:
        s = summary.setdefault(r["root"], {"step_ms": [], "gemv_device_ms": [],
                                           "gemv_host_ms": []})
        s["step_ms"] += r["step_ms"]
        s["gemv_device_ms"].append(r["gemv_device_ms"])
        s["gemv_host_ms"].append(r["gemv_host_ms"])
    print(json.dumps({root: {"step_ms_median": statistics.median(s["step_ms"]),
                             "step_ms_min": min(s["step_ms"]),
                             "step_ms_max": max(s["step_ms"]),
                             "gemv_device_ms": s["gemv_device_ms"],
                             "gemv_host_ms": s["gemv_host_ms"]}
                      for root, s in summary.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
