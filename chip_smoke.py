#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --no-faults  # no phase 7, nor its builds
    python3 chip_smoke.py --b1-probes  # only B1's quantizer and B4 nn's plans, timed
    python3 chip_smoke.py --phase-4i   # only phase 4i (model files), and
                                       # the builds its paths need
    python3 chip_smoke.py --phase-4u   # only phase 4u (the SD UNet, with
                                       # its slice and trace), and the
                                       # builds its paths need
    python3 chip_smoke.py --phases-4m-4b-4o  # only phases 4m, 4b, 4o and
                                             # 4u's fp16 recipe, with their
                                             # phase 3 rows
    python3 chip_smoke.py --phases-4n-4t     # only phases 4n and 4t, with
                                             # their phase 3 rows and slices
    python3 chip_smoke.py --phases-4l-4t     # only phase 4l (int8 sums past
                                             # 2^17) with its phase 3 rows,
                                             # and phase 4t's training cases

``--no-faults`` starts no builds of planted faults, so that the timed
phases have the host's cores to themselves (the default run builds them
at the lowest priority while phases 3 to 6 run); it skips phase 7 and
checks all else.

Phases (any failure ends the run with a non-zero exit and no result line):

1. device   - needs CUDA; prints the card's name and power limit as
              ``nvidia-smi --query-gpu=name,power.limit`` gives them.
2. build    - compiles every kernel under sdnq_tpu_torch/csrc with nvcc
              (one process per source, all at once) into the package's
              ignored _build/ directory.
3. kernels  - calls each kernel's wrapper at the shapes of the FLUX.1-dev,
              Llama-3-8B, training and text-to-image paths (and B8 at the
              decode shapes of its domain), holds it against its plain
              PyTorch version on the
              same inputs, times kernel, plain version and a one-call
              PyTorch yardstick with CUDA events, and computes the bound
              (bytes over 3.35 TB/s or operations over the H100's peak for
              their type, the larger).  Among them: B2's bit-plane tiles
              and GEMV, B5 / B6 on multi-plane and minifloat half-split
              codes, B1 + B4 on a layer of a stacked weight, bench.py's
              shape (qlinear, int8 rowwise, M 16384 K 4096 N 8192, beside
              bf16 F.linear); B9 (the ring's block step) at the block
              shapes of phase 4r, its acc / l per row, m and l held
              against the plain version; B7 on uint4 at the uint4 q
              path's shapes and on uint5 g256 (three field planes), and
              the bit-plane GEMV at M 1 and 32; B6 at M 8 (uint4,
              float5_e2m2fn) and B10 with the uint8 family's rank-2 term in
              its epilogue (limit TN_LOWRANK_TOL); and the two halves of B2's
              tiles, B5 and B7 alone at DiT linear1: decode_weight (int8
              g1024, float8_e3m4fn bit-plane, float5_e2m2fn half-split,
              uint4 half-split into int8; bit-equal) and wgmma_mm with its
              bias, row, fold and int8 fold epilogues, and once at ragged
              M, N and K; B4 (TMA + wgmma) at a ragged shape with every
              epilogue term (int8 and e4m3), its int8 rows beside
              torch._int_mm alone and with the epilogue; B4's nn layout
              (B1's grad-input) at every grad-input shape of the training
              step (NN_SHAPES: linear1, linear2, img qkv / fc1 / fc2,
              txt qkv, M 1 at 18432 and 9216 -> 3072; bit-equal, beside
              torch._int_mm alone on operands laid out beforehand and
              with the weight's transposed copy), at a ragged shape with
              every epilogue term and in e4m3 (off the paths); B10 beside
              torch._int_mm / torch._scaled_mm alone and with the
              transposed copies and scales; B6 and B2's GEMV also with
              their weight cold (called on copies that exceed the L2 cache
              four times over, in turn), beside F.linear so timed, B2's
              GEMV also at the Llama-3-8B decode step's shapes (M 4: 4096
              -> 4096, 1024, 14336; 14336 -> 4096); each token-mode row
              (int8 P.V) beside the bf16-P.V kernel at its shape (events
              and device ms), and token mode also causal (off the paths);
              B8 on uint5 (two field planes); B3 at the UNet's
              self-attention shapes (5 x 4096^2, 10 x 4096^2, 20 x
              1024^2, D 64): the modes its paths run, head-mode int8 P.V
              (int8 and e4m3 Q.K) and e4m3 Q.K alone and with token-mode
              P.V, head mode also at FLUX's 24 x 4608^2, D 128, beside
              SDPA and the bf16-P.V kernel; B9 with e4m3 Q.K at FLUX's
              P = 1 block; phases 4m-4o's modes (``mbo_rows``):
              B3 at head dim 100 (OpenLLaMA-3B-v2's prefill and causal
              shapes, padded to 128), 160, 256 and v's head dim other than
              q's, through ``quantized_attention`` against the plain
              version on the unpadded operands; B9 at D 256; B2's e5m2
              GEMV and tiles at phase 4b's shapes; fp16 x on B2's bit-plane
              GEMV and tiles, its grouped tiles and B5 at SD1.5's.  Then
              B7 against B8 at 32, 64 and 128 rows on four shapes: dequant_mm.I8_BLOCKDIAG_MAX_ROWS must equal
              the largest row count at which B8 is the faster on all.
              Prints one {"kernels": [...]} line for the kernels of the
              paths.
4r. ring    - sequence parallelism at the attention widths of two
              models, q, k, v from a seeded generator: FLUX.1-dev's joint
              attention at 1024x1024, (1, 24, 4608, 128), in three modes
              (int8 Q.K with token-mode int8 P.V, the ring's default; int8
              with bf16 P.V; bf16): ``ring_attention`` through
              create_mesh(sequence=1) on the card (one B9 launch), the
              ring's body for P = 2, 4 and 8 ranks in one process (B9;
              at P = 8 the 576-key blocks take the XLA block function, as
              in JAX), and ``ulysses_attention`` at P = 1 (B3);
              Llama-3-8B's causal prefill, (1, 32, 8192, 128) with the 8
              KV heads repeated, at P = 1 (an 8192^2 mask) and P = 4
              (zigzag).  Each ring against float64 attention, against
              ``quantized_attention`` in the same mode, and virtual P
              against P = 1; B9 launches per ring call; ring P = 1 timed
              beside B3, and traced (int8 with token-mode P.V, and bf16)
              as phase 6 traces.
4. int8     - FLUX.1-dev at full width and depth (19 double + 38 single
              blocks) with random int8 weights from a seeded generator:
              2 requests of 4 flow-matching Euler steps at 1024x1024 (4096
              image tokens), 512 text tokens, guidance 3.5.  Launch counts
              are zeroed just before and read just after; every kernel of
              the path must have launched.
4s. stacked - that model stacked with ``stack_dit_blocks`` as the driver's
              entry runs it (the lists freed): 1 request x 4 steps on the
              stack and on the lists rebuilt as views of its storage; both
              outputs bit-equal to the list model's; every layer view
              contiguous at its offset.
4p. pipeline- ``pipeline_forward`` through create_mesh(fsdp=1) over the
              stack's 37 uniform single-stream blocks, 2 microbatches of
              (1, 4608, 3072): bit-equal to the stacked model's loop.
4w. uint4   - FLUX.1-dev cut to 4 + 8 blocks (FLUX_CUT_DEPTH), quantized
              to uint4 + SVD rank 32 (the
              published 4-bit recipe) on the weight-only route: 2 requests
              x 4 steps; B5, B6 and attention must launch.
4q. uint4 q - the same stored tensors on the quantized-matmul route
              (``use_quantized_matmul`` set on each QTensor's meta): 1
              request x 2 steps; B7 (its int8 decode and int8-fold GEMM),
              B6 and the requantize fallback (B1 + B4, for the 96- and
              120-group layers) must launch.
4g. dynamic - SDNQ's dynamic per-layer format selection on FLUX.1-dev at
              full width cut to 4 + 8 blocks, each 2-D weight redrawn
              with a tail
              from the cycle Gaussian, Student-t 5, 3, 2 (DYN_LAWS): R1
              QuantConfig(weights_dtype="int8", use_dynamic_quantization)
              2 x 4 steps (B2 grouped and bit-plane, tiles and GEMV); R2
              the uint4 + SVD r32 recipe with the ladder, 1 x 4 steps (B5 /
              B6 on uint4 and on multi-plane or minifloat codes).  Format
              histogram, quantize seconds, GiB, step times, launches.
4d. llm     - meta-llama/Meta-Llama-3-8B at full width and depth with
              random int8 weights (quantized matmul), quantized layer by
              layer: ``generate`` with the int8 KV cache (2 requests) and
              the bf16 KV cache (1 request), each 4 prompts of 896 tokens
              and 128 new tokens (a 1024-slot cache, so prefill takes B3),
              and one cache-free causal ``llm_forward`` of 2 x 1024 tokens.
              Prefill and decode times, tokens/s, peak memory and launches
              per prefill and per decode step; B1, B2, B4 and the new B3
              modes (masked, GQA, int8 P.V, causal) must launch.  Then one
              uint4 g64 layer through ``qlinear`` at 32 rows: B8 launches.
4e. train   - FLUX.1-dev training at full width, depth cut to 3 double +
              6 single blocks (memory and the run's time),
              random bf16 weights quantized to int8 (quantized matmul) under
              the Flux skip keys, ``convert_model_to_training``, AdamW with
              8-bit moments, stochastic rounding and Kahan; batch 1 at
              512x512 (1024 image tokens), 512 text tokens, guidance 3.5,
              loss mean((out - target)^2).  One warm-up and three timed
              steps: forward / backward / optimizer ms (CUDA events), image
              tokens/s, peak GiB, launches, loss (finite) and the share of
              weight codes the update moved (above 0) per step; B10, B1's
              nn and colscale modes, B1, B4, B2 and B3 must launch in each;
              then one step traced.
4f. t2i     - FLUX text to image under SDNQ's default recipe
              (QuantConfig(weights_dtype="int8"): weight-only, groups of
              1024): T5-XXL (24 layers) and CLIP-L (12) quantized, the
              FLUX.1-dev DiT (19 + 38 blocks) quantized under the Flux skip
              keys, the FLUX VAE in bf16, random weights from seeded
              generators; 2 requests of 512 T5 and 77 CLIP token ids,
              ``t5_encode``, ``clip_encode``, ``flux_generate`` at
              1024x1024 with 4 Euler steps and guidance 3.5.  T5, CLIP,
              per-step and VAE times, seconds per image, image tokens/s,
              peak memory and launches per stage; B2's tile kernel
              (grouped and row modes), its grouped GEMV, B3 with the
              additive mask and B3 bf16 must launch; the images finite,
              (1, 1024, 1024, 3).
4u. unet    - the SD UNet at full width and depth, random weights from
              seeded generators, through ``sd_generate`` (DDIM,
              classifier-free guidance 7.5, 77 text tokens, the SD VAE):
              SD1.5 int8 weight-only with quantized convolutions at
              512x512, 2 requests x 4 steps (B2 tiles and GEMV, B3 int8
              Q.K at 4096 tokens); SDXL int8 with the quantized matmul on
              the linears and the im2col convolutions at 1024x1024,
              added conditions of 2816, 1 x 4 (B1 + B4, B2's GEMV, B3
              int8 Q.K and bf16); the SD1.5 model with fp8 e4m3 Q.K and
              head-mode int8 P.V, 1 x 2 (the cross-attention on head
              mode's XLA branch).  Seconds per image split into the UNet
              steps and the VAE, peak memory, launches per UNet forward
              by kernel and mode, the XLA attention's calls a forward;
              then one SDXL DDIM step traced (phase 6) and the UNet slice
              (phase 5).
4m. moe     - Mixtral-8x7B's expert FFN (``MoEConfig()``: hidden 4096,
              ff 14336, 8 experts, top-2, capacity factor 1.25) with
              random weights, ``moe_ffn`` on 4 x 1024 bf16 tokens (1280
              rows an expert) with the int8 banks on the quantized matmul
              (B1 + B4 on each expert's layer view: 24 launches of B4 a
              call) and weight-only (dequantized, B4's bf16 mode): ms a
              call, the dropped share, the aux loss, each against its
              all-plain path; one call traced.
4b. batch   - ``ContinuousBatcher`` over FLUX.1-dev (19 + 38 blocks)
              with every linear stored as native float8_e5m2,
              weight-only: 4 slots, 6 requests of 2, 3 and 4 FlowMatch
              steps at 1024x1024 with 512 text tokens, each with its own
              seed and schedule (the step function gathers each slot's
              timestep); efficiency, iterations, slot-steps a second;
              every request against itself run alone through
              ``flux_denoise`` at batch 1; one 4-slot step traced; the
              model's 1 + 2-block slice.
4o. llm100  - a Llama at OpenLLaMA-3B-v2's widths (hidden 3200, 32
              heads of 100, ff 8640, 26 layers, vocab 32000), int8 with the
              quantized matmul: ``generate`` of 4 x 896 + 128 tokens with
              the int8 KV cache (B3 at head dim 100, padded to 128, token
              mode; the decode steps at N = 1 on the XLA route) and the
              causal forward of 2 x 1024 tokens; a prefill and a decode
              step traced; the 2-layer slice.
4u16.       - phase 4u's fp16 recipe: SD1.5 at fp16 activations and
              parameters, its 2-D weights with tails, quantized by the
              dynamic R1 ladder from int8 (dequant dtype fp16): 1 request
              x 2 DDIM steps at 512x512 (B2's bit-plane and grouped tiles
              at fp16 x; the time embedding's GEMV rows at fp32 x), the
              format histogram, and the SD1.5 slice at fp16.
4n. muon    - phase 4e's training model under ``muon(
              use_quantized_matmul_ns=True)`` (8-bit state, SR, Kahan):
              one warm-up and two timed steps, forward / backward /
              optimizer ms, the NS calls' ms, 15 B4 launches a NS leaf, peak
              GiB, the loss and the codes moved; phase 3 holds the NS of a
              leaf at linear1's width (classic, Gram-NS, adaptive) on B4
              bit-equal to NS on B4's plain version, and B4 at its three
              shapes beside ``torch._int_mm``; phase 5 one Muon step of the
              2 + 2-block training slice against the all-plain path.
4t. parallel- on phase 4's int8 FLUX.1-dev (19 + 38 blocks, 1024x1024;
              built again after the fault builds, whose load the
              host-bound virtual ranks would share):
              an NCCL process group of one, the ``shard_params(...,
              DIT_TP_RULES)`` forward through create_mesh(tensor=1)
              bit-equal to ``dit_forward``, ``dryrun_multichip(1)`` on
              it, ``local_tp`` at virtual T = 2
              and 4 against the unsharded forward (launches of B1, B1's
              given-scale mode, B4, B3, B2 a forward); phase 4m's banks
              over virtual 2, 4 and 8 expert ranks (``shard_moe``) against
              ``moe_ffn``; one iteration of phase 4b's batcher with its
              slots over create_mesh(data=1), bit-equal to mesh=None; the
              TP x DP training step at virtual T = 2 on the 2 + 2-block
              training slice against the unsharded step (loss, gradients,
              updated codes); after them the training cases where the
              port raised before (TP_TRAIN_CASES: uint8 in groups of 128
              and int8 in groups of 128 at virtual T = 2, their
              row-parallel weights re-quantized against their whole rows
              by B1's given scale or range, the uint8 grad-input by W's
              all-reduced ranges; the uint4 + SVD r32 recipe at T = 2; the
              int8 slice's linears fsdp-sharded at virtual fsdp 2), each
              against the unsharded step (loss, gradients), and the layer
              check (``tp_layer_phase``: FLUX.1-dev's MLP, fc1 column and
              fc2 row parallel, uint8 and int8 in groups of 128, at
              virtual T = 2 against the same layers unsharded: output,
              weight and input gradients, where the whole step's codes
              move at ties); phase 3 holds
              B1's given-scale mode and a 1 + 2-block cut at T = 2;
              phase 5 the cut at T = 2 against its plain path.
4l. long    - int8 contractions of 2^17 rows and more, where an int32 sum
              may wrap (B4 and B10 split each tile into parts summed in
              int64): a trainable int8
              ``qlinear`` at FLUX.1-dev's linear1 width (3072 -> 21504)
              with the quantized matmul, forward and backward over a
              batch-32 step's 147,456 tokens (B1, B4 nt, B1 colscale + B4
              nn, B10 long), its output and grad-input rows and its whole
              grad-weight bit-equal to the plain versions on the card,
              peak GiB; one Muon step with the quantized NS on a 152,064
              x 3584 leaf (Qwen2.5-7B's embedding widths), bit-equal to
              the plain NS, 5 long B4 Grams.  Phase 3 holds B10 over
              147,456 tokens, B4 nt at that Gram and just under 2^17, B4 nn at a
              152,064-row head's grad-input, bit-equal where lines of
              extreme codes make sums past 2^31, beside
              ``torch._int_mm``.
4i. files   - model files, written into a temporary directory (free disk
              checked first; removed at the end) and read on the card:
              FLUX.1-dev at full width cut to 2 + 4 blocks (seeded bf16
              weights written in diffusers' FluxTransformer2DModel layout
              over two shards and an index) streamed, fused and quantized
              to int8 by ``load_flux``, bit-equal to ``quantize_model`` of
              the tree in memory, its forward at 1024x1024 with 512 text
              tokens bit-equal (B1, B4, B2's GEMV and B3 must launch), and
              again after ``save_quantized`` / ``load_quantized``; one
              shard through ``fast_load_safetensors`` (the reader's bytes)
              and ``device_put_packed`` (bit-equal), and the int8 tree
              through ``device_put_packed``; Llama-3-8B at full width cut
              to 2 layers in transformers' LlamaForCausalLM layout through
              ``load_llama`` (int8), ``generate`` of 2 x 128 + 8 tokens
              equal and the causal forward's logits bit-equal to the
              in-memory model's (B1, B4, B2's GEMV and B3 causal must
              launch); ``fit`` on a fresh 2 + 2-block training slice
              (int8, AdamW with 8-bit moments and Kahan) for 2 steps with
              a checkpoint every step: ``restore_checkpoint`` of step_1
              bit-equal to the state after step 1, and a ``fit`` resumed
              from step_1 (the generator set to its state there) bit-equal
              at its end to the uninterrupted run (B10, B1's nn and
              colscale, B1, B4, B2 and B3 must launch).  Each write, load,
              native read and transfer logs its bytes, seconds and GB/s
              beside the card's name and power limit.
5. slice    - each FLUX model (R1 and R2 too) cut to 1 double + 2 single
              blocks, one
              forward at 1024x1024 with 512 text tokens, and Llama-3-8B cut
              to 2 layers (prefill + 4 decode steps with either cache, and
              the causal forward), and the training model cut to 2 double
              + 2 single blocks (loss and every weight gradient of one
              step), and the text-to-image pipeline cut to 2 T5 and 2 CLIP
              layers and 1 + 2 DiT blocks with the whole VAE (2 steps at
              512x512), and the ring at P = 2 on (1, 24, 2304, 128), and
              SD1.5 at full width cut to one resnet a level (one forward
              at 32x32 latents, fp8 Q.K and head-mode P.V; and at fp16
              with R1), the MoE banks on 512 tokens, the e5m2 FLUX model
              and OpenLLaMA's 2 layers,
              through the kernels against the all-plain path, both on the
              card (the check swaps each wrapper for its plain version for
              the reference run and verifies no kernel launched in it),
              each with its own limit.
6. profile  - one Euler step of the full int8, uint4 weight-only, uint4
              quantized-matmul, R1 and R2 FLUX models, one prefill and one
              decode step of the int8-KV Llama-3-8B, one text-to-image
              request and one SDXL DDIM step (two UNet forwards at
              1024x1024), one MoE call of each bank, one 4-slot e5m2 FLUX
              step and an OpenLLaMA prefill and decode step, traced with
              torch.profiler: device time by kernel group, idle share.
7. faults   - broken copies of the kernel sources (FAULTS: a skipped KV
              tile, a missing rescale, B4 dropping its last K stage and
              its N tail, B8 ignoring the second field plane, a short warp
              reduction, round-half-away, the other nibble decoded, a
              neighbouring group's scale (B6 and B8), the other field's
              bits kept, a mask ignored on one tile, the P scale taken per
              64-key tile, the causal skip a tile early, the GQA map
              h % KH, a middle KV tile skipped under a mask and under
              causal, B10 dropping the M tail, B10 with a_s and b_s
              swapped, a byte lane swapped in B10's shared-memory
              transpose, B1's prologue ignoring the column scale, B2 taking
              the next group's scale, B2 dropping the zero point, B3
              ignoring the additive mask on one KV tile, B3 adding it
              without log2(e), B2 reading its bit planes in reverse order,
              B2's minifloat decode flushing subnormals, B5 ignoring the
              second field plane, B6 dropping the minifloat sign and
              reading its minifloat table one entry off, B1 ignoring
              a given row scale, B4's long contraction adding its parts
              in int32 or dropping its last part, B10's parts added in
              int32, B9
              writing acc normalised, m in base-2 units, B3's base-2
              exponent in B9, l not rescaled in token mode, and the GEMM
              waiting on the wrong phase of its stages' barriers, starting
              each of B5's group products one k-step late and dropping the
              N tail, B7's fold taking the next group's xsum, B7's group
              product never restarted after the first group, the bit-plane
              GEMV reading its planes in reverse order and its x one code
              late, B3's TMA + wgmma kernel waiting on the wrong phase of
              its K stages' barriers, taking P.V from the other V stage and
              storing its second consumer warpgroup's rows at the first
              one's, the token kernel reading the next row's mask on one
              tile, leaving its diagonal tile unmasked, and its V^T slots
              in another order, B2's GEMV taking the next group's scale
              and dropping the last K slice of a split row, B1's quantize
              without its division fallback, B4 nn with a byte lane of its
              transpose swapped, the last slice of a split contraction
              dropped, its split counters left set after a call and the M
              tail dropped, B3's head mode without its log2 127 shift,
              and its e4m3 Q.K taking the next key's scale, every D-256
              block writing the first 128 columns, B2's GEMV and decode
              reading e5m2 codes as e4m3, the bit-plane GEMV rounding fp16
              weights through bf16), built with the real ones, and
              Python faults (PY_FAULTS: Muon's quantized product
              quantizing b where bᵀ belongs, the qkv layout shifted by one
              head, the tiles casting fp16 x to bf16, the softmax scale
              taken from the padded head dim, a row-parallel shard's
              input and re-quantized weight rows and a column-parallel
              shard's uint8 grad-input quantized by the shard's own
              statistics) loaded in their modules' place;
              for each in turn phase 3's rows of the kernels built from
              the broken source and phase 5's slice of its path rerun.
              Phase 3 must fail for the broken kernel (the sharding
              layout's fault: phase 5's TP slice; the shard statistics'
              faults: phase 4t's layer check); phase 5's readings are
              printed beside their limits.
``--b1-probes`` builds B1's and B4's sources, times B1's quantizer at
phase 3's shapes and B4's nn layout at NN_SHAPES under every plan of
``scaled_mm.nn_plan`` (device ms), and exits: the readings that plan is
fitted to.

The last line is {"ok": true, "device": {...}}.  Numbers are this card's,
at the power limit printed beside them.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def peaks() -> tuple[float, dict]:
    """The H100 SXM's dense peaks (NVIDIA data sheet), from the port's
    ``utils.profiling``: memory bytes/s and operations/s by operand type."""
    from sdnq_tpu_torch.utils.profiling import CHIPS
    chip = CHIPS["h100"]
    return chip.hbm_gbps * 1e9, {k: chip.peak(k) for k in
                                 ("int8", "fp8", "bf16", "fp32")}


FAILURES: list[str] = []


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str):
    log(("ok   " if ok else "FAIL ") + what)
    if not ok:
        FAILURES.append(what)


def bound_ms(bytes_moved: float, ops: float = 0.0, kind: str = "bf16"):
    return bound_mixed_ms(bytes_moved, (ops, kind))


def bound_mixed_ms(bytes_moved: float, *terms):
    """(the least ms the card could take, "bytes" or "operations"): the
    bytes over the memory rate, or ``terms`` (operations, kind) each at
    its type's peak, summed, whichever is larger."""
    hbm_bps, peak = peaks()
    t_bytes = bytes_moved / hbm_bps
    t_ops = sum(ops / peak[kind] for ops, kind in terms)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def host_ms(fn, reps: int = 20) -> float:
    """Median host time a call takes to return, without synchronising: the
    wrapper's Python, allocations and launches (the card runs behind).  The
    median, since the fault builds share the host's cores meanwhile
    (unless ``--no-faults``)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def burst_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` bursts of the CUDA-event time per call of ``n``
    calls issued back to back.  With calls of a fraction of a millisecond
    the host stays ahead of the card, so this is close to the device time,
    and it needs no profiler."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


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


L2_BYTES = 50 * 2 ** 20   # the H100's L2 cache


def cold_copies(nbytes: int) -> int:
    """How many copies of an operand of ``nbytes`` exceed the L2 cache four
    times over (three at least), so that a call on each in turn reads its
    operand from device memory, as a layer's weight is read on the path."""
    return max(3, -(-4 * L2_BYTES // nbytes))


def cold_ms(torch, calls, symbol):
    """(events ms, device ms) a call, the ``calls`` (each on its own copy of
    the weight, ``cold_copies`` of them) called in turn: CUDA events around
    each call (``time_ms``) and the profiler's kernel time (``device_ms``,
    ``symbol`` as there)."""
    it = itertools.cycle(calls)

    def fn():
        return next(it)()
    return (time_ms(fn, reps=2 * len(calls), warmup=len(calls)),
            device_ms(torch, fn, symbol, reps=2 * len(calls)))


def b6_cold_calls(args):
    """Calls of B6 (``blockdiag_mm(*args)``), each on its own copy of the
    codes, scales and zpc, ``cold_copies`` of them."""
    from sdnq_tpu_torch.kernels import dequant_mm as kd
    x, codes, scale, zpc = args[:4]
    n = cold_copies(codes.numel() + 4 * (scale.numel() + zpc.numel()))
    ops = [(codes, scale, zpc)] + [
        tuple(t.clone() for t in (codes, scale, zpc)) for _ in range(n - 1)]
    return [lambda o=o: kd.blockdiag_mm(x, *o, *args[4:]) for o in ops]


def weight_cold(torch, calls, symbol, x, wb, bias, timed: bool = True):
    """A weight-only kernel (``calls``, each on its own copy of the weight,
    ``symbol`` its kernels' name) and its yardstick ``F.linear`` of bf16 x
    on the bf16 weight ``wb``, each with its weight cold (``cold_ms`` over
    the copies, and over copies of ``wb``): the row's readings, none where
    not ``timed``."""
    import torch.nn.functional as F
    if not timed:
        return {}
    k_ms, k_dev = cold_ms(torch, calls, symbol)
    xb = x.bfloat16()
    bb = None if bias is None else bias.bfloat16()
    ws = [wb] + [wb.clone() for _ in range(cold_copies(2 * wb.numel()) - 1)]
    l_ms, l_dev = cold_ms(torch, [lambda w=w: F.linear(xb, w, bb)
                                  for w in ws], "")
    del ws
    torch.cuda.empty_cache()
    return dict(cold_ms=k_ms, cold_device_ms=k_dev, library_cold_ms=l_ms,
                library_cold_device_ms=l_dev)


def b6_cold(torch, args, wb, timed: bool = True):
    """B6 and ``F.linear`` on ``wb``, each with its weight cold
    (``weight_cold``)."""
    if not timed:
        return {}
    return weight_cold(torch, b6_cold_calls(args),
                       KERNEL_SYMBOLS["blockdiag_mm"], args[0], wb, args[4])


def gemv_cold_calls(args):
    """Calls of B2's GEMV (``dequant_gemv(*args)``), each on its own copy
    of the codes and scales, ``cold_copies`` of them."""
    from sdnq_tpu_torch.kernels import dequant_mm as kd
    x, codes, scale = args[:3]
    n = cold_copies(codes.numel() + 4 * scale.numel())
    ops = [(codes, scale)] + [(codes.clone(), scale.clone())
                              for _ in range(n - 1)]
    return [lambda o=o: kd.dequant_gemv(x, *o, *args[3:]) for o in ops]


def gemv_cold(torch, args, wb, timed: bool = True):
    """B2's GEMV and ``F.linear`` on ``wb``, each with its weight cold
    (``weight_cold``)."""
    if not timed:
        return {}
    return weight_cold(torch, gemv_cold_calls(args),
                       KERNEL_SYMBOLS["dequant_gemv"], args[0], wb, args[4])


# name of each wrapper's CUDA kernel, as the profiler reports it
KERNEL_SYMBOLS = {
    "quantize_rows": "quantize_rows_",
    "scaled_gemm": ("scaled_mm_wgmma_kernel", "scaled_mm_nn_wgmma_kernel"),
    "dequant_gemv": ("dequant_gemv_kernel", "dequant_gemv_mma_kernel"),
    "dequant_mm": ("decode_weight_", "wgmma_mm_kernel"),
    "decode_weight": "decode_weight_", "wgmma_mm": "wgmma_mm_kernel",
    "flash_attention": "flash_attn", "flash_attention_block": "flash_attn",
    "groupdot_mm": ("decode_weight_", "wgmma_mm_kernel"),
    "blockdiag_mm": "blockdiag_mm_kernel",
    "groupdot_i8_mm": ("decode_weight_halfsplit", "wgmma_i8_fold_kernel"),
    "blockdiag_i8_mm": "blockdiag_i8_mm_kernel",
    "scaled_mm_tn": "scaled_mm_tn_wgmma_kernel"}


def device_ms(torch, fn, symbol, reps: int = 5, seen=None):
    """Mean device time per call of the kernels named ``symbol`` (or any of
    a tuple of names; "" names every kernel) that ``fn`` launches, from
    torch.profiler (host work not included).  A reading counts only where
    the trace holds every launch: the names of its kernels, in the order
    they ran, must be one call's sequence ``reps`` times over (with the
    fault builds loading the host, traces have lost events, and the mean
    of what was left read below the bound).  None when three traces give
    no such sequence.  The names timed are added to the set ``seen``,
    where one is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = (symbol,) if isinstance(symbol, str) else symbol
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        timed = sorted((e for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and any(x in e.name for x in names)),
                       key=lambda e: e.time_range.start)
        seq = [e.name for e in timed]
        per = len(seq) // reps
        if seq and seq == seq[:per] * reps:
            break
    else:
        log(f"device_ms {names}: no whole trace in three tries")
        return None
    if seen is not None:
        seen.update(n[:120] for n in seq)
    return sum(e.time_range.elapsed_us() for e in timed) / 1e3 / reps


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the main path's shapes
# ---------------------------------------------------------------------------

def kernel_phase(torch, dev, timed: bool = True, only=None, count=None,
                 mbo_only: bool = False, nt_only: bool = False,
                 long_only: bool = False):
    """Each kernel against its plain version; with ``timed`` False only the
    comparison runs (the times are None).  ``only`` (a set of csrc source
    names) keeps the rows of the kernels built from those sources (the
    fault phase's rerun of one broken source); ``count`` (the fault's
    count key) keeps, of the rows of B3's head mode and e4m3 Q.K, of the
    UNet shapes and of phases 4m-4o's modes, those of that key
    (``t.fresh``).  ``mbo_only`` keeps phases 4m-4o's rows alone
    (``--phases-4m-4b-4o``), ``nt_only`` phases 4n and 4t's
    (``--phases-4n-4t``), ``long_only`` phase 4l's (``--phases-4l-4t``)."""
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

    def runs(*sources):
        """Whether the rows of kernels built from ``sources`` run."""
        return only is None or any(x in only for x in sources)
    t.timed = timed  # for the row functions given ``t``
    t.runs = runs
    # one call of a slow plain version, timed
    t.once = (lambda fn: time_ms(fn, reps=1, warmup=0)) if timed else (
        lambda fn: None)
    # the rows of B3's head mode and e4m3 Q.K and of the UNet's shapes run
    # in the default run, and in the fault phase for faults of their keys
    t.fresh = lambda *keys: count is None or count in keys

    def record(name, route, source, replaces, err, tol, kernel, plain_ms,
               bnd, library_ms, shape, on_path=True, path="int8",
               count=None, reading=None, symbol=None, what=None,
               library_fn=None, **extra):
        """``kernel`` calls the kernel's wrapper: timed with CUDA events
        around the call (``ms``, the wrapper's host work included), by
        the profiler's kernel durations (``device_ms``) and on the host
        clock until the call returns (``host_ms``).  ``reading`` is
        the number held against ``tol`` where it is not ``err`` (the
        largest error of a row over that row's largest output, or ``what``
        it says).  ``library_fn`` (B3 and B9: the SDPA call timed as
        ``library_ms``) is also timed by the profiler, every kernel it
        launches (``library_device_ms``), so that the kernel and SDPA are
        compared device time against device time."""
        if reading is None:
            check(err <= tol,
                  f"{name} {shape}: max_abs_err {err:.3e} <= {tol:.3e}")
        elif what:
            check(reading <= tol, f"{name} {shape}: max_abs_err {err:.3e}; "
                  f"{what} {reading:.3e} <= {tol:.3e}")
        else:
            check(reading <= tol,
                  f"{name} {shape}: max_abs_err {err:.3e}; worst row's "
                  f"error over its largest output {reading:.3e} <= {tol:.3e}")
        ms = t(kernel)
        dev_ms = (device_ms(torch, kernel, symbol or KERNEL_SYMBOLS[name])
                  if timed else None)
        for _ in range(2):
            # a whole trace under the fault builds' load has read below the
            # bound (half the quiet run's reading): trace it again
            if dev_ms is None or dev_ms >= bnd[0]:
                break
            log(f"{name} {shape}: device_ms {dev_ms:.4f} below bound "
                f"{bnd[0]:.4f}, traced again")
            dev_ms = device_ms(torch, kernel,
                               symbol or KERNEL_SYMBOLS[name])
        for key, val in (("device_ms", dev_ms),
                         ("cold_device_ms", extra.get("cold_device_ms"))):
            if val is not None:
                check(val >= bnd[0], f"{name} {shape}: {key} {val:.4f} >= "
                      f"bound {bnd[0]:.4f}")
        h_ms = host_ms(kernel) if timed else None
        lib_dev, lib_names = None, set()
        if timed and library_fn is not None:
            lib_dev = device_ms(torch, library_fn, "", seen=lib_names)
        if timed and dev_ms and name in ("flash_attention",
                                         "flash_attention_block"):
            lib = (f"SDPA device {lib_dev:.4f} ms (events {library_ms:.4f}),"
                   f" {dev_ms / lib_dev:.2f}x SDPA device / device, "
                   f"{ms / library_ms:.2f}x events / events "
                   f"(SDPA's kernels: {sorted(lib_names)})"
                   if lib_dev else "no SDPA")
            log(f"{name} {shape}: device {dev_ms:.4f} ms (events {ms:.4f}), "
                f"{lib}, bound {bnd[0]:.4f} ms, {dev_ms / bnd[0]:.2f}x bound")
        rows.append(dict(name=name, route=route, source=source,
                         replaces=replaces, launches=0, max_abs_err=err,
                         reading=err if reading is None else reading,
                         tolerance=tol, ms=ms, device_ms=dev_ms,
                         host_ms=h_ms,
                         plain_ms=plain_ms,
                         bound_ms=bnd[0], bound_by=bnd[1],
                         library_ms=library_ms,
                         library_device_ms=lib_dev, shape=shape,
                         on_main_path=on_path, path=path,
                         count=count or name, **extra))

    if mbo_only:
        mbo_rows(torch, dev, g, t, record, runs)
        return rows
    if nt_only:
        nt_rows(torch, dev, g, t, record, runs)
        return rows
    if long_only:
        long_rows(torch, dev, g, t, record)
        return rows
    m = 4608
    # B1, quantize half: fp32 rows into qkv / linear1 / fc1 (K 3072) and
    # bf16 rows into linear2 (K 15360)
    if runs("quantize_rows"):
        for k, dt in ((3072, torch.float32), (15360, torch.bfloat16)):
            x = torch.randn(m, k, device=dev, generator=g).to(dt)
            got = ks.quantize_rows(x)
            want = ks.quantize_rows_plain(x)
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got[:2], want[:2]))
            record("quantize_rows", "cuda", "sdnq_tpu_torch/csrc/quantize_rows.cu",
                   "sdnq_tpu/kernels/scaled_mm.py:230", err, 0.0,
                   lambda: ks.quantize_rows(x),
                   t(lambda: ks.quantize_rows_plain(x), reps=3),
                   bound_ms(m * k * (x.element_size() + 1) + m * 4,
                            3 * m * k, "fp32"),
                   None, f"M{m} K{k} {str(dt)[6:]}")

    # B4 / B1 GEMM half: int8 x int8 -> int32, epilogue, bf16 out
    if runs("scaled_mm"):
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

            def int_mm():
                return torch._int_mm(a, b.t())

            def with_epilogue():
                return ((int_mm().float() * xs) * ws + bias).to(torch.bfloat16)
            # the library: torch._int_mm alone (its int32 product), and with
            # the epilogue as four elementwise passes
            record("scaled_gemm", "cuda", "sdnq_tpu_torch/csrc/scaled_mm.cu",
                   "sdnq_tpu/kernels/scaled_mm.py:57", err,
                   # bit-exact expected; one bf16 ulp (at most 2^-7 relative)
                   # of the largest output
                   float(want.float().abs().max()) * 2 ** -7,
                   lambda: ks.scaled_gemm(a, b, torch.bfloat16, xs, ws,
                                            bias),
                   t(lambda: ks.scaled_gemm_plain(a, b, torch.bfloat16, xs,
                                                  ws, bias), reps=3),
                   bound_ms(m * k + n * k + m * n * 2 + (m + 2 * n) * 4,
                            2 * m * n * k, "int8"),
                   t(int_mm), f"M{m} K{k} N{n} int8", library_fn=int_mm,
                   int_mm_epilogue_ms=t(with_epilogue))
            del a, b

    # B4 at a ragged shape (M, N and K off every tile; TMA's zero fill),
    # every epilogue term, int8 (bit-exact) and e4m3; not on a path
    if runs("scaled_mm"):
        m2, k2, n2 = 1000, 3000, 3000
        for kind in ("int8", "fp8"):
            if kind == "int8":
                a, b = (torch.randint(-128, 128, (r, k2), device=dev,
                                      generator=g, dtype=torch.int8)
                        for r in (m2, n2))
            else:
                a, b = ((torch.randn(r, k2, device=dev, generator=g) * 4).to(
                    torch.float8_e4m3fn) for r in (m2, n2))
            xs = torch.rand(m2, 1, device=dev, generator=g) * 0.02 + 1e-3
            ws = torch.rand(n2, device=dev, generator=g) * 0.02 + 1e-3
            bias, vz0, vz1 = (torch.randn(n2, device=dev, generator=g)
                              for _ in range(3))
            rs, zp = (torch.randn(m2, device=dev, generator=g)
                      for _ in range(2))
            args = (a, b, torch.bfloat16, xs, ws, bias, rs, zp, vz0, vz1)
            got = ks.scaled_gemm(*args)
            want = ks.scaled_gemm_plain(*args)
            tol = float(want.float().abs().max()) * 2 ** -7
            if kind == "fp8":
                tol += float(1e-5 * ((a.float().abs() @ b.float().abs().T)
                                     * xs * ws).max())
            record("scaled_gemm", "cuda", "sdnq_tpu_torch/csrc/scaled_mm.cu",
                   "sdnq_tpu/kernels/scaled_mm.py:57",
                   float((got.float() - want.float()).abs().max()), tol,
                   lambda: ks.scaled_gemm(*args),
                   t(lambda: ks.scaled_gemm_plain(*args), reps=3),
                   bound_ms(m2 * k2 + n2 * k2 + m2 * n2 * 2
                            + (3 * m2 + 5 * n2) * 4, 2 * m2 * n2 * k2, kind),
                   None, f"M{m2} K{k2} N{n2} {kind}, every epilogue term",
                   on_path=False)
            del a, b

    # B4 bf16 flavour (the 16-bit family; not on this main path)
    if runs("scaled_mm"):
        a = torch.randn(m, 3072, device=dev, generator=g).bfloat16()
        b = torch.randn(3072, 3072, device=dev, generator=g).bfloat16()
        got = ks.scaled_gemm(a, b, torch.float32)
        want = ks.scaled_gemm_plain(a, b, torch.float32)
        tol = float(1e-4 * (a.float().abs() @ b.float().abs().T).max())
        record("scaled_gemm", "cuda", "sdnq_tpu_torch/csrc/scaled_mm.cu",
               "sdnq_tpu/kernels/scaled_mm.py:57",
               float((got - want).abs().max()), tol,
               lambda: ks.scaled_gemm(a, b, torch.float32),
               t(lambda: ks.scaled_gemm_plain(a, b, torch.float32), reps=3),
               bound_ms(2 * (m * 3072 + 3072 * 3072) + m * 3072 * 4,
                        2 * m * 3072 * 3072, "bf16"),
               t(lambda: F.linear(a, b).float()), f"M{m} K3072 N3072 bf16",
               on_path=False)
        del a, b

    # B1/B4 fp8 e4m3 mode (fp8 weights; not on this main path)
    if runs("quantize_rows", "scaled_mm"):
        k, n = 3072, 9216
        x = torch.randn(m, k, device=dev, generator=g).bfloat16()
        got = ks.quantize_rows(x, "float8_e4m3fn")
        want = ks.quantize_rows_plain(x, "float8_e4m3fn")
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got[:2], want[:2]))
        record("quantize_rows", "cuda", "sdnq_tpu_torch/csrc/quantize_rows.cu",
               "sdnq_tpu/kernels/scaled_mm.py:230", err, 0.0,
               lambda: ks.quantize_rows(x, "float8_e4m3fn"),
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
               lambda: ks.scaled_gemm(a, b, torch.bfloat16, xs, ws),
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
    if runs("dequant_gemv"):
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
               lambda: kd.dequant_gemv(x, w, s, None, bias,
                                        torch.bfloat16),
               t(lambda: kd.dequant_gemv_plain(x, w, s, None, bias,
                                              torch.bfloat16), reps=5),
               bound_ms(o * k + k * 4 + o * 2 + 2 * o * 4, 2 * o * k, "fp32"),
               t(lambda: F.linear(xb, w_deq, bias.bfloat16()), reps=20),
               f"M1 K{k} O{o} int8",
               library_fn=lambda: F.linear(xb, w_deq, bias.bfloat16()),
               **gemv_cold(torch, (x, w, s, None, bias, torch.bfloat16), w_deq,
                           t.timed))
        del w, w_deq
    # B2's GEMV at the Llama-3-8B decode step's shapes: M 4 (the requests),
    # int8 rowwise codes, bf16 x and out; q / o, k / v (1024 rows: K split
    # over the warps of a row), gate / up and down.  Also with the weight
    # cold: a step reads 6.98 GB of codes, which never sit in the L2.
    if runs("dequant_gemv"):
        for k, o, what in ((4096, 4096, "q / o"), (4096, 1024, "k / v"),
                           (4096, 14336, "gate / up"), (14336, 4096, "down")):
            x = torch.randn(4, k, device=dev, generator=g).bfloat16()
            w = torch.randint(-128, 128, (o, k), device=dev, generator=g,
                              dtype=torch.int8)
            s = torch.rand(o, device=dev, generator=g) * 1e-3
            args = (x, w, s, None, None, torch.bfloat16)
            got = kd.dequant_gemv(*args)
            want = kd.dequant_gemv_plain(*args)
            tol = float(1e-4 * ((x.float().abs() @ w.float().abs().T) * s).max()
                        + want.float().abs().max() * 2 ** -7)
            w_deq = (w.float() * s[:, None]).bfloat16()
            record("dequant_gemv", "cuda", "sdnq_tpu_torch/csrc/dequant_gemv.cu",
                   "sdnq_tpu/kernels/dequant_mm.py:60",
                   float((got.float() - want.float()).abs().max()), tol,
                   lambda: kd.dequant_gemv(*args),
                   t(lambda: kd.dequant_gemv_plain(*args), reps=5),
                   bound_ms(o * k + 4 * k * 2 + o * 4 + 4 * o * 2, 8 * o * k,
                            "fp32"),
                   t(lambda: F.linear(x, w_deq), reps=20),
                   f"M4 K{k} O{o} int8 rowwise bf16 (Llama decode {what})",
                   path="llm_int8kv", library_fn=lambda: F.linear(x, w_deq),
                   **gemv_cold(torch, args, w_deq, t.timed))
            del w, w_deq, got, want

    # B3: joint attention, 24 heads, 4608 tokens, head dim 128.  Kernel and
    # plain version round P to bf16 against a running and the final row max
    # respectively; the bf16 outputs then differ by about one ulp.  The
    # limit is two ulps of the largest output (2^-6 of it): with 4608 keys
    # the outputs are small (about 0.1), so a limit tied to |v| would pass
    # a kernel that dropped a whole KV tile.
    if runs("flash_attn", "flash_attn_e4m3"):
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
        q16 = q.bfloat16()[None]
        sdpa = (lambda: F.scaled_dot_product_attention(
            q16, kb[None], v[None], scale=sm))
        got = ka.flash_attention(qb, kb, v)
        want = ka.flash_attention_plain(qb, kb, v)
        record("flash_attention", "cuda", "sdnq_tpu_torch/csrc/flash_attn.cuh",
               "sdnq_tpu/kernels/attention.py:67",
               float((got.float() - want.float()).abs().max()), attn_tol(want),
               lambda: ka.flash_attention(qb, kb, v),
               t(lambda: ka.flash_attention_plain(qb, kb, v), reps=3),
               bound_ms(4 * bh * n * d * 2, flops, "bf16"), t(sdpa),
               f"BH{bh} N{n} D{d} bf16", library_fn=sdpa)
        # int8-QK mode (the "auto" policy takes it at d <= 64; not on this path)
        qq, qs = quantize_int_mm(q)
        kq, kss = quantize_int_mm(kk)
        qs = (qs[..., 0] * sm) * ka.LOG2E
        kss = kss[..., 0]
        got = ka.flash_attention(qq, kq, v, qs, kss)
        want = ka.flash_attention_plain(qq, kq, v, qs, kss)
        record("flash_attention", "cuda", "sdnq_tpu_torch/csrc/flash_attn.cuh",
               "sdnq_tpu/kernels/attention.py:67",
               float((got.float() - want.float()).abs().max()), attn_tol(want),
               lambda: ka.flash_attention(qq, kq, v, qs, kss),
               t(lambda: ka.flash_attention_plain(qq, kq, v, qs, kss),
                 reps=3),
               # Q.K^T at the int8 rate, P.V at the bf16 rate: in bf16 terms
               # 1/4 + 1/2 of the bf16 mode's operations
               bound_ms(bh * n * d * (1 + 1 + 2 + 2) + 2 * bh * n * 4,
                        0.75 * flops, "bf16"), t(sdpa),
               f"BH{bh} N{n} D{d} int8-QK", on_path=False, library_fn=sdpa)
        del q, kk, v, qb, kb, qq, kq, q16

    # B3 serving modes at Llama-3-8B's shapes: 4 requests x 32 heads over 8
    # KV heads (GQA), head dim 128.  Prefill: 896 prompt tokens into a
    # 1024-slot cache under the model's mask key_pos <= q_pos; the cache-
    # free forward: causal over 2 x 1024 tokens.  Checked in fp32, each
    # row against its own largest output: under these masks query 0 attends
    # key 0 alone and its output (about max |v|) is some 40 times that of a
    # row over a thousand keys, so a limit on the largest output overall
    # would pass a kernel that misweighted the later rows.  Token-mode P·V
    # quantizes P at the same points in the kernel and the plain version (a
    # P block of 512 keys, two per row), so they agree to fp32 rounding:
    # 2^-10 of the row's largest output; the bf16 modes round P to bf16
    # against other maxima: 2^-6 of it.
    if runs("flash_attn", "flash_attn_e4m3"):
        llm_attention_rows(torch, dev, g, t, record)
        unet_attention_rows(torch, dev, g, t, record)
    # B10 and B1's nn / colscale modes at the training step's shapes
    train_kernel_rows(torch, dev, g, t, record)
    # B4 nt / nn and B10 over int8 contractions of 2^17 rows and more
    long_rows(torch, dev, g, t, record)
    # B2's grouped and row modes and B3's additive mask at the shapes of
    # the text-to-image pipeline
    pipeline_kernel_rows(torch, dev, g, t, record)
    # B2's bit-plane mode and B5 / B6's general mode at the shapes the
    # dynamic recipes give them; B1 on a stacked view; the bench.py shape
    dynamic_kernel_rows(torch, dev, g, t, record)
    # the decode and the GEMM of B2's tiles and B5, each alone
    if runs("decode_weight", "wgmma_mm"):
        decode_gemm_rows(torch, dev, g, t, record)
    if runs("quantize_rows", "scaled_mm"):
        stacked_and_bench_rows(torch, dev, g, t, record)
    # B9 at the block shapes of the rings of phase 4r
    if runs("flash_attn", "flash_attn_e4m3"):
        ring_kernel_rows(torch, dev, g, t, record)
    # phases 4m-4o's modes: B3 at padded head dims and D 256, B9
    # at D 256, B2's e5m2 codes and fp16 x on B2 and B5
    mbo_rows(torch, dev, g, t, record, runs)
    # phases 4n and 4t: B1 with a given row scale, B4 at Muon's NS shapes,
    # the NS itself, the tensor-parallel heads
    nt_rows(torch, dev, g, t, record, runs)


    # B5 / B6 / B7 on uint4 half-split codes, group 128 (the uint4 + SVD
    # recipe), with a zero point about 8 steps below the codes.  The plain
    # versions round only the inputs and the output, as the kernels do:
    # B7 sums exact integers and folds in the same fp32 order (bit-equal
    # expected), B5 and B6 sum fp32 in another order.  The limit is one
    # bf16 ulp of the largest output (2^-7 of it) for all three.
    def ulp_tol(want):
        return float(want.float().abs().max()) * 2 ** -7

    def packed_weight(n, k, bits=4, gsize=128):
        top = 2 ** bits
        codes = torch.randint(0, top, (n, k), device=dev, generator=g,
                              dtype=torch.int32)
        scale = torch.rand(n, k // gsize, device=dev, generator=g) * 2e-3 \
            + 1e-3
        zpc = -(top // 2) * scale * (1 + 0.1 * torch.randn(
            n, k // gsize, device=dev, generator=g))
        w_deq = (codes.float().reshape(n, k // gsize, gsize) * scale[..., None]
                 + zpc[..., None]).reshape(n, k).bfloat16()
        return pack_codes_halfsplit(codes, bits), scale, zpc, w_deq

    def halfsplit_bytes(n, k, gsize=128, bits=4):
        return n * k * bits // 8 + 2 * n * (k // gsize) * 4 + n * 4

    if runs("decode_weight", "wgmma_mm"):
        for m, k, n in ((4608, 3072, 21504), (4608, 15360, 3072),
                        (512, 3072, 9216)):
            packed, scale, zpc, w_deq = packed_weight(n, k)
            x = torch.randn(m, k, device=dev, generator=g).bfloat16()
            bias = torch.randn(n, device=dev, generator=g)
            args = (x, packed, scale, zpc, bias, 4, torch.bfloat16)
            got = kd.groupdot_mm(*args)
            want = kd.groupdot_mm_plain(*args)
            record("groupdot_mm", "cuda", "sdnq_tpu_torch/csrc/wgmma_mm.cu",
                   "sdnq_tpu/kernels/dequant_mm.py:355",
                   float((got.float() - want.float()).abs().max()),
                   ulp_tol(want), lambda: kd.groupdot_mm(*args),
                   t(lambda: kd.groupdot_mm_plain(*args), reps=3),
                   bound_ms(m * k * 2 + halfsplit_bytes(n, k) + m * n * 2,
                            2 * m * n * k, "bf16"),
                   t(lambda: F.linear(x, w_deq, bias.bfloat16())),
                   f"M{m} K{k} N{n} uint4 g128", path="uint4_wo")
            del packed, w_deq, x

    # B6 at M 1 (the modulation and embedding linears at batch 1), and at
    # M 8, the most rows it takes (off the paths)
    if runs("blockdiag_mm"):
        for mg, k, n in ((1, 3072, 18432), (1, 256, 3072), (8, 3072, 18432)):
            packed, scale, zpc, w_deq = packed_weight(n, k)
            x = torch.randn(mg, k, device=dev, generator=g)
            bias = torch.randn(n, device=dev, generator=g)
            args = (x, packed, scale, zpc, bias, 4, torch.bfloat16)
            got = kd.blockdiag_mm(*args)
            want = kd.blockdiag_mm_plain(*args)
            xb = x.bfloat16()

            def library(xb=xb, w_deq=w_deq, bias=bias):
                return F.linear(xb, w_deq, bias.bfloat16())
            # a weight of 28 MB stays in the 50 MB L2 between repeated calls;
            # the path reads each layer's cold: timed so too
            cold = b6_cold(torch, args, w_deq, timed) if n * k >= 1 << 24 else {}
            record("blockdiag_mm", "cuda", "sdnq_tpu_torch/csrc/blockdiag_mm.cu",
                   "sdnq_tpu/kernels/dequant_mm.py:593",
                   float((got.float() - want.float()).abs().max()),
                   ulp_tol(want), lambda a=args: kd.blockdiag_mm(*a),
                   t(lambda a=args: kd.blockdiag_mm_plain(*a), reps=5),
                   bound_ms(halfsplit_bytes(n, k) + mg * k * 4 + mg * n * 2,
                            2 * mg * n * k, "fp32"),
                   t(library, reps=20), f"M{mg} K{k} N{n} uint4 g128",
                   path="uint4_wo", on_path=mg == 1, library_fn=library, **cold)
            del packed, w_deq

    # B7: the uint4 q path's shapes, then uint5 g256 (three field planes)
    # at R2's 15360 -> 3072 shape, off the paths (the route sends 5-bit
    # codes to B7 only under the quantized matmul, which R2 does not use)
    if runs("decode_weight", "wgmma_mm"):
        for m, k, n, bits, gsize in ((4608, 3072, 21504, 4, 128),
                                     (4096, 3072, 9216, 4, 128),
                                     (4608, 15360, 3072, 5, 256)):
            packed, scale, zpc, w_deq = packed_weight(n, k, bits, gsize)
            xq = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                               dtype=torch.int8)
            xs = torch.rand(m, 1, device=dev, generator=g) * 0.02 + 1e-3
            bias = torch.randn(n, device=dev, generator=g)
            args = (xq, xs, packed, scale, zpc, bias, bits, torch.bfloat16)
            got = kd.groupdot_i8_mm(*args)
            want = kd.groupdot_i8_mm_plain(*args)
            xb = (xq.float() * xs).bfloat16()
            record("groupdot_i8_mm", "cuda", "sdnq_tpu_torch/csrc/wgmma_mm.cu",
                   "sdnq_tpu/kernels/dequant_mm.py:741",
                   float((got.float() - want.float()).abs().max()),
                   ulp_tol(want), lambda: kd.groupdot_i8_mm(*args),
                   t(lambda: kd.groupdot_i8_mm_plain(*args), reps=3),
                   bound_ms(m * k + halfsplit_bytes(n, k, gsize, bits) + m * 4
                            + m * n * 2, 2 * m * n * k, "int8"),
                   t(lambda: F.linear(xb, w_deq, bias.bfloat16())),
                   f"M{m} K{k} N{n} uint{bits} g{gsize}", path="uint4_qmm",
                   on_path=bits == 4)
            del packed, w_deq, xq, xb

    # B8 at the decode shapes of its domain: meta-llama/Llama-3.2-1B's q and
    # gate projections (hidden 2048, intermediate 8192) at a decode batch of
    # 32 rows, uint4 at its auto group of 64 (the JAX route takes B8 there:
    # 32 x 32 groups <= 1024, g not a multiple of 128), int2 at g 16, and
    # uint5 (two field planes) at g 64 (not on a path).  Bit-equal expected
    # (exact integer partials, the same fp32 folds): limit one bf16 ulp of
    # the largest output.
    if runs("blockdiag_i8_mm"):
        for bits, gsize, k, n in ((4, 64, 2048, 8192), (4, 64, 2048, 2048),
                                  (2, 16, 512, 4096), (5, 64, 2048, 8192)):
            packed, scale, zpc, w_deq = packed_weight(n, k, bits, gsize)
            xq = torch.randint(-127, 128, (32, k), device=dev, generator=g,
                               dtype=torch.int8)
            xs = torch.rand(32, 1, device=dev, generator=g) * 0.02 + 1e-3
            args = (xq, xs, packed, scale, zpc, None, bits, torch.bfloat16)
            got = kd.blockdiag_i8_mm(*args)
            want = kd.blockdiag_i8_mm_plain(*args)
            xb = (xq.float() * xs).bfloat16()
            record("blockdiag_i8_mm", "cuda",
                   "sdnq_tpu_torch/csrc/blockdiag_i8_mm.cu",
                   "sdnq_tpu/kernels/dequant_mm.py:890",
                   float((got.float() - want.float()).abs().max()),
                   ulp_tol(want), lambda: kd.blockdiag_i8_mm(*args),
                   t(lambda: kd.blockdiag_i8_mm_plain(*args), reps=3),
                   bound_ms(32 * k + halfsplit_bytes(n, k, gsize, bits) + 32 * 4
                            + 32 * n * 2, 2 * 32 * n * k, "int8"),
                   t(lambda: F.linear(xb, w_deq), reps=20),
                   f"M32 K{k} N{n} uint{bits} g{gsize}", path="qlinear_b8",
                   on_path=bits != 5)
            del packed, w_deq
    torch.cuda.empty_cache()
    return rows


CROSSOVER_ROWS = (32, 64, 128)


def b7_b8_crossover(torch, dev):
    """Device time of B8 and B7 on the same uint4 g 64 weights, at shapes
    where both kernels take the groups and the JAX route has a result at 32
    rows (K 2048 -> 8192, 2048 and 512: Llama-3.2-1B's q / gate, o and kv
    projections; K 1024 -> 4096), at CROSSOVER_ROWS rows: the measurement
    behind ``dequant_mm.I8_BLOCKDIAG_MAX_ROWS``, which must equal the
    largest row count at which B8 is the faster on every shape."""
    from sdnq_tpu_torch.kernels import dequant_mm as kd
    from sdnq_tpu_torch.packing import pack_codes_halfsplit
    g = torch.Generator(device=dev).manual_seed(90)
    res, wins = {}, {m: True for m in CROSSOVER_ROWS}
    for k, n in ((2048, 8192), (2048, 2048), (2048, 512), (1024, 4096)):
        codes = torch.randint(0, 16, (n, k), device=dev, generator=g,
                              dtype=torch.int32)
        packed = pack_codes_halfsplit(codes, 4)
        scale = torch.rand(n, k // 64, device=dev, generator=g) * 1e-3
        zpc = -8 * scale
        for m in CROSSOVER_ROWS:
            xq = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                               dtype=torch.int8)
            xs = torch.rand(m, 1, device=dev, generator=g)
            args = (xq, xs, packed, scale, zpc, None, 4)
            r = res[f"M{m} K{k} N{n}"] = {
                "B8_device_ms": device_ms(torch, lambda: kd.blockdiag_i8_mm(
                    *args), KERNEL_SYMBOLS["blockdiag_i8_mm"]),
                "B7_device_ms": device_ms(torch, lambda: kd.groupdot_i8_mm(
                    *args), KERNEL_SYMBOLS["groupdot_i8_mm"])}
            timed = None not in r.values()
            check(timed, f"B7 / B8 crossover M{m} K{k} N{n}: both timed")
            wins[m] = (wins[m] and timed
                       and r["B8_device_ms"] < r["B7_device_ms"])
    cut = max([m for m in CROSSOVER_ROWS if wins[m]], default=0)
    log("B7 / B8 crossover, uint4 g64 (I8_BLOCKDIAG_MAX_ROWS = "
        f"{kd.I8_BLOCKDIAG_MAX_ROWS}; B8 the faster on every shape at "
        f"{[m for m in CROSSOVER_ROWS if wins[m]]} rows): " + json.dumps(res))
    check(cut == kd.I8_BLOCKDIAG_MAX_ROWS,
          f"B7 / B8 crossover {cut} rows == I8_BLOCKDIAG_MAX_ROWS "
          f"{kd.I8_BLOCKDIAG_MAX_ROWS}")


def llm_attention_rows(torch, dev, g, t, record):
    """Phase 3 rows of the B3 serving modes (see ``kernel_phase``)."""
    import torch.nn.functional as F
    from sdnq_tpu_torch.kernels import attention as ka
    from sdnq_tpu_torch.quant.core import quantize_int_mm

    src, rep = ("sdnq_tpu_torch/csrc/flash_attn.cuh",
                "sdnq_tpu/kernels/attention.py:67")
    b, h, kh, d, n, kn = 4, 32, 8, 128, 896, 1024
    sm = d ** -0.5
    q = torch.randn(b * h, n, d, device=dev, generator=g)
    k = torch.randn(b * kh, kn, d, device=dev, generator=g)
    v = torch.randn(b * kh, kn, d, device=dev, generator=g)
    pos = torch.arange(n, device=dev)
    mask = (torch.arange(kn, device=dev)[None, :] <= pos[:, None])[
        None, None].expand(b, 1, n, kn)
    # the function needs Q.K^T and P.V only where the mask keeps a key (its
    # kernel walks every tile, as the JAX kernel does): 4 D operations per
    # kept (query, key) pair of each head
    flops = 4 * d * h * int(mask.sum())

    def errors(fn, args, kw):
        """(max |err|, worst row's max |err| over its max |want|, want)"""
        got = fn(*args, out_dtype=torch.float32, **kw)
        want = ka.flash_attention_plain(*args, out_dtype=torch.float32,
                                        **kw)
        err = (got - want).abs()
        row = float((err.amax(-1) / want.abs().amax(-1)).max())
        return float(err.max()), row, want

    # int8 KV cache: pre-quantized K and V, token-mode int8 P·V
    qq, qs = quantize_int_mm(q)
    qs = (qs[..., 0] * sm) * ka.LOG2E
    kq, ks, vq, vs = ka.quantize_kv(k, v)
    args = (qq, kq, vq, qs, ks)
    kw = dict(heads=h, mask=mask, v_scale=vs, p_block=ka.attn_p_block(kn))
    err, row, _ = errors(ka.flash_attention, args, kw)
    # the bf16-P.V kernel at the same shape (int8 Q.K^T, V in bf16): the
    # token kernel's point of comparison, as no one PyTorch call computes
    # token-mode P.V
    vb16 = v.bfloat16()
    record("flash_attention", "cuda", src, rep, err, 2 ** -10,
           lambda: ka.flash_attention(*args, **kw),
           t(lambda: ka.flash_attention_plain(*args, **kw), reps=3),
           bound_ms(b * h * n * d + 2 * b * kh * kn * d
                    + (b * h * n + 2 * b * kh * kn) * 4 + b * n * kn
                    + b * h * n * d * 2, flops, "int8"),
           None, f"BH{b * h} KH{b * kh} N{n} KN{kn} D{d} mask int8-QK "
           "token-P.V", path="llm_int8kv", count="flash_attention:int8_pv",
           reading=row, **bf16_pv_beside(torch, t, lambda: ka.flash_attention(
               qq, kq, vb16, qs, ks, heads=h, mask=mask)))
    del qq, kq, vq, vb16

    # bf16 KV cache: bf16 Q.K^T and P.V under the same mask
    qb, kb, vb = (q * (sm * ka.LOG2E)).bfloat16(), k.bfloat16(), v.bfloat16()
    args = (qb, kb, vb)
    kw = dict(heads=h, mask=mask)
    err, row, _ = errors(ka.flash_attention, args, kw)
    q4 = q.bfloat16().reshape(b, h, n, d)
    k4, v4 = (x.reshape(b, kh, kn, d).repeat_interleave(h // kh, 1)
              for x in (kb, vb))
    sdpa = (lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, scale=sm))
    record("flash_attention", "cuda", src, rep, err, 2 ** -6,
           lambda: ka.flash_attention(*args, **kw),
           t(lambda: ka.flash_attention_plain(*args, **kw), reps=3),
           bound_ms(2 * (b * h * n * d + 2 * b * kh * kn * d)
                    + b * n * kn + b * h * n * d * 2, flops, "bf16"),
           t(sdpa), f"BH{b * h} KH{b * kh} N{n} KN{kn} D{d} mask bf16",
           path="llm_bf16kv", count="flash_attention:masked", reading=row,
           library_fn=sdpa)
    del q, k, v, qb, kb, vb, q4, k4, v4

    # the cache-free forward: causal over 2 x 1024 tokens, 32 over 8 heads;
    # the kernel skips the tiles right of the diagonal, so the work this
    # input needs is the lower triangle
    b, n = 2, 1024
    qb = (torch.randn(b * h, n, d, device=dev, generator=g)
          * (sm * ka.LOG2E)).bfloat16()
    kb, vb = (torch.randn(b * kh, n, d, device=dev, generator=g).bfloat16()
              for _ in range(2))
    args = (qb, kb, vb)
    kw = dict(heads=h, causal=True)
    err, row, _ = errors(ka.flash_attention, args, kw)
    q4 = (qb.float() / (sm * ka.LOG2E)).bfloat16().reshape(b, h, n, d)
    k4, v4 = (x.reshape(b, kh, n, d).repeat_interleave(h // kh, 1)
              for x in (kb, vb))
    sdpa = (lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=sm))
    record("flash_attention", "cuda", src, rep, err, 2 ** -6,
           lambda: ka.flash_attention(*args, **kw),
           t(lambda: ka.flash_attention_plain(*args, **kw), reps=3),
           bound_ms(2 * (b * h * n * d + 2 * b * kh * n * d)
                    + b * h * n * d * 2,
                    4 * d * b * h * n * (n + 1) // 2, "bf16"),
           t(sdpa), f"BH{b * h} KH{b * kh} N{n} KN{n} D{d} causal bf16",
           path="llm_causal", count="flash_attention:causal", reading=row,
           library_fn=sdpa)
    # the same causal forward with int8 Q, K and V (token-mode P.V; off the
    # paths): the token kernel's diagonal tile and causal skip
    qq, qs = quantize_int_mm(qb.float())
    kq, ks, vq, vs = ka.quantize_kv(kb.float(), vb.float())
    args = (qq, kq, vq, qs[..., 0], ks)
    kw = dict(heads=h, causal=True, v_scale=vs, p_block=ka.attn_p_block(n))
    err, row, _ = errors(ka.flash_attention, args, kw)
    record("flash_attention", "cuda", src, rep, err, 2 ** -10,
           lambda: ka.flash_attention(*args, **kw),
           t(lambda: ka.flash_attention_plain(*args, **kw), reps=3),
           bound_ms(b * h * n * d + 2 * b * kh * n * d
                    + (b * h * n + 2 * b * kh * n) * 4 + b * h * n * d * 2,
                    4 * d * b * h * n * (n + 1) // 2, "int8"),
           None, f"BH{b * h} KH{b * kh} N{n} KN{n} D{d} causal int8-QK "
           "token-P.V", on_path=False, path="llm_causal",
           count="flash_attention:int8_pv", reading=row,
           **bf16_pv_beside(torch, t, lambda: ka.flash_attention(
               qq, kq, vb, qs[..., 0], ks, heads=h, causal=True)))


# B3's head-mode int8 P.V and e4m3 Q.K at the UNet's self-attention shapes
# (BH, N, D 64; N = KN): 5 x 4096 (SD1.5 level 0 at 512x512), 10 x 4096
# (SDXL level 1 at 1024x1024), 20 x 1024 (SDXL level 2); head mode also at
# FLUX's 24 x 4608, D 128.
UNET_ATTN = ((5, 4096, 64, "SD1.5 L0"), (10, 4096, 64, "SDXL L1"),
             (20, 1024, 64, "SDXL L2"))


def attn_mode_operands(torch, q, k, v, qk, pv):
    """flash_attention's operands from (BH, N, D) fp32 q, k, v: q, k bf16
    (q pre-scaled by sm_scale log2 e) or per-token int8 / e4m3 with
    q_scale carrying sm_scale log2 e; v bf16 (``pv`` "bf16"), per-token
    int8 ("token") or int8 of one scale a head ("head")."""
    from sdnq_tpu_torch.kernels import attention as ka
    from sdnq_tpu_torch.quant.core import quantize_fp_mm, quantize_int_mm
    sm = q.shape[-1] ** -0.5
    if qk == "bf16":
        args = [(q * (sm * ka.LOG2E)).bfloat16(), k.bfloat16(), None]
    else:
        quant = quantize_int_mm if qk == "int8" else quantize_fp_mm
        (qq, qs), (kq, ks) = quant(q), quant(k)
        args = [qq, kq, None, (qs[..., 0] * sm) * ka.LOG2E, ks[..., 0]]
    kw = {}
    if pv == "bf16":
        args[2] = v.bfloat16()
    elif pv == "token":
        vq, vs = quantize_int_mm(v)
        args[2] = vq
        kw = dict(v_scale=vs[..., 0], p_block=ka.attn_p_block(k.shape[1]))
    else:
        vs = v.abs().amax((1, 2)).clamp_min(1e-20) / 127.0
        args[2] = torch.round(v / vs[:, None, None]).to(torch.int8)
        kw = dict(v_head_scale=vs, p_block=ka.attn_p_block(k.shape[1]))
    return args, kw


def unet_attention_rows(torch, dev, g, t, record):
    """Phase 3 rows of B3 at the UNet's self-attention shapes: the modes
    its paths run (int8 Q.K with bf16 P.V at 4096 tokens, bf16 at 1024;
    e4m3 Q.K with head-mode P.V at 5 x 4096, the fp8 recipe), and head mode
    and e4m3 Q.K (alone, with token-mode and head-mode P.V) off the paths,
    head mode also at FLUX's joint attention.  Each row in fp32 against its
    plain version, each row of the output over its own largest value: int8
    P.V (head and token mode) quantizes P at the same points on both
    sides, 2^-10 with int8 Q.K^T (its scores bit-equal); e4m3 Q.K^T's
    scores are the kernel's fp32 sums of exact products in another order
    than the plain version's, so a P code at a rounding tie may move by
    one step (sound readings up to 2.97e-3 on the H100): 2^-7; bf16 P is
    rounded against other maxima, 2^-6.  The bound takes Q.K^T and P.V
    each at their operand type's peak."""
    import torch.nn.functional as F
    from sdnq_tpu_torch.kernels import attention as ka

    src, rep = ("sdnq_tpu_torch/csrc/flash_attn.cuh",
                "sdnq_tpu/kernels/attention.py:67")
    kinds = {"bf16": "bf16", "int8": "int8", "e4m3": "fp8", "token": "int8",
             "head": "int8"}

    def row(label, q, k, v, qk, pv, path, count, on_path=False):
        bh, n, d = q.shape
        kn = k.shape[1]
        args, kw = attn_mode_operands(torch, q, k, v, qk, pv)
        got = ka.flash_attention(*args, out_dtype=torch.float32, **kw)
        want = ka.flash_attention_plain(*args, out_dtype=torch.float32,
                                        **kw)
        err = (got - want).abs()
        reading = float((err.amax(-1) / want.abs().amax(-1)).max())
        del got, want
        qb, vb = (2 if qk == "bf16" else 1), (2 if pv == "bf16" else 1)
        moved = (bh * n * d * qb + bh * kn * d * (qb + vb)
                 + (bh * (n + kn) * 4 if qk != "bf16" else 0)
                 + (bh * kn * 4 if pv == "token" else 0)
                 + bh * n * d * 2)
        ops = 2 * bh * n * kn * d
        bnd = bound_mixed_ms(moved, (ops, kinds[qk]), (ops, kinds[pv]))
        q16, k16, v16 = (x.bfloat16()[None] for x in (q, k, v))
        sdpa = (lambda: F.scaled_dot_product_attention(q16, k16, v16,
                                                       scale=d ** -0.5))
        beside = {}
        if pv != "bf16":  # the bf16-P.V kernel at the same shape
            a16, _ = attn_mode_operands(torch, q, k, v, qk, "bf16")
            beside = bf16_pv_beside(torch, t, lambda: ka.flash_attention(
                *a16))
        tol = (2 ** -6 if pv == "bf16" else 2 ** -7 if qk == "e4m3"
               else 2 ** -10)
        record("flash_attention", "cuda", src, rep, float(err.max()), tol,
               lambda: ka.flash_attention(*args, **kw),
               t.once(lambda: ka.flash_attention_plain(*args, **kw)), bnd,
               t(sdpa), f"BH{bh} N{n} KN{kn} D{d} {qk}-QK {pv}-P.V "
               f"({label})", on_path=on_path, path=path, count=count,
               reading=reading, library_fn=sdpa, **beside)

    for bh, n, d, label in UNET_ATTN:
        q, k, v = (torch.randn(bh, n, d, device=dev, generator=g)
                   for _ in range(3))
        if t.fresh():   # the modes the paths run at these shapes
            if n == 4096:
                path = "sd15" if bh == 5 else "sdxl"
                row(label, q, k, v, "int8", "bf16", path,
                    "flash_attention:int8_qk", on_path=True)
            else:
                row(label, q, k, v, "bf16", "bf16", "sdxl",
                    "flash_attention:bf16_qk", on_path=True)
        if t.fresh("flash_attention:head_pv"):
            row(label, q, k, v, "int8", "head", "sd15_fp8",
                "flash_attention:head_pv")
            row(label, q, k, v, "e4m3", "head", "sd15_fp8",
                "flash_attention:head_pv", on_path=bh == 5)
        if t.fresh("flash_attention:e4m3_qk") and bh == 5:
            row(label, q, k, v, "e4m3", "bf16", "sd15_fp8",
                "flash_attention:e4m3_qk")
            row(label, q, k, v, "e4m3", "token", "sd15_fp8",
                "flash_attention:e4m3_qk")
        del q, k, v
    if t.fresh("flash_attention:head_pv"):
        b, h, n, d = FLUX_ATTN
        q, k, v = (torch.randn(b * h, n, d, device=dev, generator=g)
                   for _ in range(3))
        row("FLUX", q, k, v, "int8", "head", "int8",
            "flash_attention:head_pv")
        del q, k, v
    torch.cuda.empty_cache()


def bf16_pv_beside(torch, t, fn):
    """The bf16-P.V kernel's events ms and device ms at a token row's shape
    (``fn`` calls it), the token kernel's point of comparison: keys of the
    row."""
    if not t.timed:
        return dict(bf16_pv_ms=None, bf16_pv_device_ms=None)
    return dict(bf16_pv_ms=t(fn), bf16_pv_device_ms=device_ms(
        torch, fn, KERNEL_SYMBOLS["flash_attention"]))


def yardstick_ms(t, fn, what):
    """Time a PyTorch yardstick the port never calls; where this PyTorch
    build refuses the call, say so and record null."""
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        log(f"library yardstick for {what} not timed: {e}"[:300])
        return None
    return t(fn)


def train_kernel_rows(torch, dev, g, t, record):
    """Phase 3 rows of B10 (the grad-weight GEMM) and of B1's nn and
    colscale modes (the grad-input GEMM) at the shapes of the FLUX.1-dev
    training step: 1536 tokens (1024 image + 512 text), batch 1."""
    from sdnq_tpu_torch.kernels import scaled_mm as ks

    def library_or_none(fn, what):
        return yardstick_ms(t, fn, what)

    def padded(fn, what):
        """The yardstick with the transposed copies and the scales its
        call needs around it (events and device ms of every kernel), for
        ``library_padded_ms`` beside the call alone's ``library_ms``."""
        ms = library_or_none(fn, what)
        return dict(library_padded_ms=ms, library_padded_device_ms=(
            device_ms(torch, fn, "") if ms is not None else None))

    runs = t.runs
    src_tn = "sdnq_tpu_torch/csrc/scaled_mm_tn.cu"
    rep_tn = "sdnq_tpu/kernels/scaled_mm.py:534"
    # B10 int8: gw = g^T x with both quantized columnwise.  Bit-equal to
    # the plain version (exact integer sums, the same fp32 epilogue): limit
    # 0.  Shapes: single-block linear1 (1536 x 21504 by 1536 x 3072),
    # double-block img fc1 (1024 x 12288 by 1024 x 3072), and a modulation
    # linear at batch 1 (M = 1: 1 x 18432 by 1 x 3072).
    if runs("scaled_mm_tn"):
        for m, n, k, what in ((1536, 21504, 3072, "linear1"),
                              (1024, 12288, 3072, "img fc1"),
                              (1, 18432, 3072, "img_mod")):
            a = torch.randint(-128, 128, (m, n), device=dev, generator=g,
                              dtype=torch.int8)
            b = torch.randint(-128, 128, (m, k), device=dev, generator=g,
                              dtype=torch.int8)
            a_s = torch.rand(n, device=dev, generator=g) * 1e-3 + 1e-5
            b_s = torch.rand(k, device=dev, generator=g) * 1e-2 + 1e-4
            got = ks.scaled_mm_tn(a, b, a_s, b_s)
            want = ks.scaled_mm_tn_plain(a, b, a_s, b_s)
            err = float((got - want).abs().max())
            del got, want

            def with_copies():
                if m == 1:  # _int_mm takes no K of 1; one int8 product is
                    # exact in fp32, so the outer product is the same function
                    acc = torch.outer(a[0].float(), b[0].float())
                else:
                    acc = torch._int_mm(a.t().contiguous(), b).float()
                return acc * a_s[:, None] * b_s[None, :]
            # the product alone, on operands laid out for it beforehand (A^T
            # row-major, B column-major: cuBLASLt's int8 layout)
            at = a.t().contiguous() if m > 1 else a[0].float()
            bt = b.t().contiguous().t() if m > 1 else b[0].float()

            def library():
                return torch.outer(at, bt) if m == 1 else torch._int_mm(at, bt)
            lib_ms = library_or_none(library, f"scaled_mm_tn {what}")
            extra = padded(with_copies, f"scaled_mm_tn {what}, padded")
            record("scaled_mm_tn", "cuda", src_tn, rep_tn, err, 0.0,
                   lambda: ks.scaled_mm_tn(a, b, a_s, b_s),
                   t(lambda: ks.scaled_mm_tn_plain(a, b, a_s, b_s), reps=3),
                   bound_ms(m * n + m * k + 4 * n * k + 4 * (n + k),
                            2 * m * n * k, "int8"),
                   lib_ms, f"M{m} N{n} K{k} int8 ({what} grad-weight)",
                   path="train", library_fn=library if lib_ms else None, **extra)
            del a, b, at, bt

    # the uint8 family's grad-weight (``dynamic_mm_tn``): its rank-2
    # zero-point term u (N, 2) @ v (2, K) in B10's epilogue, summed in fp32
    # in r order, against the plain version's torch u @ v on the same
    # operands: read as the worst |got - want| over |want| + |u| @ |v|
    # (``scaled_mm.TN_LOWRANK_TOL``).  Off the paths (the training path's
    # int8 weights take the int8 family).
    if runs("scaled_mm_tn"):
        m, n, k = 1024, 12288, 3072
        ga = torch.randn(m, n, device=dev, generator=g) + 0.5
        xb = torch.randn(m, k, device=dev, generator=g) * 2
        ops = ks.uint8_tn_operands(ga, xb)
        got = ks.dynamic_mm_tn(ga, xb, "uint8")
        want = ks.scaled_mm_tn_plain(*ops[:4], lowrank_u=ops[4],
                                     lowrank_v=ops[5])
        mag = want.abs() + ops[4].abs() @ ops[5].abs()
        diff = (got - want).abs()
        reading, err = float((diff / mag).max()), float(diff.max())
        del got, want, mag, diff, ga, xb
        record("scaled_mm_tn", "cuda", src_tn, rep_tn, err, ks.TN_LOWRANK_TOL,
               lambda: ks.scaled_mm_tn(*ops[:4], lowrank_u=ops[4],
                                       lowrank_v=ops[5]),
               t(lambda: ks.scaled_mm_tn_plain(*ops[:4], lowrank_u=ops[4],
                                               lowrank_v=ops[5]), reps=3),
               bound_ms(m * n + m * k + 4 * n * k + 12 * (n + k), 2 * m * n * k,
                        "int8"),
               None, f"M{m} N{n} K{k} uint8 family, rank-2 term (img fc1 "
               "grad-weight)", on_path=False, reading=reading,
               what="worst |got - want| / (|want| + |u| @ |v|)")
        del ops

    # B10 e4m3 (fp8 weights train their grad-weight in fp8): products exact
    # in fp32, fp32 sums in another order.  Read as the worst error over
    # the sum of |terms| of its element; limit 1e-5.
    if runs("scaled_mm_tn"):
        m, n, k = 1536, 21504, 3072
        a = (torch.randn(m, n, device=dev, generator=g) * 30).to(
            torch.float8_e4m3fn)
        b = (torch.randn(m, k, device=dev, generator=g) * 30).to(
            torch.float8_e4m3fn)
        a_s = torch.rand(n, device=dev, generator=g) * 1e-3 + 1e-5
        b_s = torch.rand(k, device=dev, generator=g) * 1e-2 + 1e-4
        got = ks.scaled_mm_tn(a, b, a_s, b_s)
        want = ks.scaled_mm_tn_plain(a, b, a_s, b_s)
        terms = (a.float().abs().T @ b.float().abs()) * a_s[:, None] \
            * b_s[None, :]
        diff = (got - want).abs()
        reading = float((diff / (terms + 1e-30)).max())
        err = float(diff.max())
        del got, want, terms, diff
        one = torch.ones((), device=dev)

        def with_copies():
            out = torch._scaled_mm(a.t().contiguous(), b.t().contiguous().t(),
                                   scale_a=one, scale_b=one,
                                   out_dtype=torch.float32)
            return out * a_s[:, None] * b_s[None, :]
        # the product alone (no scales), on operands laid out for it beforehand
        at, bt = a.t().contiguous(), b.t().contiguous().t()

        def library():
            return torch._scaled_mm(at, bt, scale_a=one, scale_b=one,
                                    out_dtype=torch.float32)
        lib_ms = library_or_none(library, "scaled_mm_tn fp8")
        extra = padded(with_copies, "scaled_mm_tn fp8, padded")
        record("scaled_mm_tn", "cuda", src_tn, rep_tn, err, 1e-5,
               lambda: ks.scaled_mm_tn(a, b, a_s, b_s),
               t(lambda: ks.scaled_mm_tn_plain(a, b, a_s, b_s), reps=3),
               bound_ms(m * n + m * k + 4 * n * k + 4 * (n + k), 2 * m * n * k,
                        "fp8"),
               lib_ms, f"M{m} N{n} K{k} e4m3 (linear1 grad-weight)",
               on_path=False, reading=reading,
               library_fn=library if lib_ms else None, **extra)
        del a, b, at, bt

    # B1 in the grad-input route at single-block linear1: the bf16
    # cotangent g (1536, 21504) times the weight's row scales (colscale),
    # quantized per row, then g_q (1536, 21504) . W (21504, 3072) reading
    # the stored (O, K) weight as it lies (nn).  Both bit-equal to their
    # plain versions (limit 0): the codes, and the bf16 output, which both
    # sides round once from the same exact integer sum and fp32 epilogue.
    if runs("quantize_rows"):
        m, o = 1536, 21504
        x = torch.randn(m, o, device=dev, generator=g).bfloat16()
        cs = torch.rand(o, device=dev, generator=g) * 2e-3 + 1e-5
        got = ks.quantize_rows(x, colscale=cs)
        want = ks.quantize_rows_plain(x, colscale=cs)
        err = max(float((u.float() - v.float()).abs().max())
                  for u, v in zip(got[:2], want[:2]))
        record("quantize_rows", "cuda", "sdnq_tpu_torch/csrc/quantize_rows.cu",
               "sdnq_tpu/kernels/scaled_mm.py:230", err, 0.0,
               lambda: ks.quantize_rows(x, colscale=cs),
               t(lambda: ks.quantize_rows_plain(x, colscale=cs), reps=3),
               bound_ms(m * o * 3 + o * 4 + m * 4, 4 * m * o, "fp32"), None,
               f"M{m} K{o} bfloat16 colscale (linear1 grad-input)",
               path="train", count="quantize_rows:colscale")
        del x
    if runs("scaled_mm"):
        nn_rows(torch, dev, g, t, record, library_or_none, padded,
                got[:2] if runs("quantize_rows") else None)
    torch.cuda.empty_cache()


# B4 nn at the grad-input GEMMs of the FLUX.1-dev training step (batch 1,
# 1024 image + 512 text tokens): (M, contraction, N, what, launches a step
# by (double, single) block: the double blocks' image and text streams,
# the single blocks).
NN_SHAPES = ((1536, 21504, 3072, "single linear1", (0, 1)),
             (1536, 3072, 15360, "single linear2", (0, 1)),
             (1024, 9216, 3072, "img qkv", (1, 0)),
             (1024, 12288, 3072, "img fc1", (1, 0)),
             (1024, 3072, 12288, "img fc2", (1, 0)),
             (512, 9216, 3072, "txt qkv", (1, 0)),
             (1, 18432, 3072, "img_mod / txt_mod", (2, 0)),
             (1, 9216, 3072, "single modulation", (0, 1)))


def nn_rows(torch, dev, g, t, record, library_or_none, padded, linear1_q):
    """Phase 3 rows of B4 nn (the grad-input GEMM g_q (M, O) . W (O, K) on
    the stored weight as it lies, TMA + s8 wgmma with B transposed in shared
    memory, the contraction split where ``nn_plan`` says) at every shape of
    NN_SHAPES, linear1's codes from the colscale row before; each call of
    two in a row bit-equal to its plain version (limit 0: the same exact
    integer sum, the same fp32 epilogue and bf16 rounding; the second finds
    the split counters as the first left them), beside ``torch._int_mm`` alone on
    operands laid out for it beforehand (B column-major: cuBLASLt's int8
    layout; none at M 1, which it refuses) and with the transposed copy of
    the weight and the epilogue.  Then the ragged shape with every
    epilogue term and e4m3 (off the paths)."""
    from sdnq_tpu_torch.kernels import scaled_mm as ks
    src, rep = ("sdnq_tpu_torch/csrc/scaled_mm.cu",
                "sdnq_tpu/kernels/scaled_mm.py:230")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, o, kk, what, per_block in NN_SHAPES:
        per_step = (per_block[0] * TRAIN_DEPTH[0]
                    + per_block[1] * TRAIN_DEPTH[1])
        if what == "single linear1" and linear1_q is not None:
            xq, xs = linear1_q
        else:
            xq = torch.randint(-127, 128, (m, o), device=dev, generator=g,
                               dtype=torch.int8)
            xs = torch.rand(m, 1, device=dev, generator=g) * 1e-4 + 1e-6
        w = torch.randint(-127, 128, (o, kk), device=dev, generator=g,
                          dtype=torch.int8)
        want = ks.scaled_gemm_plain(xq, w, torch.bfloat16, xs,
                                    b_layout="nn")
        err = 0.0
        for _ in range(2):   # the second call on the workspace the first left
            got = ks.scaled_gemm(xq, w, torch.bfloat16, xs, b_layout="nn")
            err = max(err, float((got.float() - want.float()).abs().max()))
        del got, want
        w_cm = w.t().contiguous().t()   # cuBLASLt's layout, made beforehand

        def library(xq=xq, w_cm=w_cm):
            return torch._int_mm(xq, w_cm)

        def with_copies(xq=xq, w=w, xs=xs):
            acc = torch._int_mm(xq, w.t().contiguous().t())
            return (acc.float() * xs).to(torch.bfloat16)
        lib_ms = library_or_none(library, f"scaled_gemm nn {what}")
        extra = padded(with_copies, f"scaled_gemm nn {what}, padded")
        nb, whole, splits = ks.nn_plan(m, kk, o, torch.int8, sms)
        record("scaled_gemm", "cuda", src, rep, err, 0.0,
               lambda xq=xq, w=w, xs=xs: ks.scaled_gemm(
                   xq, w, torch.bfloat16, xs, b_layout="nn"),
               t(lambda: ks.scaled_gemm_plain(xq, w, torch.bfloat16, xs,
                                              b_layout="nn"), reps=3),
               bound_ms(m * o + o * kk + m * kk * 2 + m * 4,
                        2 * m * o * kk, "int8"),
               lib_ms, f"M{m} K{o} N{kk} int8 nn ({what} grad-input)",
               path="train", count="scaled_gemm:nn",
               library_fn=library if lib_ms else None,
               plan=f"128 x {128 * nb} tiles, {whole} whole, the others "
               f"split {splits} ways",
               launches_a_step=per_step, **extra)
        del xq, w, w_cm

    # ragged M, N and K (TMA's zero fill of A's rows, B's rows and
    # columns), every epilogue term, int8 bit-equal; then e4m3 at linear1
    # (fp16 wgmma, B MN-major), read as the worst error over the sum of
    # |terms| of its element, limit 1e-5.  Off the paths.
    m, o, kk = 1000, 2000, 3008
    a = torch.randint(-128, 128, (m, o), device=dev, generator=g,
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (o, kk), device=dev, generator=g,
                      dtype=torch.int8)
    xs = torch.rand(m, 1, device=dev, generator=g) * 0.02 + 1e-3
    ws = torch.rand(kk, device=dev, generator=g) * 0.02 + 1e-3
    bias, vz0, vz1 = (torch.randn(kk, device=dev, generator=g)
                      for _ in range(3))
    rs, zp = (torch.randn(m, device=dev, generator=g) for _ in range(2))
    args = (a, b, torch.bfloat16, xs, ws, bias, rs, zp, vz0, vz1)
    got = ks.scaled_gemm(*args, b_layout="nn")
    want = ks.scaled_gemm_plain(*args, b_layout="nn")
    record("scaled_gemm", "cuda", src, rep,
           float((got.float() - want.float()).abs().max()), 0.0,
           lambda: ks.scaled_gemm(*args, b_layout="nn"),
           t(lambda: ks.scaled_gemm_plain(*args, b_layout="nn"), reps=3),
           bound_ms(m * o + o * kk + m * kk * 2 + (3 * m + 5 * kk) * 4,
                    2 * m * o * kk, "int8"),
           None, f"M{m} K{o} N{kk} int8 nn, every epilogue term",
           on_path=False, count="scaled_gemm:nn")
    del a, b, got, want

    m, o, kk = 1536, 21504, 3072
    a = (torch.randn(m, o, device=dev, generator=g) * 8).to(
        torch.float8_e4m3fn)
    b = (torch.randn(o, kk, device=dev, generator=g) * 8).to(
        torch.float8_e4m3fn)
    xs = torch.rand(m, 1, device=dev, generator=g) * 1e-3 + 1e-5
    got = ks.scaled_gemm(a, b, torch.float32, xs, b_layout="nn")
    want = ks.scaled_gemm_plain(a, b, torch.float32, xs, b_layout="nn")
    terms = (a.float().abs() @ b.float().abs()) * xs
    diff = (got - want).abs()
    reading, err = float((diff / (terms + 1e-30)).max()), float(diff.max())
    del got, want, terms, diff
    one = torch.ones((), device=dev)
    b_cm = b.t().contiguous().t()

    def library():
        return torch._scaled_mm(a, b_cm, scale_a=one, scale_b=one,
                                out_dtype=torch.float32)
    lib_ms = library_or_none(library, "scaled_gemm nn fp8")
    record("scaled_gemm", "cuda", src, rep, err, 1e-5,
           lambda: ks.scaled_gemm(a, b, torch.float32, xs, b_layout="nn"),
           t(lambda: ks.scaled_gemm_plain(a, b, torch.float32, xs,
                                          b_layout="nn"), reps=3),
           bound_ms(m * o + o * kk + m * kk * 4 + m * 4, 2 * m * o * kk,
                    "fp8"),
           lib_ms, f"M{m} K{o} N{kk} e4m3 nn (linear1 grad-input)",
           on_path=False, reading=reading, count="scaled_gemm:nn",
           library_fn=library if lib_ms else None,
           what="worst |got - want| / sum |a b| xs")
    del a, b, b_cm


def pipeline_kernel_rows(torch, dev, g, t, record):
    """Phase 3 rows of B2's grouped and row modes and of B3's additive
    mask, at the shapes of the FLUX text-to-image pipeline under SDNQ's
    default int8 recipe (weight-only, groups of 1024 along K)."""
    runs = t.runs
    import torch.nn.functional as F
    from sdnq_tpu_torch.kernels import attention as ka
    from sdnq_tpu_torch.kernels import dequant_mm as kd

    src, rep = ("sdnq_tpu_torch/csrc/wgmma_mm.cu",
                "sdnq_tpu/kernels/dequant_mm.py:60")

    def weight(n, k, groups, unsigned=False):
        if unsigned:
            codes = torch.randint(0, 256, (n, k), device=dev, generator=g,
                                  dtype=torch.uint8)
        else:
            codes = torch.randint(-127, 128, (n, k), device=dev, generator=g,
                                  dtype=torch.int8)
        scale = torch.rand(n, groups, device=dev, generator=g) * 2e-4 + 1e-4
        zp = (-128 * scale * (1 + 0.1 * torch.randn(
            n, groups, device=dev, generator=g)) if unsigned else None)
        return codes, scale, zp

    def w_bf16(codes, scale, zp):
        """The dequantized bf16 weight of the library yardstick."""
        n, k = codes.shape
        w = codes.float().reshape(n, scale.shape[1], -1) * scale[..., None]
        if zp is not None:
            w = w + zp[..., None]
        return w.reshape(n, k).bfloat16()

    # grouped, tiles: the DiT's single-block linear1 (4608 tokens) and
    # T5's wi_0 (512 tokens); one uint8 layer with a zero point (off the
    # path: the recipe is symmetric).  The kernel and the plain version
    # multiply the same bf16 weights and sum in fp32 in another order: the
    # bf16 outputs agree to one bf16 ulp of the largest (2^-7 of it).
    if runs("decode_weight", "wgmma_mm"):
        for m, k, n, what, unsigned in (
                (4608, 3072, 21504, "DiT linear1", False),
                (512, 4096, 10240, "T5 wi_0", False),
                (512, 4096, 4096, "uint8 + zp", True)):
            codes, scale, zp = weight(n, k, k // 1024, unsigned)
            x = torch.randn(m, k, device=dev, generator=g).bfloat16()
            bias = torch.randn(n, device=dev, generator=g)
            args = (x, codes, scale, zp, bias, torch.bfloat16)
            got = kd.dequant_mm(*args)
            want = kd.dequant_mm_plain(*args)
            wb = w_bf16(codes, scale, zp)
            record("dequant_mm", "cuda", src, rep,
                   float((got.float() - want.float()).abs().max()),
                   float(want.float().abs().max()) * 2 ** -7,
                   lambda: kd.dequant_mm(*args),
                   t(lambda: kd.dequant_mm_plain(*args), reps=3),
                   bound_ms(m * k * 2 + n * k + 2 * n * (k // 1024) * 4
                            + n * 4 + m * n * 2, 2 * m * n * k, "bf16"),
                   t(lambda: F.linear(x, wb, bias.bfloat16())),
                   f"M{m} K{k} N{n} {'uint8+zp' if unsigned else 'int8'} g1024 "
                   f"({what})", on_path=not unsigned, path="pipeline",
                   count="dequant_mm:grouped")
            del codes, x, wb, got, want

    # grouped, GEMV: a modulation linear at batch 1 (3072 -> 18432, 3
    # groups), fp32 rows as the DiT's vec; fp32 sums in another order
    if runs("dequant_gemv"):
        k, n = 3072, 18432
        codes, scale, _ = weight(n, k, 3)
        x = torch.randn(1, k, device=dev, generator=g)
        bias = torch.randn(n, device=dev, generator=g)
        args = (x, codes, scale, None, bias, torch.bfloat16)
        got = kd.dequant_gemv(*args)
        want = kd.dequant_gemv_plain(*args)
        wb = w_bf16(codes, scale, None)
        record("dequant_gemv", "cuda", "sdnq_tpu_torch/csrc/dequant_gemv.cu", rep,
               float((got.float() - want.float()).abs().max()),
               float(want.float().abs().max()) * 2 ** -7,
               lambda: kd.dequant_gemv(*args),
               t(lambda: kd.dequant_gemv_plain(*args), reps=5),
               bound_ms(n * k + k * 4 + 2 * n * 3 * 4 + n * 4 + n * 2,
                        2 * n * k, "fp32"),
               t(lambda: F.linear(x.bfloat16(), wb, bias.bfloat16()), reps=20),
               f"M1 K{k} N{n} int8 g1024 (modulation)", path="pipeline",
               count="dequant_gemv:grouped",
               library_fn=lambda: F.linear(x.bfloat16(), wb, bias.bfloat16()),
               **gemv_cold(torch, args, wb, t.timed))
        del codes, wb

    # row mode, tiles: CLIP's fc1 (77 tokens, 768 -> 3072, one group)
    if runs("decode_weight", "wgmma_mm"):
        m, k, n = 77, 768, 3072
        codes, scale, _ = weight(n, k, 1)
        x = torch.randn(m, k, device=dev, generator=g).bfloat16()
        bias = torch.randn(n, device=dev, generator=g)
        args = (x, codes, scale, None, bias, torch.bfloat16)
        got = kd.dequant_mm(*args)
        want = kd.dequant_mm_plain(*args)
        wb = (codes.float() * scale).bfloat16()
        record("dequant_mm", "cuda", src, rep,
               float((got.float() - want.float()).abs().max()),
               float(want.float().abs().max()) * 2 ** -7,
               lambda: kd.dequant_mm(*args),
               t(lambda: kd.dequant_mm_plain(*args), reps=5),
               bound_ms(m * k * 2 + n * k + 2 * n * 4 + m * n * 2,
                        2 * m * n * k, "bf16"),
               t(lambda: F.linear(x, wb, bias.bfloat16()), reps=20),
               f"M{m} K{k} N{n} int8 rowwise (CLIP fc1)", path="pipeline",
               count="dequant_mm:row")
        del codes, wb

    # B3's additive mask at T5-XXL's shape: 64 heads, 512 tokens, head dim
    # 64, scale 1, a relative position bias (1, 64, 512, 512) in fp32 from a
    # (32, 64) table gathered by the bucket table (its values about 2, so a
    # fault in the mask moves the softmax).  Held per row against the row's
    # largest output: 2^-6 (P rounded to bf16 against a running max).
    if runs("flash_attn", "flash_attn_e4m3"):
        from sdnq_tpu_torch.models.text_encoder import _rel_bucket
        h, n, d = 64, 512, 64
        pos = torch.arange(n, device=dev)
        table = torch.randn(32, h, device=dev, generator=g) * 2
        bias = table[_rel_bucket(pos[None, :] - pos[:, None], 32, 128)].permute(
            2, 0, 1)[None].contiguous()
        q, kk, v = (torch.randn(h, n, d, device=dev, generator=g) * 0.4
                    for _ in range(3))
        qb = (q * ka.LOG2E).bfloat16()
        kb, vb = kk.bfloat16(), v.bfloat16()
        kw = dict(heads=h, mask=bias)
        got = ka.flash_attention(qb, kb, vb, out_dtype=torch.float32, **kw)
        want = ka.flash_attention_plain(qb, kb, vb, out_dtype=torch.float32,
                                        **kw)
        err = (got - want).abs()
        row = float((err.amax(-1) / want.abs().amax(-1)).max())
        q4, k4, v4 = (a.bfloat16()[None] for a in (q, kk, v))
        sdpa = (lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias,
                                                       scale=1.0))
        record("flash_attention", "cuda", "sdnq_tpu_torch/csrc/flash_attn.cuh",
               "sdnq_tpu/kernels/attention.py:67", float(err.max()), 2 ** -6,
               lambda: ka.flash_attention(qb, kb, vb, **kw),
               t(lambda: ka.flash_attention_plain(qb, kb, vb, **kw), reps=3),
               bound_ms(3 * h * n * d * 2 + h * n * n * 4 + h * n * d * 2,
                        4 * h * n * n * d, "bf16"),
               t(sdpa), f"BH{h} N{n} KN{n} D{d} fp32 additive mask bf16 (T5)",
               path="pipeline", count="flash_attention:float_mask", reading=row,
               library_fn=sdpa)
        del q, kk, v, qb, kb, vb, q4, k4, v4, bias
    torch.cuda.empty_cache()


def decode_gemm_rows(torch, dev, g, t, record):
    """Phase 3 rows of the two halves of B2's tiles, B5 and B7 alone, at
    DiT linear1 (4608 x 3072 -> 21504): ``decode_weight`` on int8 g1024
    codes (the default recipe), float8_e3m4fn g1024 bit-plane codes (R1),
    float5_e2m2fn g128 half-split codes (R2) and uint4 half-split codes into
    int8 (B7), each bit-equal to its plain version (limit 0); ``wgmma_mm``
    with each epilogue against its plain version (one bf16 ulp of the
    largest output, 2^-7 of it; B7's int8 fold bit-equal), and once at
    ragged M, N and K (N % 256 != 0, K % 64 != 0) off the paths."""
    import torch.nn.functional as F
    from sdnq_tpu_torch import quantize_tensor
    from sdnq_tpu_torch.kernels import dequant_mm as kd
    from sdnq_tpu_torch.packing import pack_codes_halfsplit

    src_d = "sdnq_tpu_torch/csrc/decode_weight.cu"
    src_g = "sdnq_tpu_torch/csrc/wgmma_mm.cu"
    rep = "sdnq_tpu/kernels/dequant_mm.py:60"
    m, k, n = 4608, 3072, 21504

    def err(got, want):
        return float((got.float() - want.float()).abs().max())

    codes = torch.randint(-127, 128, (n, k), device=dev, generator=g,
                          dtype=torch.int8)
    scale = torch.rand(n, k // 1024, device=dev, generator=g) * 2e-4 + 1e-4
    # (arguments, what, mode, path, bytes read and written, replaces)
    cases = [((codes, k, scale, None), "int8 g1024", "grouped", "pipeline",
              n * k + scale.numel() * 4 + n * k * 2, rep)]
    qt = quantize_tensor(student_t(torch, (n, k), 2, g, dev) * 0.02,
                         "float8_e3m4fn", group_size=1024)
    cases.append(((qt.qdata, k, qt.scale.reshape(n, -1), None,
                   qt.meta.format, "bitplane"), "float8_e3m4fn g1024",
                  "bitplane", "dyn_r1",
                  qt.qdata.numel() + qt.scale.numel() * 4 + n * k * 2, rep))
    qt5 = quantize_tensor(student_t(torch, (n, k), 3, g, dev) * 0.02,
                          "float5_e2m2fn", group_size=128)
    f5 = qt5.meta.format
    cases.append(((qt5.qdata, k, None, None, f5, "halfsplit", f5.code_bits),
                  "float5_e2m2fn g128", "halfsplit", "dyn_r2",
                  qt5.qdata.numel() + n * k * 2,
                  "sdnq_tpu/kernels/dequant_mm.py:355"))
    # B7's decode: uint4 g128 codes into int8, one byte a weight
    packed4 = pack_codes_halfsplit(torch.randint(
        0, 16, (n, k), device=dev, generator=g, dtype=torch.int32), 4)
    cases.append(((packed4, k, None, None, None, "halfsplit", 4, torch.int8),
                  "uint4 g128 into int8", "halfsplit_i8", "uint4_qmm",
                  packed4.numel() + n * k, "sdnq_tpu/kernels/dequant_mm.py:741"))
    for args, what, mode, path, nbytes, replaces in cases:
        got = kd.decode_weight(*args)
        record("decode_weight", "cuda", src_d, replaces,
               err(got, kd.decode_weight_plain(*args)), 0.0,
               lambda a=args: kd.decode_weight(*a),
               t(lambda a=args: kd.decode_weight_plain(*a), reps=3),
               bound_ms(nbytes), None,
               f"N{n} K{k} {what} ({mode}, DiT linear1)", path=path,
               count=f"decode_weight:{mode}")
        del got
    del codes, qt, qt5

    # B7's GEMM alone at linear1: int8 x and W' (uint4 codes), g 128
    w8 = kd.decode_weight(packed4, k, layout="halfsplit", bits=4,
                          dtype=torch.int8)
    xq = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                       dtype=torch.int8)
    s8 = torch.rand(n, k // 128, device=dev, generator=g) * 2e-3 + 1e-3
    z8 = -8 * s8
    xs8 = torch.rand(m, device=dev, generator=g) * 0.02 + 1e-3
    b8 = torch.randn(n, device=dev, generator=g)
    args = (xq, w8, k, "fold_i8", b8, s8, z8,
            xq.float().reshape(m, k // 128, 128).sum(-1), torch.bfloat16)
    want = kd.wgmma_mm_plain(*args, xs=xs8)
    xb, wb = xq.bfloat16(), w8.bfloat16()
    record("wgmma_mm", "cuda", src_g, "sdnq_tpu/kernels/dequant_mm.py:741",
           err(kd.wgmma_mm(*args, xs=xs8), want),
           float(want.float().abs().max()) * 2 ** -7,
           lambda: kd.wgmma_mm(*args, xs=xs8),
           t(lambda: kd.wgmma_mm_plain(*args, xs=xs8), reps=3),
           bound_ms(m * k + n * k + m * n * 2, 2 * m * n * k, "int8"),
           t(lambda: F.linear(xb, wb)),
           f"M{m} K{k} N{n} int8, int8 fold g128 (DiT linear1)",
           path="uint4_qmm", count="wgmma_mm:fold_i8",
           symbol="wgmma_i8_fold_kernel")
    del packed4, w8, xq, xb, wb, want

    w = torch.randn(n, k, device=dev, generator=g).bfloat16()
    x = torch.randn(m, k, device=dev, generator=g).bfloat16()
    bias = torch.randn(n, device=dev, generator=g)
    s1 = torch.rand(n, device=dev, generator=g) * 1e-2
    z1 = torch.randn(n, device=dev, generator=g) * 1e-2
    sg = torch.rand(n, k // 128, device=dev, generator=g) * 1e-2
    zg = torch.randn(n, k // 128, device=dev, generator=g) * 1e-2
    xsum = x.float().sum(-1)
    xsg = x.float().reshape(m, k // 128, 128).sum(-1)
    gemm = bound_ms(m * k * 2 + n * k * 2 + m * n * 2, 2 * m * n * k, "bf16")
    for epi, kw, lib, path in (
            ("bias", {}, lambda: F.linear(x, w, bias.bfloat16()), "pipeline"),
            ("row", dict(scale=s1, zp=z1, xsum=xsum), None, "pipeline"),
            ("fold", dict(scale=sg, zp=zg, xsum=xsg), None, "uint4_wo")):
        args = (x, w, k, epi, bias)
        got = kd.wgmma_mm(*args, **kw)
        want = kd.wgmma_mm_plain(*args, **kw)
        record("wgmma_mm", "cuda", src_g, rep, err(got, want),
               float(want.float().abs().max()) * 2 ** -7,
               lambda a=args, kw=kw: kd.wgmma_mm(*a, **kw),
               t(lambda a=args, kw=kw: kd.wgmma_mm_plain(*a, **kw), reps=3),
               gemm, t(lib) if lib else None,
               f"M{m} K{k} N{n} bf16, {epi} epilogue"
               f"{' g128' if epi == 'fold' else ''} (DiT linear1)",
               path=path, count=f"wgmma_mm:{epi}")
        del got, want
    del w, x, sg, zg, xsg

    # ragged M, N and K: the TMA zero fill and the epilogue's column guard
    m, k, n = 1000, 3000, 3000
    w = torch.randn(n, k, device=dev, generator=g).bfloat16()
    x = torch.randn(m, k, device=dev, generator=g).bfloat16()
    bias = torch.randn(n, device=dev, generator=g)
    args = (x, w, k, "bias", bias)
    want = kd.wgmma_mm_plain(*args)
    record("wgmma_mm", "cuda", src_g, rep, err(kd.wgmma_mm(*args), want),
           float(want.float().abs().max()) * 2 ** -7,
           lambda: kd.wgmma_mm(*args),
           t(lambda: kd.wgmma_mm_plain(*args), reps=3),
           bound_ms(m * k * 2 + n * k * 2 + m * n * 2, 2 * m * n * k, "bf16"),
           t(lambda: F.linear(x, w, bias.bfloat16())),
           f"M{m} K{k} N{n} bf16, bias epilogue (ragged tails)",
           on_path=False, count="wgmma_mm:tail")
    del w, x
    torch.cuda.empty_cache()


def student_t(torch, shape, nu, g, dev):
    """Gaussian draws (nu None), or Student-t with nu degrees of freedom as
    z / sqrt(chi2_nu / nu), chi2_nu a sum of nu squared normals; fp32 on
    the card from ``g``."""
    z = torch.randn(shape, device=dev, generator=g)
    if nu is None:
        return z
    chi2 = torch.zeros(shape, device=dev)
    for _ in range(nu):
        chi2.add_(torch.randn(shape, device=dev, generator=g).square_())
    return z.div_(chi2.div_(nu).sqrt_())


def dynamic_kernel_rows(torch, dev, g, t, record):
    """Phase 3 rows of B2's bit-plane mode (tiles and GEMV) and of B5 / B6
    on multi-plane and minifloat half-split codes, on weights with tails
    quantized by ``quantize_tensor`` to the formats the dynamic ladder
    reaches: float9_e3m5fn rowwise and float8_e3m4fn g1024 from int8 (R1),
    float5_e2m2fn g128, uint5 g256 and int6 g512 from uint4 (R2).  The
    kernels and the plain versions multiply the same bf16 (B2) or exact
    (B5, B6) weights and sum in fp32 in other orders: one bf16 ulp of the
    largest output (2^-7 of it)."""
    runs = t.runs
    import torch.nn.functional as F
    from sdnq_tpu_torch import dequantize, quantize_tensor
    from sdnq_tpu_torch.kernels import dequant_mm as kd

    def qweight(n, k, fmt, gsize, nu):
        qt = quantize_tensor(student_t(torch, (n, k), nu, g, dev) * 0.02,
                             fmt, group_size=gsize)
        scale = qt.scale.reshape(n, -1)
        zp = (None if qt.zero_point is None
              else qt.zero_point.reshape(n, -1))
        side = 4 * scale.numel() * (1 if zp is None else 2) + 4 * n
        return qt, scale, zp, dequantize(qt, torch.bfloat16), side

    def ulp(want):
        return float(want.float().abs().max()) * 2 ** -7

    def err(got, want):
        return float((got.float() - want.float()).abs().max())

    def label(fmt, gsize):
        return f"{fmt} {'rowwise' if gsize < 0 else f'g{gsize}'}"

    rep = "sdnq_tpu/kernels/dequant_mm.py:60"
    if runs("decode_weight", "wgmma_mm", "dequant_gemv"):
        for fmt, gsize, nu in (("float9_e3m5fn", -1, 3),
                               ("float8_e3m4fn", 1024, 2)):
            m, k, n = 4608, 3072, 21504
            qt, scale, zp, wb, side = qweight(n, k, fmt, gsize, nu)
            f = qt.meta.format
            x = torch.randn(m, k, device=dev, generator=g).bfloat16()
            bias = torch.randn(n, device=dev, generator=g)
            args = (x, qt.qdata, scale, zp, bias, torch.bfloat16, f)
            want = kd.dequant_mm_plain(*args)
            record("dequant_mm", "cuda", "sdnq_tpu_torch/csrc/wgmma_mm.cu", rep,
                   err(kd.dequant_mm(*args), want), ulp(want),
                   lambda: kd.dequant_mm(*args),
                   t(lambda: kd.dequant_mm_plain(*args), reps=3),
                   bound_ms(m * k * 2 + qt.qdata.numel() + side + m * n * 2,
                            2 * m * n * k, "bf16"),
                   t(lambda: F.linear(x, wb, bias.bfloat16())),
                   f"M{m} K{k} N{n} {label(fmt, gsize)} bit-plane (DiT linear1)",
                   path="dyn_r1", count="dequant_mm:bitplane")
            k, n = 3072, 18432
            qt, scale, zp, wb, side = qweight(n, k, fmt, gsize, nu)
            # M 1: the modulation linears at batch 1; M 32 (float8): the most
            # rows the GEMV takes, off the paths
            for mg in (1,) if gsize < 0 else (1, 32):
                x = torch.randn(mg, k, device=dev, generator=g).bfloat16()
                bias = torch.randn(n, device=dev, generator=g)
                args = (x, qt.qdata, scale, zp, bias, torch.bfloat16, f)
                want = kd.dequant_gemv_plain(*args)
                record("dequant_gemv", "cuda",
                       "sdnq_tpu_torch/csrc/dequant_gemv.cu", rep,
                       err(kd.dequant_gemv(*args), want), ulp(want),
                       lambda a=args: kd.dequant_gemv(*a),
                       t(lambda a=args: kd.dequant_gemv_plain(*a), reps=5),
                       bound_ms(mg * k * 2 + qt.qdata.numel() + side + mg * n * 2,
                                2 * mg * n * k, "bf16"),
                       t(lambda x=x, b=bias: F.linear(x, wb, b.bfloat16()),
                         reps=20),
                       f"M{mg} K{k} N{n} {label(fmt, gsize)} bit-plane "
                       f"({'modulation' if mg == 1 else 'many rows'})",
                       path="dyn_r1", count="dequant_gemv:bitplane",
                       on_path=mg == 1)
            del qt, wb, x

    if runs("decode_weight", "wgmma_mm"):
        for fmt, gsize, nu, m, k, n in (
                ("float5_e2m2fn", 128, 3, 4608, 3072, 21504),
                ("uint5", 256, 5, 4608, 15360, 3072),
                ("int6", 512, 2, 4608, 3072, 21504)):
            qt, scale, zp, wb, side = qweight(n, k, fmt, gsize, nu)
            f = qt.meta.format
            s, zpc = kd._group_operands(scale, zp, f)
            x = torch.randn(m, k, device=dev, generator=g).bfloat16()
            bias = torch.randn(n, device=dev, generator=g)
            args = (x, qt.qdata, s, zpc, bias, f.code_bits, torch.bfloat16, f)
            want = kd.groupdot_mm_plain(*args)
            mode = "minifloat" if not f.is_integer else "multiplane"
            record("groupdot_mm", "cuda", "sdnq_tpu_torch/csrc/wgmma_mm.cu",
                   "sdnq_tpu/kernels/dequant_mm.py:355",
                   err(kd.groupdot_mm(*args), want), ulp(want),
                   lambda: kd.groupdot_mm(*args),
                   t(lambda: kd.groupdot_mm_plain(*args), reps=3),
                   bound_ms(m * k * 2 + qt.qdata.numel() + side + m * n * 2,
                            2 * m * n * k, "bf16"),
                   t(lambda: F.linear(x, wb, bias.bfloat16())),
                   f"M{m} K{k} N{n} {label(fmt, gsize)} half-split {mode}",
                   path="dyn_r2", count=f"groupdot_mm:{mode}")
            del qt, wb, x

    # M 1 on the paths; float5 at M 8 too (off the paths)
    if runs("blockdiag_mm"):
        for fmt, gsize, nu, mg in (("float5_e2m2fn", 128, 3, 1), ("uint5", 256, 5, 1),
                                   ("float5_e2m2fn", 128, 3, 8)):
            k, n = 3072, 18432
            qt, scale, zp, wb, side = qweight(n, k, fmt, gsize, nu)
            f = qt.meta.format
            s, zpc = kd._group_operands(scale, zp, f)
            x = torch.randn(mg, k, device=dev, generator=g).bfloat16()
            bias = torch.randn(n, device=dev, generator=g)
            args = (x, qt.qdata, s, zpc, bias, f.code_bits, torch.bfloat16, f)
            want = kd.blockdiag_mm_plain(*args)
            mode = "minifloat" if not f.is_integer else "multiplane"

            def library(x=x, wb=wb, bias=bias):
                return F.linear(x, wb, bias.bfloat16())
            cold = b6_cold(torch, args, wb, t.timed)
            record("blockdiag_mm", "cuda", "sdnq_tpu_torch/csrc/blockdiag_mm.cu",
                   "sdnq_tpu/kernels/dequant_mm.py:593",
                   err(kd.blockdiag_mm(*args), want), ulp(want),
                   lambda a=args: kd.blockdiag_mm(*a),
                   t(lambda a=args: kd.blockdiag_mm_plain(*a), reps=5),
                   bound_ms(mg * k * 2 + qt.qdata.numel() + side + mg * n * 2,
                            2 * mg * n * k, "bf16"),
                   t(library, reps=20),
                   f"M{mg} K{k} N{n} {label(fmt, gsize)} half-split {mode}",
                   path="dyn_r2", count=f"blockdiag_mm:{mode}", on_path=mg == 1,
                   library_fn=library, **cold)
            del qt, wb
    torch.cuda.empty_cache()


# bench.py's shape: qlinear on an int8 rowwise QTensor with the quantized
# matmul and a bias (B1's row quantize, then B4's int8 GEMM)
BENCH_SHAPE = (16384, 4096, 8192)   # M, K, N


def stacked_and_bench_rows(torch, dev, g, t, record):
    """B1's stacked mode (layer 2 of a stack of four DiT linear1 weights,
    read where it lies) and the bench.py shape, each bit-exact against its
    plain version (the limit, one bf16 ulp of the largest output, as the
    B4 rows)."""
    import torch.nn.functional as F
    from sdnq_tpu_torch import qlinear, quantize_tensor
    from sdnq_tpu_torch.kernels import scaled_mm as ks

    m, k, n, layers = 4608, 3072, 21504, 4
    stack = torch.randint(-127, 128, (layers, n, k), device=dev, generator=g,
                          dtype=torch.int8)
    w_s = torch.rand(layers, n, 1, device=dev, generator=g) * 2e-4 + 1e-5
    view, ws = stack[2], w_s[2]
    check(view.is_contiguous() and view.data_ptr() == stack.data_ptr()
          + 2 * n * k, "B1 stacked: layer 2 is a contiguous view at its "
          "offset")
    x = torch.randn(m, k, device=dev, generator=g).bfloat16()
    bias = torch.randn(n, device=dev, generator=g)
    args = (x, view, ws, bias)
    got = ks.scaled_mm_fused_act(*args)
    with plain_versions():
        want = ks.scaled_mm_fused_act(*args)

    def plain():
        with plain_versions():
            return ks.scaled_mm_fused_act(*args)
    record("scaled_gemm", "cuda", "sdnq_tpu_torch/csrc/scaled_mm.cu",
           "sdnq_tpu/kernels/scaled_mm.py:230",
           float((got.float() - want.float()).abs().max()),
           float(want.float().abs().max()) * 2 ** -7,
           lambda: ks.scaled_mm_fused_act(*args), t(plain, reps=3),
           bound_ms(m * k * 2 + n * k + n * 8 + m * n * 2, 2 * m * n * k,
                    "int8"), None,
           f"M{m} K{k} N{n} int8, layer 2 of a ({layers}, N, K) stack "
           "(B1 + B4 on a stacked view)", path="stacked",
           symbol=("quantize_rows_", "scaled_mm_wgmma_kernel"))
    del stack, view, got, want

    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    m, k, n = BENCH_SHAPE
    qt = quantize_tensor(torch.randn(n, k, device=dev, generator=g) * 0.02,
                         "int8", use_quantized_matmul=True)
    check(qt.meta.group_size == -1 and not qt.meta.re_quantize_for_matmul,
          "bench.py shape: int8 rowwise QTensor under the quantized matmul")
    x = torch.randn(m, k, device=dev, generator=g).bfloat16()
    bias = torch.randn(n, device=dev, generator=g)
    torch.cuda.synchronize()
    reset_launch_counts()
    got = qlinear(x, qt, bias)
    torch.cuda.synchronize()
    BENCH_COUNTS.update(launch_counts())
    with plain_versions():
        want = qlinear(x, qt, bias)

    def plain():
        with plain_versions():
            return qlinear(x, qt, bias)
    xq, xs = ks.quantize_rows(x)[:2]
    wq, wsc = qt.qdata, qt.scale.reshape(1, -1)

    def library():
        acc = torch._int_mm(xq, wq.t())
        return ((acc.float() * xs) * wsc + bias).to(torch.bfloat16)
    wb = (wq.float() * qt.scale).bfloat16()
    bf16_ms = t(lambda: F.linear(x, wb, bias.bfloat16()))
    record("scaled_gemm", "cuda", "sdnq_tpu_torch/csrc/scaled_mm.cu",
           "sdnq_tpu/kernels/scaled_mm.py:230",
           float((got.float() - want.float()).abs().max()),
           float(want.float().abs().max()) * 2 ** -7,
           lambda: qlinear(x, qt, bias), t(plain, reps=2),
           bound_ms(m * k * 2 + n * k + n * 8 + m * n * 2, 2 * m * n * k,
                    "int8"), t(library),
           f"bench.py M{m} K{k} N{n} int8 rowwise qlinear + bias "
           "(B1 + B4)", path="bench",
           symbol=("quantize_rows_", "scaled_mm_wgmma_kernel"),
           bf16_linear_ms=bf16_ms)
    del qt, x, got, want, xq, wb
    torch.cuda.empty_cache()


BENCH_COUNTS: dict = {}


# ---------------------------------------------------------------------------
# phase 4r: sequence and pipeline parallelism (ring attention, Ulysses,
# GPipe) on one card, and B9's rows of phase 3
# ---------------------------------------------------------------------------

# The attention shapes of the two models: FLUX.1-dev's joint attention at
# 1024x1024 (24 heads of 128 over 4096 image + 512 text tokens) and
# Llama-3-8B's causal prefill of 8192 tokens (32 query heads of 128 over 8
# KV heads, repeated for the ring, which takes equal heads).
FLUX_ATTN = (1, 24, 4608, 128)
LLAMA_ATTN = (1, 32, 8192, 128, 8)
RING_MODES = {"int8_token": {}, "int8": dict(quantize_pv=False),
              "bf16": dict(matmul_dtype=None)}
RING_P = (2, 4, 8)

# Limits of B9 against its plain version (phase 3): "out", the largest
# error of acc / l over its row's largest value; "m", the largest error of
# the row max over max |m|; "l", the largest relative error of the row sum.
# About twice the sound readings on the H100 over the eight shapes: out
# 2.73e-3 where P is rounded to bf16 (against a 64-key tile's running max in
# the kernel, a 512-key block's in the plain version), 4.5e-7 in token mode
# (P quantized at the same points with the same expf on both sides); m 0
# in int8 (the same exact products times the same fp32 scales), 4.6e-7 in
# bf16 (fp32 sums in another order); l 2.9e-6.
B9_TOL = {"bf16_p": {"out": 6e-3, "m": 1e-6, "l": 6e-6},
          "int8_token": {"out": 1e-6, "m": 1e-6, "l": 6e-6},
          # e4m3 Q.K: the kernel's fp32 sums of exact products in another
          # order than the plain version's, so a P code at a rounding tie
          # may move by one step
          # (sound readings on the H100 at FLUX's P = 1 block: out 2.41e-3,
          # m 1.4e-7, l 1.2e-6)
          "e4m3_token": {"out": 6e-3, "m": 1e-6, "l": 6e-6}}
# Limits of the ring checks of phase 4r, the largest error over the largest
# output: "f64", against float64 softmax attention; "b3", against the
# single-device quantized_attention (B3) in the same mode; "p1", virtual P
# against P = 1.  About twice the sound readings on the H100 at P = 1, 2, 4,
# 8 (FLUX) and 1, 4 (Llama): f64 4.3e-2 token mode, 1.2e-2 int8 Q.K with
# bf16 P.V, 4.1e-3 bf16, 1.05e-2 Llama; b3 3.6e-2, 1.2e-3, 4.3e-3, 3.8e-4;
# p1 3.6e-2, 1.2e-3, 1.4e-3, 6.4e-5.  Token mode quantizes P once per P
# block against that block's running max, so its readings move with the
# block layout (B3's P = 1 agrees to 1.0e-3).
RING_TOL = {"int8_token": {"f64": 9e-2, "b3": 7.5e-2, "p1": 7.5e-2},
            "int8": {"f64": 2.5e-2, "b3": 2.5e-3, "p1": 2.5e-3},
            "bf16": {"f64": 9e-3, "b3": 9e-3, "p1": 3e-3},
            "llama": {"f64": 2.2e-2, "b3": 8e-4, "p1": 1.5e-4}}
# Limit of the ring slice: the local ring at P = 2 with B9 against the same
# ring on B9's plain version, both on the card, about three times its sound
# reading on the H100, 1.6e-7 (token mode: the blocks agree to 4.5e-7 in
# phase 3 and are merged in the same order).
RING_SLICE_TOL = 5e-7


def attention_f64(torch, q, k, v, causal=False, heads=4):
    """float64 softmax attention (the JAX tests' ``_ref``) of (B, H, N, D)
    tensors, ``heads`` heads at a time."""
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    n, kn = q.shape[2], k.shape[2]
    keep = (torch.ones(n, kn, dtype=torch.bool, device=q.device).tril()
            if causal else None)
    for h0 in range(0, q.shape[1], heads):
        hs = slice(h0, h0 + heads)
        s = (q[:, hs].double() @ k[:, hs].double().transpose(-1, -2)) \
            * q.shape[-1] ** -0.5
        if causal:
            s.masked_fill_(~keep, -1e30)
        out[:, hs] = torch.softmax(s, -1) @ v[:, hs].double()
        del s
    return out


def b9_operands(torch, q, k, v, mode):
    """The ring's block operands from (BH, N, D) fp32 chunks: per-token
    int8 (or, "e4m3_token", e4m3) q, k (q_scale carrying sm_scale) or bf16;
    v bf16, or per-token int8 for token-mode P·V."""
    from sdnq_tpu_torch.quant.core import quantize_fp_mm, quantize_int_mm
    sm = q.shape[-1] ** -0.5
    quant, token = mode != "bf16", mode.endswith("_token")
    if quant:
        qfn = quantize_fp_mm if mode.startswith("e4m3") else quantize_int_mm
        qq, qs = qfn(q)
        kq, ks = qfn(k)
        args = [qq, kq, None, qs[..., 0] * sm, ks[..., 0], None]
    else:
        args = [q.bfloat16(), k.bfloat16(), None, None, None, None]
    if token:
        vq, vs = quantize_int_mm(v)
        args[2], args[5] = vq, vs[..., 0]
    else:
        args[2] = v.bfloat16()
    return args, dict(quantized=quant, quantized_pv=token, sm_scale=sm)


def b9_readings(got, want) -> dict:
    """B9's (acc, m, l) against the plain version's: acc / l per row over
    the row's largest output, m over the largest live |m|, l relative."""
    (acc, m, l), (wacc, wm, wl) = got, want
    out, ref = acc / l, wacc / wl
    live = wm > -1e29
    return {"out": float(((out - ref).abs().amax(-1)
                          / ref.abs().amax(-1)).max()),
            "m": float((m - wm).abs().max() / wm[live].abs().max()),
            "l": float(((l - wl).abs() / wl).max())}


def ring_kernel_rows(torch, dev, g, t, record):
    """Phase 3 rows of B9 at the block shapes of phase 4r's rings: FLUX at
    P = 1 in three modes, at P = 2 and 4 (one block of rank 0's first
    step); Llama at P = 1 (the 8192^2 causal mask) and in the zigzag layout
    at P = 4 (1024-row chunk pairs: the triangle at step 0, and a whole
    block).  Each row holds acc / l per row, m and l against the plain
    version (``B9_TOL``); its reading is the largest of the three over its
    limit."""
    import torch.nn.functional as F
    from sdnq_tpu_torch.kernels import attention as ka

    src, rep = ("sdnq_tpu_torch/csrc/flash_attn.cuh",
                "sdnq_tpu/kernels/attention.py:259")

    def row(label, q, k, v, mode, mask=None, library=None, **extra):
        args, kw = b9_operands(torch, q, k, v, mode)
        args.append(mask)
        acc, m, l = ka.flash_attention_block(*args, **kw)
        wacc, wm, wl = ka.flash_attention_block_plain(*args, **kw)
        out, want = acc / l, wacc / wl
        got = b9_readings((acc, m, l), (wacc, wm, wl))
        tol = B9_TOL.get(mode, B9_TOL["bf16_p"])
        log(f"B9 {label} {mode}: readings " + json.dumps(got)
            + " limits " + json.dumps(tol))
        bh, n, d = q.shape
        kn = k.shape[1]
        kept = (bh * n * kn if mask is None
                else int(mask.sum()) * (bh // mask.shape[0]))
        ops = 4 * d * kept   # Q.K^T and P.V where a key is kept
        q_b = 1 if mode != "bf16" else 2
        v_b = 1 if mode.endswith("_token") else 2
        moved = (bh * n * d * q_b + bh * kn * d * (q_b + v_b)
                 + (bh * n + bh * kn) * 4 * (mode != "bf16")
                 + bh * kn * 4 * mode.endswith("_token")
                 + bh * n * (d + 2) * 4
                 + (0 if mask is None else mask.numel()))
        if mode == "int8":   # Q.K^T at the int8 rate, P.V at the bf16 rate
            bnd = bound_ms(moved, 0.75 * ops, "bf16")
        elif mode == "e4m3_token":   # Q.K^T at the fp8 rate, P.V at int8's
            bnd = bound_mixed_ms(moved, (ops / 2, "fp8"), (ops / 2, "int8"))
        else:
            bnd = bound_ms(moved, ops, "int8" if mode != "bf16" else "bf16")
        beside = {}
        if mode.endswith("_token"):  # the bf16-P.V kernel at the same shape
            a16, kw16 = b9_operands(torch, q, k, v, mode[:4])
            a16.append(mask)
            beside = bf16_pv_beside(
                torch, t, lambda: ka.flash_attention_block(*a16, **kw16))
            del a16
        record("flash_attention_block", "cuda", src, rep,
               float((out - want).abs().max()), 1.0,
               lambda: ka.flash_attention_block(*args, **kw),
               t(lambda: ka.flash_attention_block_plain(*args, **kw),
                 reps=3),
               bnd, t(library) if library else None,
               f"BH{bh} N{n} KN{kn} D{d} {mode}"
               + ("" if mask is None else f" mask {tuple(mask.shape)}")
               + f" ({label})", path="ring",
               reading=max(got[key] / tol[key] for key in got),
               what="largest reading (out, m, l) over its limit",
               readings=got, limits=tol, library_fn=library,
               **beside, **extra)

    b, h, n, d = FLUX_ATTN
    q, k, v = (torch.randn(b * h, n, d, device=dev, generator=g)
               for _ in range(3))
    sm = d ** -0.5
    q16, k16, v16 = (x.bfloat16()[None] for x in (q, k, v))
    sdpa = (lambda: F.scaled_dot_product_attention(q16, k16, v16, scale=sm))
    if t.fresh("flash_attention:e4m3_qk"):  # off the ring's modes
        row("FLUX P1", q, k, v, "e4m3_token", library=sdpa, on_path=False,
            count="flash_attention_block:e4m3_qk")
    for mode in RING_MODES:
        row("FLUX P1", q, k, v, mode,
            library=sdpa if mode == "bf16" else None)
    for p in (2, 4):
        c = n // p
        row(f"FLUX P{p}", q[:, :c], k[:, :c], v[:, :c], "int8_token")
    del q, k, v, q16, k16, v16
    b, h, n, d, _ = LLAMA_ATTN
    q, k, v = (torch.randn(b * h, n, d, device=dev, generator=g)
               for _ in range(3))
    causal = torch.ones(n, n, dtype=torch.bool, device=dev).tril()[None]
    row("Llama P1 causal", q, k, v, "int8_token", mask=causal)
    del causal
    c = n // 8
    tri = torch.ones(c, c, dtype=torch.bool, device=dev).tril()[None]
    row("Llama P4 zigzag step 0", q[:, :c], k[:, :c], v[:, :c],
        "int8_token", mask=tri)
    row("Llama P4 zigzag", q[:, c:2 * c], k[:, :c], v[:, :c], "int8_token")
    del q, k, v
    torch.cuda.empty_cache()


def ring_phase(torch, dev):
    """Phase 4r: ``ring_attention`` through a mesh of one on the card
    (create_mesh(sequence=1), P = 1) and the local ring at virtual P = 2,
    4 and 8 at FLUX.1-dev's joint attention in three modes; Ulysses at P =
    1 (B3); Llama-3-8B's causal prefill at P = 1 (the contiguous layout)
    and P = 4 (zigzag).  Each ring against float64 attention, against
    ``quantized_attention`` in the same mode, and virtual P against P = 1;
    launch counts zeroed just before and read just after; the B9 launches
    of each ring call; ring P = 1 timed beside B3 in the same mode; the
    token-mode ring at P = 1 and 4 traced.  Returns the counts."""
    from sdnq_tpu_torch.kernels import attention as ka
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.parallel import (
        create_mesh, ring_attention, ulysses_attention,
    )
    from sdnq_tpu_torch.parallel.ring_attention import _local_ring

    g = torch.Generator(device=dev).manual_seed(77)
    mesh = create_mesh(sequence=1)
    b, h, n, d = FLUX_ATTN
    q, k, v = (torch.randn(b, h, n, d, device=dev, generator=g)
               for _ in range(3))
    bl, hl, nl, dl, kvh = LLAMA_ATTN
    ql = torch.randn(bl, hl, nl, dl, device=dev, generator=g)
    kl, vl = (torch.randn(bl, kvh, nl, dl, device=dev, generator=g)
              .repeat_interleave(hl // kvh, dim=1) for _ in range(2))
    b3_kw = {"int8_token": dict(matmul_dtype="int8", pv_matmul_dtype="int8",
                                pv_scale_mode="token"),
             "int8": dict(matmul_dtype="int8"),
             "bf16": dict(matmul_dtype=None)}
    per_call, outs = {}, {}

    def run(label, fn):
        b9, xla = ka.flash_attention_block.launches, \
            ka.attention_block_xla.calls
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        per_call[label] = dict(
            b9_launches=ka.flash_attention_block.launches - b9,
            xla_block_calls=ka.attention_block_xla.calls - xla,
            s=round(time.perf_counter() - t0, 4))
        return out

    torch.cuda.synchronize()
    reset_launch_counts()
    for mode, kw in RING_MODES.items():
        outs[mode, 1] = run(f"FLUX {mode} P1", lambda: ring_attention(
            q, k, v, mesh, **kw))
        for p in RING_P:
            outs[mode, p] = run(f"FLUX {mode} P{p}", lambda: _local_ring(
                q, k, v, p, **kw))
    uly = run("FLUX Ulysses int8 P1", lambda: ulysses_attention(
        q, k, v, mesh))
    llama = {1: run("Llama int8_token causal P1", lambda: ring_attention(
        ql, kl, vl, mesh, causal=True)),
        4: run("Llama int8_token causal P4 zigzag", lambda: _local_ring(
            ql, kl, vl, 4, causal=True))}
    counts = launch_counts()
    log("ring: launches " + json.dumps(counts))
    log("ring: per call " + json.dumps(per_call))
    check(counts["flash_attention_block"] > 0 and counts["flash_attention"]
          > 0, "ring path launched flash_attention_block and "
          "flash_attention")
    for label, c in per_call.items():
        b9_route = "P8" not in label and "Ulysses" not in label
        check((c["b9_launches"] > 0) == b9_route
              and (c["xla_block_calls"] > 0) == ("P8" in label),
              f"ring {label}: B9 launches {c['b9_launches']}, XLA block "
              f"calls {c['xla_block_calls']}")

    def rel(a, ref):
        return float((a.double() - ref).abs().max() / ref.abs().max())
    readings = {}
    ref = attention_f64(torch, q, k, v)
    for mode in RING_MODES:
        b3 = ka.quantized_attention(q, k, v, out_dtype=torch.float32,
                                    **b3_kw[mode]).double()
        for p in (1,) + RING_P:
            out = outs[mode, p]
            r = {"f64": rel(out, ref), "b3": rel(out, b3)}
            if p > 1:
                r["p1"] = rel(out, outs[mode, 1].double())
            readings[f"FLUX {mode} P{p}"] = r
            check(tuple(out.shape) == FLUX_ATTN
                  and bool(torch.isfinite(out).all())
                  and all(r[key] <= RING_TOL[mode][key] for key in r),
                  f"ring FLUX {mode} P{p}: finite, " + ", ".join(
                      f"{key} {r[key]:.3e} <= {RING_TOL[mode][key]:.1e}"
                      for key in r))
    check(torch.equal(uly, ka.quantized_attention(q, k, v,
                                                  matmul_dtype="int8")),
          "Ulysses at P = 1 equals quantized_attention (int8 Q.K)")
    del ref, b3
    ref = attention_f64(torch, ql, kl, vl, causal=True)
    b3 = ka.quantized_attention(ql, kl, vl, is_causal=True,
                                out_dtype=torch.float32,
                                **b3_kw["int8_token"]).double()
    for p, out in llama.items():
        r = {"f64": rel(out, ref), "b3": rel(out, b3)}
        if p > 1:
            r["p1"] = rel(out, llama[1].double())
        readings[f"Llama causal P{p}"] = r
        check(bool(torch.isfinite(out).all())
              and all(r[key] <= RING_TOL["llama"][key] for key in r),
              f"ring Llama causal P{p}: finite, " + ", ".join(
                  f"{key} {r[key]:.3e} <= {RING_TOL['llama'][key]:.1e}"
                  for key in r))
    log("ring: readings (largest error over the largest output) "
        + json.dumps(readings))
    del ref, b3, llama, outs, uly
    torch.cuda.empty_cache()

    # the cost of quantizing and merging: ring P = 1 beside B3 alone
    times = {}
    for mode, kw in RING_MODES.items():
        times[mode] = dict(
            ring_p1_ms=time_ms(lambda: ring_attention(q, k, v, mesh, **kw),
                               reps=5),
            b3_ms=time_ms(lambda: ka.quantized_attention(
                q, k, v, out_dtype=torch.float32, **b3_kw[mode]), reps=5))
    log("ring: FLUX ring P = 1 against B3 (CUDA events, ms) "
        + json.dumps(times))
    profile_step(torch, "FLUX ring int8_token P1",
                 lambda: ring_attention(q, k, v, mesh))
    profile_step(torch, "FLUX ring bf16 P1",
                 lambda: ring_attention(q, k, v, mesh, **RING_MODES["bf16"]))
    profile_step(torch, "FLUX ring int8_token P4 (one process)",
                 lambda: _local_ring(q, k, v, 4))
    del q, k, v, ql, kl, vl
    torch.cuda.empty_cache()
    return counts


def ring_slice_phase(torch, dev) -> dict:
    """The local ring at P = 2 on (1, 24, 2304, 128) in the default mode
    (int8 Q.K, token-mode P.V; blocks of 1152 keys on B9) against the same
    ring on B9's plain version, both on the card; returns {"max": the
    largest error over the largest output}."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.parallel.ring_attention import _local_ring

    g = torch.Generator(device=dev).manual_seed(55)
    q, k, v = (torch.randn(1, 24, 2304, 128, device=dev, generator=g)
               for _ in range(3))
    out = _local_ring(q, k, v, 2)
    reset_launch_counts()
    with plain_versions():
        ref = _local_ring(q, k, v, 2)
    launched = launch_counts()
    check(not any(launched.values()),
          "slice ring: the plain path launched no kernel "
          + json.dumps(launched))
    r = float((out - ref).abs().max() / ref.abs().max())
    check(r <= RING_SLICE_TOL and bool(torch.isfinite(out).all()),
          f"slice ring: local ring P = 2 with B9 vs its plain version rel "
          f"err {r:.3e} <= {RING_SLICE_TOL:.1e}")
    return {"max": r}


def pipeline_pp_path(torch, dev, stacked):
    """Phase 4p: ``pipeline_forward`` through a mesh of one on the card
    (create_mesh(fsdp=1), P = 1) over the stacked single-stream blocks of
    the int8 FLUX.1-dev model (the uniform stack after block 0), 2
    microbatches of (1, 4608, 3072) with ``vec`` and the 1024x1024 rope
    frequencies closed over: bit-equal to the stacked model's own loop
    over the same layer views.  Returns the launch counts of the pipeline
    run."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models import FLUX_DEV_CONFIG as cfg
    from sdnq_tpu_torch.models import dit as D
    from sdnq_tpu_torch.parallel import create_mesh, pipeline_forward

    blocks = stacked["single_transformer_blocks"]
    rest = blocks["rest"] if "rest" in blocks else blocks
    g = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn(2, 1, 4608, cfg.hidden_size, device=dev, generator=g)
    vec = torch.randn(1, cfg.hidden_size, device=dev, generator=g)
    freqs = D.make_rope_freqs(cfg, 512, (64, 64), device=dev)

    def block_fn(blk, h):
        return D._single_block(blk, h, vec, freqs, cfg, None)
    mesh = create_mesh(fsdp=1)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = pipeline_forward(block_fn, rest, x, mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    ref = []
    for h in x:
        for blk in D._block_list(rest):
            h = D._single_block(blk, h, vec, freqs, cfg, None)
        ref.append(h)
    ref = torch.stack(ref)
    layers = D._stack_len(rest)
    log(f"pipeline parallel: {layers} stacked single blocks x 2 "
        f"microbatches of (1, 4608, {cfg.hidden_size}) in {secs:.3f} s; "
        "launches " + json.dumps(counts))
    for name in ("quantize_rows", "scaled_gemm", "flash_attention"):
        check(counts[name] > 0, f"pipeline parallel path launched {name}")
    check(tuple(out.shape) == tuple(x.shape)
          and bool(torch.isfinite(out).all()),
          f"pipeline parallel output {tuple(out.shape)} finite")
    check(torch.equal(out, ref), "pipeline parallel: output equals the "
          "stacked model's own loop bit for bit (max diff "
          f"{float((out - ref).abs().max()):.3e})")
    return counts


# ---------------------------------------------------------------------------
# phases 4 and 5
# ---------------------------------------------------------------------------

def flux_config(depth=None):
    """FLUX.1-dev's config, at ``depth`` (double, single blocks) where
    given."""
    import dataclasses
    from sdnq_tpu_torch.models import FLUX_DEV_CONFIG
    if depth is None:
        return FLUX_DEV_CONFIG
    return dataclasses.replace(FLUX_DEV_CONFIG, depth_double=depth[0],
                               depth_single=depth[1])


def build_model(torch, dev, qconfig, label, depth=None):
    """FLUX.1-dev at full width and depth (or ``depth``), bf16 weights
    from a seeded generator on the card, quantized layer by layer with
    ``qconfig``; the bf16 model is freed afterwards."""
    from sdnq_tpu_torch import quantize_model
    from sdnq_tpu_torch.models.dit import init_dit

    t0 = time.perf_counter()
    params = init_dit(flux_config(depth), device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    qparams, _ = quantize_model(
        params, qconfig, arch="FluxTransformer2DModel", device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"{label}: FLUX.1-dev ({flux_config(depth).depth_double} + "
        f"{flux_config(depth).depth_single} blocks) weights built in "
        f"{t1 - t0:.1f} s, quantized "
        f"in {time.perf_counter() - t1:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return qparams


def denoise_path(torch, dev, qparams, label, requests, steps, required,
                 outputs=None, depth=None):
    """``flux_denoise`` at 1024x1024, 512 text tokens, guidance 3.5:
    ``requests`` requests of ``steps`` steps with the launch counts zeroed
    just before and read just after; every kernel in ``required`` (a count
    key, or a tuple of keys of which one must count) must have launched.
    Returns the counts; the latents are appended to ``outputs`` when it is
    a list.  ``depth``: the model's (double, single) blocks where cut."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.pipeline import flux_denoise

    cfg = flux_config(depth)
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
        alts = (name,) if isinstance(name, str) else name
        check(any(counts[a] > 0 for a in alts),
              f"{label} path launched {' or '.join(alts)}")
    for lat in outs:
        check(tuple(lat.shape) == (1, n_img, cfg.in_channels)
              and bool(torch.isfinite(lat).all()),
              f"{label} output {tuple(lat.shape)} finite")
    if requests > 1:
        check(not torch.equal(outs[0], outs[1]),
              f"{label}: requests differ by their noise")
    if outputs is not None:
        outputs.extend(outs)
    return counts


def stacked_path(torch, dev, qparams, list_out, required):
    """The driver's entry runs the stacked tree (``stack_dit_blocks``):
    stack the int8 quantized-matmul model, free the lists, and run 1 request
    x 4 steps on the stack and on the block lists rebuilt as views of the
    stacked storage (``unstack_dit_blocks``, no second copy).  The stacked
    output must equal the list model's (``list_out``, the same request
    before stacking) and the views' bit for bit: the same kernels on the
    same operands.  Then phase 4p (``pipeline_pp_path``) on the stack.
    Returns the stacked run's counts and the pipeline run's."""
    from sdnq_tpu_torch import QTensor
    from sdnq_tpu_torch.models.dit import stack_dit_blocks, unstack_dit_blocks
    from sdnq_tpu_torch.tensor import layer_count, layer_view

    t0 = time.perf_counter()
    stacked = stack_dit_blocks(qparams)
    qparams.clear()   # the caller's lists go: only the stack stays
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    views = unstack_dit_blocks(stacked)
    log(f"stacked: stack_dit_blocks in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card; "
        + json.dumps({k: (sorted(v) if isinstance(v, dict) else len(v))
                      for k, v in stacked.items()
                      if k.endswith("transformer_blocks")}))
    n_views = bad = 0

    def walk(tree):
        nonlocal n_views, bad
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, QTensor) and layer_count(tree) is not None:
            for i in range(layer_count(tree)):
                v = layer_view(tree, i)
                n_views += 1
                for a, b in ((v.qdata, tree.qdata), (v.scale, tree.scale)):
                    bad += not (a.is_contiguous() and a.data_ptr()
                                == b.data_ptr() + i * b.stride(0)
                                * b.element_size())
    for key in ("transformer_blocks", "single_transformer_blocks"):
        walk(stacked[key])
    check(n_views > 0 and bad == 0, f"stacked: {n_views} layer views, each "
          "contiguous at its layer's offset in the stacked storage")
    outs_s, outs_v = [], []
    counts = denoise_path(torch, dev, stacked, "stacked", 1, 4, required,
                          outs_s)
    denoise_path(torch, dev, views, "stacked_views", 1, 4, required, outs_v)
    for what, other in (("the list model", list_out),
                        ("the lists of views", outs_v[0])):
        diff = float((outs_s[0] - other).abs().max())
        check(torch.equal(outs_s[0], other),
              f"stacked: output equals that of {what} (max diff {diff:.3e})")
    return counts, pipeline_pp_path(torch, dev, stacked)


# The dynamic recipes' weights: each 2-D weight, in the model's order,
# redrawn at the init's std with its tail from this cycle (None:
# Gaussian; nu: Student-t), a stand-in for the outliers of real
# checkpoints, whose files are not in the repository.
DYN_LAWS = (None, 5, 3, 2)


def build_dynamic_model(torch, dev, qconfig, label, depth=None):
    """FLUX.1-dev at full width and depth (or ``depth``), bf16 weights
    from a seeded generator with tails (DYN_LAWS), quantized under
    ``qconfig`` with ``use_dynamic_quantization``.  Prints the format
    histogram, the quantize seconds and the GiB of the quantized model."""
    from sdnq_tpu_torch import QTensor, model_memory_footprint, quantize_model
    from sdnq_tpu_torch.models.dit import init_dit

    t0 = time.perf_counter()
    params = init_dit(flux_config(depth), device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(0))
    n = with_tails(torch, dev, params)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    qparams, cfg = quantize_model(
        params, qconfig, arch="FluxTransformer2DModel", device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))
    del params
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    torch.cuda.empty_cache()
    qbytes = 0

    def qsum(tree):
        nonlocal qbytes
        for v in (tree.values() if isinstance(tree, dict) else tree):
            if isinstance(v, (dict, list)):
                qsum(v)
            elif isinstance(v, QTensor):
                qbytes += v.nbytes()
    qsum(qparams)
    hist = {f: len(p) for f, p in sorted(cfg.modules_dtype_dict.items())}
    log(f"{label}: FLUX.1-dev ({flux_config(depth).depth_double} + "
        f"{flux_config(depth).depth_single} blocks) weights built with "
        f"tails in {t1 - t0:.1f} s "
        f"({n} 2-D weights), quantized dynamically in {t2 - t1:.1f} s; "
        f"format histogram {json.dumps(hist)}, "
        f"{sum(hist.values())} layers quantized, "
        f"{len(cfg.modules_to_not_convert)} skip keys and unquantized "
        f"layers, {len(cfg.modules_to_not_use_matmul)} not on the matmul; "
        f"quantized weights {qbytes / 2**30:.2f} GiB, model "
        f"{model_memory_footprint(qparams) / 2**30:.2f} GiB, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return qparams


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


def plain_block(q, k, v, *args, **kw):
    """B9's route (``flash_attention_block``) with the plain version in the
    kernel's place."""
    from sdnq_tpu_torch.kernels import attention as ka
    fn = (ka.flash_attention_block_plain
          if ka.block_kernel_route(q.shape[1], k.shape[1], q.shape[2])
          else ka.attention_block_xla)
    return fn(q, k, v, *args, **kw)


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
             (kd, "dequant_mm", kd.dequant_mm_plain),
             (kd, "groupdot_mm", kd.groupdot_mm_plain),
             (kd, "blockdiag_mm", kd.blockdiag_mm_plain),
             (kd, "groupdot_i8_mm", kd.groupdot_i8_mm_plain),
             (kd, "blockdiag_i8_mm", kd.blockdiag_i8_mm_plain),
             (ka, "flash_attention", ka.flash_attention_plain),
             (ka, "flash_attention_block", plain_block),
             (ks, "scaled_mm_tn", ks.scaled_mm_tn_plain)]
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
# with the quantized matmul: 1.08e-2, int8 activation codes again.  The
# dynamic recipes (weight-only, bf16 rounding alone): R1 6.09e-3, R2
# 6.43e-3; their weights have tails, so a few large outputs carry more
# of the output rounding than under Gaussian weights.  e5m2 weight-only
# (phase 4b's model): 2.07e-3.
SLICE_TOL = {"int8": 2e-2, "uint4_wo": 6e-3, "uint4_qmm": 2.2e-2,
             "dyn_r1": 1.2e-2, "dyn_r2": 1.3e-2, "e5m2": 4.5e-3}


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


def slice_phase(torch, dev, sliced, label) -> dict:
    """Kernel path against the all-plain path, both on the card, on a model
    cut by ``cut``; returns {"max": the largest error over the largest
    output}."""
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
    return {"max": rel}


# Limits of the LLM slice checks (2 of the 32 layers, kernels against plain
# versions on the card), each about twice its sound reading on the H100.
# Three readings, each over max |logit| of its step: "max", the largest
# error over the prefill logits (the first and the last 64 positions) and 4
# decode steps, or over the causal forward's logits; "decode_max", the same
# over the decode steps alone; "mean", the largest mean error of a step.
# The int8-KV attention kernel and its plain version agree to fp32 rounding
# (phase 3), so their bf16 outputs differ by one ulp at a few elements;
# where that ulp is a row's largest |x|, the next linear's per-row int8
# scale moves and with it every code of the row, so a few tokens' logits
# move by quantization steps: that sets "max", at prefill.  The mean error
# sees a fault that moves many tokens a little, the decode readings one that
# moves the cache.  The bf16 modes also round P against other maxima.
# Sound readings (max, decode_max, mean): int8 KV 2.34e-2, 6.8e-3, 1.36e-3;
# bf16 KV 5.00e-2, 9.6e-3, 3.8e-3; causal 4.93e-2 and mean 5.6e-3.
# Llama-3-8B's slice checks (phase 5)
LLM_LABELS = ("llm_int8kv", "llm_bf16kv", "llm_causal")
LLM_SLICE_TOL = {
    "llm_int8kv": {"max": 5e-2, "decode_max": 1.4e-2, "mean": 2.7e-3},
    "llm_bf16kv": {"max": 1e-1, "decode_max": 2e-2, "mean": 7.5e-3},
    "llm_causal": {"max": 1e-1, "mean": 1.12e-2},
    # OpenLLaMA-3B-v2's 2-layer slice (phase 4o), Llama-3-8B's limits: it
    # read 2.49e-2, 7.5e-3 and 1.10e-3
    "llm100_int8kv": {"max": 5e-2, "decode_max": 1.4e-2, "mean": 2.7e-3}}
# Limits of the training slice check (loss and every weight gradient of
# one step on 2 double + 2 single blocks, kernels against plain versions on
# the card), about twice the sound readings on the H100: "loss", the
# relative loss difference (1.65e-4); "grad_max", the largest over the
# parameters of a gradient's largest error over its largest entry
# (2.37e-2); "grad_mean", the largest mean error over mean |entry|
# (2.45e-2).  bf16 roundings that differ by an ulp flip int8 activation
# codes forward, and cotangent codes backward.
TRAIN_SLICE_TOL = {"loss": 3.5e-4, "grad_max": 5e-2, "grad_mean": 5e-2}


def cut_llm(params, cfg):
    """The first 2 layers of the model, and the matching config."""
    import dataclasses
    return (dict(params, layers=params["layers"][:2]),
            dataclasses.replace(cfg, num_layers=2))


def llm_slice_phase(torch, dev, sliced, label) -> dict:
    """Kernel path against the all-plain path on the 2-layer model: prefill
    of 4 x 896 tokens into a 1024-slot cache and 4 decode steps on fixed
    tokens (int8 or bf16 cache), or the causal forward of 2 x 1024 tokens;
    returns the readings named in LLM_SLICE_TOL."""
    import dataclasses
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models import init_cache, llm_forward

    params, cfg = sliced
    g = torch.Generator(device=dev).manual_seed(80)

    @torch.no_grad()
    def run():
        if label.endswith("causal"):
            ids = llm_prompts(torch, dev, cfg, 81, batch=2,
                              n=LLM_PROMPT + LLM_NEW)
            return [llm_forward(params, ids, cfg, device=dev)[0]]
        c = dataclasses.replace(cfg, kv_cache_dtype="int8"
                                if label.endswith("int8kv") else "bfloat16")
        caches = init_cache(c, LLM_BATCH, LLM_PROMPT + LLM_NEW, device=dev)
        logits, caches = llm_forward(params, llm_prompts(torch, dev, c, 82),
                                     c, caches=caches, device=dev)
        outs = [torch.cat((logits[:, :64], logits[:, -64:]), 1).float()]
        for s in range(4):
            tok = torch.randint(0, c.vocab_size, (LLM_BATCH, 1), device=dev,
                                generator=g.manual_seed(90 + s))
            logits, caches = llm_forward(
                params, tok, c, caches=caches, device=dev,
                positions=torch.full((LLM_BATCH, 1), LLM_PROMPT + s,
                                     device=dev))
            outs.append(logits.float())
        return outs

    out = run()
    reset_launch_counts()
    with plain_versions():
        ref = run()
    launched = launch_counts()
    check(not any(launched.values()),
          f"slice {label}: the plain path launched no kernel "
          + json.dumps(launched))
    errs = [(o.float() - r.float()).abs() / r.float().abs().max()
            for o, r in zip(out, ref)]
    readings = {"max": max(float(e.max()) for e in errs),
                "mean": max(float(e.mean()) for e in errs)}
    if len(errs) > 1:
        readings["decode_max"] = max(float(e.max()) for e in errs[1:])
    agree = min(float((o.argmax(-1) == r.argmax(-1)).float().mean())
                for o, r in zip(out, ref))
    log(f"slice {label}: 2 layers at full width (head dim {cfg.head_dim}), "
        f"kernels against plain versions; greedy tokens agree {agree:.3f} "
        "(worst step)")
    check(all(bool(torch.isfinite(o).all()) for o in out),
          f"slice {label}: logits finite")
    for key, tol in LLM_SLICE_TOL[label].items():
        check(readings[key] <= tol,
              f"slice {label}: kernel path vs plain path {key} err "
              f"{readings[key]:.3e} of max |logit| <= {tol:.2e}")
    return readings


# ---------------------------------------------------------------------------
# phase 4d: LLM serving, Llama-3-8B with int8 weights
# ---------------------------------------------------------------------------

LLM_BATCH, LLM_PROMPT, LLM_NEW = 4, 896, 128   # cache 1024: prefill on B3


def build_llm(torch, dev, cfg=None, label="llm"):
    """meta-llama/Meta-Llama-3-8B (or ``cfg``) at full width and depth,
    bf16 weights from a seeded generator, each layer quantized to int8
    (quantized matmul) as soon as it is drawn, so the 16 GB of bf16 never
    sit whole beside the int8 copy; embed_tokens and lm_head stay bf16
    under the policy (quant_embedding off; lm_head a common skip key)."""
    import dataclasses
    from sdnq_tpu_torch import QuantConfig, quantize_model
    from sdnq_tpu_torch.models import LLAMA3_8B_CONFIG, init_llm
    from sdnq_tpu_torch.models.llm import init_llm_layer

    cfg = cfg or LLAMA3_8B_CONFIG
    qc = QuantConfig(weights_dtype="int8", use_quantized_matmul=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    t0 = time.perf_counter()
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
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"{label}: {cfg.num_layers} layers of hidden {cfg.hidden_size}, "
        f"{cfg.num_heads} / {cfg.num_kv_heads} heads of {cfg.head_dim} built "
        f"and quantized layer by layer in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return params, cfg


def llm_prompts(torch, dev, cfg, seed, batch=None, n=None):
    """Random token ids (LLM_BATCH, LLM_PROMPT by default) from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size,
                         (batch or LLM_BATCH, n or LLM_PROMPT), device=dev,
                         generator=g)


def llm_path(torch, dev, params, cfg, label, kv, requests, required):
    """``generate`` for ``requests`` requests of LLM_BATCH prompts of
    LLM_PROMPT tokens and LLM_NEW new tokens, with the launch counts zeroed
    just before and read just after; then one prefill alone, timed and
    counted, for the prefill / decode split.  Returns the path's counts."""
    import dataclasses
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models import generate, init_cache, llm_forward

    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
    prompts = [llm_prompts(torch, dev, cfg, 40 + r) for r in range(requests)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    outs, times = [], []
    for ids in prompts:
        t1 = time.perf_counter()
        outs.append(generate(params, ids, cfg, max_new_tokens=LLM_NEW,
                             device=dev))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    reset_launch_counts()
    with torch.no_grad():
        caches = init_cache(cfg, LLM_BATCH, LLM_PROMPT + LLM_NEW, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        llm_forward(params, prompts[-1], cfg, caches=caches, device=dev)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
    per_prefill = launch_counts()
    decode_s = (times[-1] - prefill_s) / (LLM_NEW - 1)
    per_step = {k: (counts[k] / requests - per_prefill[k]) / (LLM_NEW - 1)
                for k in counts}
    log(f"{label}: {requests} requests of {LLM_BATCH} x {LLM_PROMPT} prompt "
        f"tokens + {LLM_NEW} new, KV cache {kv}, {cfg.num_layers} layers, "
        f"head dim {cfg.head_dim}")
    for r, tr in enumerate(times):
        log(f"{label}: request {r}: {tr:.3f} s, "
            f"{LLM_BATCH * LLM_NEW / tr:.1f} output tokens/s end to end")
    log(f"{label}: " + json.dumps({
        "prefill_ms": prefill_s * 1e3,
        "prefill_tokens_per_s": LLM_BATCH * LLM_PROMPT / prefill_s,
        "decode_ms_per_step": decode_s * 1e3,
        "output_tokens_per_s": LLM_BATCH / decode_s,
        "peak_gib": peak,
        "launches_per_prefill": {k: v for k, v in per_prefill.items() if v},
        "launches_per_decode_step": {k: v for k, v in per_step.items()
                                     if v}}))
    for name in required:
        check(counts[name] > 0, f"{label} path launched {name}")
    for toks in outs:
        check(tuple(toks.shape) == (LLM_BATCH, LLM_NEW)
              and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
              f"{label} tokens {tuple(toks.shape)} in the vocabulary")
    if requests > 1:
        check(not torch.equal(outs[0], outs[1]),
              f"{label}: requests differ by their prompts")
    return counts


def llm_causal_path(torch, dev, params, cfg, label, required):
    """The cache-free causal forward (scoring) of 2 x 1024 tokens."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models import llm_forward

    ids = llm_prompts(torch, dev, cfg, 50, batch=2, n=LLM_PROMPT + LLM_NEW)
    torch.cuda.synchronize()
    reset_launch_counts()
    t1 = time.perf_counter()
    with torch.no_grad():
        logits, _ = llm_forward(params, ids, cfg, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    counts = launch_counts()
    n = LLM_PROMPT + LLM_NEW
    log(f"{label}: 2 x {n} tokens scored in {dt * 1e3:.1f} ms, "
        f"{2 * n / dt:.0f} tokens/s; launches "
        + json.dumps({k: v for k, v in counts.items() if v}))
    for name in required:
        check(counts[name] > 0, f"{label} path launched {name}")
    check(tuple(logits.shape) == (2, LLM_PROMPT + LLM_NEW, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{label} logits {tuple(logits.shape)} finite")
    return counts


def decode_attention_ms(torch, dev):
    """The decode step's attention (``attention_xla``, plain torch, the JAX
    package's XLA route at N = 1) at Llama-3-8B's shape, int8 cache of
    1024 slots, per layer: CUDA-event time, printed (not a kernel)."""
    from sdnq_tpu_torch.kernels import attention as ka
    g = torch.Generator(device=dev).manual_seed(60)
    q = torch.randn(LLM_BATCH, 32, 1, 128, device=dev, generator=g)
    kq, ks, vq, vs = ka.quantize_kv(
        *(torch.randn(LLM_BATCH, 8, 1024, 128, device=dev, generator=g)
          for _ in range(2)))
    mask = (torch.arange(1024, device=dev) <= 900)[None, None, None]
    ms = time_ms(lambda: ka.quantized_attention(
        q, kq, vq, attn_mask=mask, kv_scales=(ks, vs),
        out_dtype=torch.bfloat16), reps=20)
    log(f"decode attention_xla (4 x 32 heads over 8, 1 x 1024, int8 cache):"
        f" {ms:.4f} ms per layer, {32 * ms:.2f} ms per step of 32 layers")


def b8_qlinear_check(torch, dev):
    """One uint4 layer at its auto group of 64 (2048 -> 8192) with the
    quantized matmul on 32 rows through ``qlinear``: the JAX route's B8
    domain.  Counts zeroed just before, read just after; B8 must launch and
    agree with ``blockdiag_i8_mm_plain`` on the same int8 rows (bit-equal
    expected: limit one bf16 ulp).  Returns (counts, rel err)."""
    import sdnq_tpu_torch as T
    from sdnq_tpu_torch.kernels import dequant_mm as kd
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.kernels.scaled_mm import quantize_rows_plain

    g = torch.Generator(device=dev).manual_seed(70)
    w = torch.randn(8192, 2048, device=dev, generator=g).bfloat16()
    x = torch.randn(32, 2048, device=dev, generator=g).bfloat16()
    qt = T.quantize_tensor(w, "uint4", use_quantized_matmul=True)
    reset_launch_counts()
    out = T.qlinear(x, qt)
    torch.cuda.synchronize()
    counts = launch_counts()
    xq, xs = quantize_rows_plain(x.float())[:2]
    s, zpc = kd._group_operands(qt.scale.reshape(8192, -1), qt.zero_point,
                                qt.meta.format)
    ref = kd.blockdiag_i8_mm_plain(xq, xs, qt.qdata, s, zpc, None, 4,
                                   out.dtype)
    err = float((out.float() - ref.float()).abs().max())
    rel = err / float(ref.float().abs().max())
    check(qt.meta.group_size == 64 and counts["blockdiag_i8_mm"] == 1,
          f"qlinear uint4 g{qt.meta.group_size} 32 x 2048 -> 8192 launched "
          f"B8 {counts['blockdiag_i8_mm']} time(s)")
    check(rel <= 2 ** -7, f"qlinear B8 vs blockdiag_i8_mm_plain rel err "
          f"{rel:.3e} <= {2 ** -7:.1e}")
    return counts, rel


# ---------------------------------------------------------------------------
# phase 4e: quantized training of FLUX.1-dev
# ---------------------------------------------------------------------------

# Depth of the FLUX models of the uint4 + SVD paths (weight-only and
# quantized matmul) and of the dynamic recipes R1 / R2, of 19 + 38: cut so
# that the default run, which phases 4m-4o and their faults lengthened
# by about 170 s, stays within its time (it read 833–1156 s at 10 + 19 as
# the host varied), then to 4 + 8 beside phases 4l and 4t's training cases
# (about 40 s less, their 30 s); their kernels and shapes are the full
# model's.
FLUX_CUT_DEPTH = (4, 8)

# Depth of the training model: AdamW training holds about 9 bytes per
# quantized weight (int8 code 1, fp32 gradient 4, two 8-bit moments with
# their group scales about 2.03, bf16 Kahan buffer 2), so the full 11.8 B
# quantized weights (19 + 38 blocks, about 106 GB) do not fit the card's
# 80 GB; 10 + 20 blocks hold 6.23 B (about 56 GB).  Cut to 5 + 10 so that
# the default run, which phases 4m-4o lengthened, stays within its time
# (the step's kernels and shapes are the full model's).
TRAIN_DEPTH = (5, 10)
TRAIN_SIDE, TRAIN_TXT = 512, 512          # 1024 image tokens, 512 text
TRAIN_STEPS = 3                           # timed, after one warm-up step
TRAIN_MEAN_OPTIMIZER_MS: dict = {}       # AdamW's, for phase 4n's log
TRAIN_REQUIRED = ("scaled_mm_tn", "scaled_gemm:nn", "quantize_rows:colscale",
                  "quantize_rows", "scaled_gemm", "dequant_gemv",
                  "flash_attention")


def train_config(depth=TRAIN_DEPTH):
    import dataclasses
    from sdnq_tpu_torch.models import FLUX_DEV_CONFIG
    return dataclasses.replace(FLUX_DEV_CONFIG, depth_double=depth[0],
                               depth_single=depth[1])


def build_train_model(torch, dev):
    """FLUX.1-dev at full width, TRAIN_DEPTH blocks, bf16 weights from a
    seeded generator, quantized to int8 with the quantized matmul under the
    Flux skip keys, then ``convert_model_to_training``."""
    from sdnq_tpu_torch import QuantConfig, quantize_model
    from sdnq_tpu_torch.models.dit import init_dit
    from sdnq_tpu_torch.train import TrainQTensor, convert_model_to_training
    from sdnq_tpu_torch.tree import tree_leaves

    cfg = train_config()
    t0 = time.perf_counter()
    params = init_dit(cfg, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(20))
    qparams, _ = quantize_model(
        params, QuantConfig(weights_dtype="int8", use_quantized_matmul=True),
        arch="FluxTransformer2DModel", device=dev)
    del params
    tparams = convert_model_to_training(qparams)
    del qparams
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    leaves = tree_leaves(tparams, is_leaf=lambda x: isinstance(
        x, TrainQTensor))
    n_q = sum(p.qt.qdata.numel() for p in leaves
              if isinstance(p, TrainQTensor))
    n_f = sum(p.numel() for p in leaves if isinstance(p, torch.Tensor))
    log(f"train: FLUX.1-dev {cfg.depth_double}+{cfg.depth_single} blocks "
        f"built, quantized and converted in {time.perf_counter() - t0:.1f} "
        f"s: {n_q / 1e9:.3f} B int8 weights, {n_f / 1e6:.1f} M bf16 "
        f"parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return tparams, cfg


def train_inputs(torch, dev, cfg, seed: int = 21, side: int = TRAIN_SIDE,
                 txt_len: int = TRAIN_TXT):
    """Batch 1 at 512x512 (1024 image tokens), 512 text tokens, guidance
    3.5, t and a target drawn from a seeded generator."""
    from sdnq_tpu_torch.models.dit import make_rope_freqs
    g = torch.Generator(device=dev).manual_seed(seed)
    hw = (side // 16, side // 16)
    n = hw[0] * hw[1]
    return dict(
        img=torch.randn(1, n, cfg.in_channels, device=dev, generator=g),
        txt=torch.randn(1, txt_len, cfg.txt_dim, device=dev, generator=g),
        pooled=torch.randn(1, cfg.vec_dim, device=dev, generator=g),
        t=torch.rand(1, device=dev, generator=g),
        guidance=torch.full((1,), 3.5, device=dev),
        target=torch.randn(1, n, cfg.in_channels, device=dev, generator=g),
        freqs=make_rope_freqs(cfg, txt_len, hw, device=dev))


def train_loss(params, cfg, inp, dev):
    """mean((dit_forward(...) - target)^2), the JAX package's training
    loss."""
    out = forward(params, cfg, inp, dev)
    return ((out.float() - inp["target"]) ** 2).mean()


def train_path(torch, dev, tparams, cfg):
    """One warm-up and TRAIN_STEPS timed AdamW steps (8-bit moments,
    stochastic rounding, Kahan), the counts zeroed just before the first
    and read after each; then one step traced.  Returns the counts over
    the steps and the optimizer state."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.optim import adamw
    from sdnq_tpu_torch.train import TrainQTensor
    from sdnq_tpu_torch.tree import tree_leaves

    inp = train_inputs(torch, dev, cfg)
    n_img = inp["img"].shape[1]
    opt = adamw(lr=1e-5, quantize_state=True, stochastic_rounding=True)
    t0 = time.perf_counter()
    state = opt.init(tparams)
    torch.cuda.synchronize()
    log(f"train: AdamW state built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    gen = torch.Generator(device=dev).manual_seed(22)
    qleaves = [p for p in tree_leaves(tparams, is_leaf=lambda x: isinstance(
        x, TrainQTensor)) if isinstance(p, TrainQTensor)]
    n_codes = sum(p.qt.qdata.numel() for p in qleaves)

    def step():
        loss = train_loss(tparams, cfg, inp, dev)
        loss.backward()
        opt.update(None, state, tparams, generator=gen)
        return loss

    reset_launch_counts()
    records = []
    for i in range(1 + TRAIN_STEPS):
        old = [p.qt.qdata.cpu() for p in qleaves]  # outside the timing
        before = launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t1 = time.perf_counter()
        ev[0].record()
        loss = train_loss(tparams, cfg, inp, dev)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.update(None, state, tparams, generator=gen)
        ev[3].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        moved = sum(int((p.qt.qdata != o.to(dev)).sum())
                    for p, o in zip(qleaves, old))
        del old
        fwd, bwd, upd = (ev[j].elapsed_time(ev[j + 1]) for j in range(3))
        rec = dict(step=i, warm_up=i == 0, loss=float(loss),
                   forward_ms=fwd, backward_ms=bwd, optimizer_ms=upd,
                   step_ms=fwd + bwd + upd, host_clock_ms=wall * 1e3,
                   image_tokens_per_s=n_img / (wall or 1e-9),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   codes_moved_share=moved / n_codes,
                   launches={k: v for k, v in launches.items() if v})
        log("train: " + json.dumps(rec))
        records.append(rec)
        del loss
        check(math.isfinite(rec["loss"]), f"train step {i}: loss "
              f"{rec['loss']:.6f} finite")
        check(rec["codes_moved_share"] > 0, f"train step {i}: the update "
              f"moved {rec['codes_moved_share']:.3e} of the weight codes")
        for name in TRAIN_REQUIRED:
            check(launches[name] > 0, f"train step {i} launched {name}")
        check(launches["scaled_gemm"] > launches["scaled_gemm:nn"],
              f"train step {i} launched B4 in its nt layout (the forward)")
    counts = launch_counts()
    timed = records[1:]
    log("train: " + json.dumps({
        "depth": list(TRAIN_DEPTH), "image_tokens": n_img,
        "text_tokens": TRAIN_TXT, "timed_steps": len(timed),
        "mean_step_ms": statistics.mean(r["step_ms"] for r in timed),
        "mean_forward_ms": statistics.mean(r["forward_ms"] for r in timed),
        "mean_backward_ms": statistics.mean(r["backward_ms"] for r in timed),
        "mean_optimizer_ms": TRAIN_MEAN_OPTIMIZER_MS.setdefault(
            "adamw", statistics.mean(r["optimizer_ms"] for r in timed)),
        "image_tokens_per_s": statistics.mean(r["image_tokens_per_s"]
                                              for r in timed),
        "peak_gib": max(r["peak_gib"] for r in records)}))
    profile_step(torch, "train", step, warm=0, after=0)
    return counts, state


def cut_train(tparams):
    """The first 2 double + 2 single blocks of the training model, and the
    matching config."""
    return (dict(tparams,
                 transformer_blocks=tparams["transformer_blocks"][:2],
                 single_transformer_blocks=tparams[
                     "single_transformer_blocks"][:2]),
            train_config((2, 2)))


def train_slice_phase(torch, dev, sliced) -> dict:
    """One training step's loss and weight gradients through the kernels
    against the all-plain path, both on the card."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.train import extract_weight_grads
    from sdnq_tpu_torch.tree import tree_leaves

    params, cfg = sliced
    inp = train_inputs(torch, dev, cfg, seed=23)

    def run():
        loss = train_loss(params, cfg, inp, dev)
        loss.backward()
        grads = [g for g in tree_leaves(extract_weight_grads(params))
                 if g is not None]
        for leaf in tree_leaves(params, is_leaf=lambda x: hasattr(x, "qt")):
            holder = leaf.delta if hasattr(leaf, "qt") else leaf
            if isinstance(holder, torch.Tensor):
                holder.grad = None
        return float(loss), grads

    loss, grads = run()
    reset_launch_counts()
    with plain_versions():
        ref_loss, ref_grads = run()
    launched = launch_counts()
    check(not any(launched.values()),
          "slice train: the plain path launched no kernel "
          + json.dumps(launched))
    readings = {
        "loss": abs(loss - ref_loss) / abs(ref_loss),
        "grad_max": max(float((g.float() - r.float()).abs().max()
                              / r.float().abs().max().clamp_min(1e-30))
                        for g, r in zip(grads, ref_grads)),
        "grad_mean": max(float((g.float() - r.float()).abs().mean()
                               / r.float().abs().mean().clamp_min(1e-30))
                         for g, r in zip(grads, ref_grads))}
    del grads, ref_grads
    log(f"slice train: 2 double + 2 single blocks at full width, one step's "
        f"loss ({loss:.6f} / {ref_loss:.6f}) and weight gradients, kernels "
        "against plain versions: " + json.dumps(readings))
    check(math.isfinite(loss), "slice train: loss finite")
    for key, tol in TRAIN_SLICE_TOL.items():
        check(readings[key] <= tol, f"slice train: kernel path vs plain "
              f"path {key} {readings[key]:.3e} <= {tol:.1e}")
    return readings


# ---------------------------------------------------------------------------
# phase 4f: FLUX text to image (T5-XXL, CLIP-L, the DiT, the VAE)
# ---------------------------------------------------------------------------

PIPE_SIDE, PIPE_STEPS = 1024, 4          # 4096 image tokens, 4 Euler steps
PIPE_T5, PIPE_CLIP = 512, 77             # token ids per request
PIPE_REQUIRED = ("dequant_mm:grouped", "dequant_mm:row",
                 "decode_weight:grouped", "decode_weight:row",
                 "wgmma_mm:bias", "wgmma_mm:row",
                 "dequant_gemv:grouped", "flash_attention:float_mask",
                 "flash_attention")


def default_recipe():
    """SDNQ's default recipe: int8 weights, every other field at its
    default (weight-only, auto groups of 1024 along K).  A fresh config for
    each call: ``quantize_model`` adds the architecture's skip keys to the
    config it is given."""
    from sdnq_tpu_torch import QuantConfig
    return QuantConfig(weights_dtype="int8")


def flux_vae_config():
    """black-forest-labs/FLUX.1-dev vae/config.json: 16 latent channels,
    block_out (128, 256, 512, 512), 2 layers a block, 32 groups, scaling
    0.3611 (its shift factor 0.1159 has no field: the JAX package has
    none)."""
    from sdnq_tpu_torch.models import VAEConfig
    return VAEConfig(latent_channels=16, scaling_factor=0.3611)


def build_pipeline(torch, dev):
    """T5-XXL (google/t5-v1_1-xxl) and CLIP-L (openai/clip-vit-large-
    patch14's text model) from seeded generators in bf16, quantized with
    the default recipe, T5 layer by layer; T5's ``shared`` table (an
    nn.Embedding in transformers) and CLIP's embeddings stay bf16
    (quant_embedding off); the FLUX VAE stays bf16 (quant_conv off).  With
    the DiT from ``build_model`` under the same recipe.  Returns (models,
    configs)."""
    import dataclasses
    from sdnq_tpu_torch import quantize_model
    from sdnq_tpu_torch.models import (
        FLUX_DEV_CONFIG, CLIPConfig, T5Config, init_clip, init_t5,
        init_t5_layer, init_vae)
    dit = build_model(torch, dev, default_recipe(), "pipeline")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(30)
    t5cfg, clipcfg, vaecfg = T5Config(), CLIPConfig(), flux_vae_config()
    t5, _ = quantize_model(
        init_t5(dataclasses.replace(t5cfg, num_layers=0), generator=gen,
                device=dev, dtype=torch.bfloat16), default_recipe(),
        kinds={"shared": "embedding"}, device=dev)
    for _ in range(t5cfg.num_layers):
        layer = init_t5_layer(t5cfg, generator=gen, device=dev,
                              dtype=torch.bfloat16)
        q, _ = quantize_model({"block": [layer]}, default_recipe(),
                              device=dev)
        t5["block"].append(q["block"][0])
        del layer, q
    clip, _ = quantize_model(
        init_clip(clipcfg, generator=gen, device=dev, dtype=torch.bfloat16),
        default_recipe(), device=dev)
    vae = init_vae(vaecfg, generator=gen, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"pipeline: T5-XXL ({t5cfg.num_layers} layers), CLIP-L "
        f"({clipcfg.num_layers}) and the FLUX VAE built and quantized in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return (dict(dit=dit, t5=t5, clip=clip, vae=vae),
            dict(dit=FLUX_DEV_CONFIG, t5=t5cfg, clip=clipcfg, vae=vaecfg))


def pipeline_ids(torch, dev, cfgs, seed):
    """Random T5 and CLIP token ids (no tokenizer) from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randint(0, cfgs["t5"].vocab_size, (1, PIPE_T5),
                          device=dev, generator=g),
            torch.randint(0, cfgs["clip"].vocab_size, (1, PIPE_CLIP),
                          device=dev, generator=g))


def pipeline_request(torch, dev, models, cfgs, ids, seed, side=PIPE_SIDE,
                     steps=PIPE_STEPS, mark=None):
    """One request through the user's entry points: ``t5_encode``,
    ``clip_encode`` (its pooled vector), ``flux_generate`` (noise from a
    generator seeded ``seed``, guidance 3.5).  ``mark(stage)`` is called
    after each stage.  Returns (T5 states, image)."""
    from sdnq_tpu_torch.models import clip_encode, t5_encode
    from sdnq_tpu_torch.pipeline import flux_generate
    mark = mark or (lambda stage: None)
    with torch.no_grad():
        txt = t5_encode(models["t5"], ids[0], cfgs["t5"], device=dev)
        mark("t5")
        _, pooled = clip_encode(models["clip"], ids[1], cfgs["clip"],
                                device=dev)
        mark("clip")
        image = flux_generate(
            models["dit"], models["vae"], txt, pooled, dit_cfg=cfgs["dit"],
            vae_cfg=cfgs["vae"], steps=steps, height=side, width=side,
            guidance=3.5, generator=torch.Generator(device=dev).manual_seed(
                seed), device=dev)
        mark("generate")
    return txt, image


def pipeline_path(torch, dev, models, cfgs, resident, requests=2):
    """``requests`` text-to-image requests at 1024x1024 with the launch
    counts zeroed just before and read just after; CUDA events split each
    request into T5, CLIP and ``flux_generate``, and one ``vae_decode``
    timed alone splits the last into the Euler steps and the VAE.  The
    peak memory is also given above ``resident``, the bytes that earlier
    phases left allocated.  Every kernel mode in PIPE_REQUIRED must have
    launched.  Returns the counts."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models import vae_decode

    ids = [pipeline_ids(torch, dev, cfgs, 300 + r) for r in range(requests)]
    n_img = (PIPE_SIDE // 16) ** 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    recs, images = [], []
    for r in range(requests):
        ev, seen = {}, {}

        def mark(stage):
            ev[stage] = torch.cuda.Event(enable_timing=True)
            ev[stage].record()
            seen[stage] = launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mark("start")
        _, image = pipeline_request(torch, dev, models, cfgs, ids[r],
                                    500 + r, mark=mark)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        images.append(image)
        stages = ("start", "t5", "clip", "generate")
        rec = {f"{b}_ms": ev[a].elapsed_time(ev[b])
               for a, b in zip(stages, stages[1:])}
        rec["launches"] = {b: {k: seen[b][k] - seen[a][k] for k in seen[b]
                               if seen[b][k] - seen[a][k]}
                           for a, b in zip(stages, stages[1:])}
        rec["seconds_per_image"] = wall
        recs.append(rec)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    resident /= 2**30
    # the VAE alone, on a latent of the request's shape
    lat = torch.randn(1, PIPE_SIDE // 8, PIPE_SIDE // 8,
                      cfgs["vae"].latent_channels, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(9))
    with torch.no_grad():
        vae_ms = time_ms(lambda: vae_decode(models["vae"], lat, cfgs["vae"],
                                            device=dev), reps=2, warmup=1)
    del lat
    for r, rec in enumerate(recs):
        step_ms = (rec["generate_ms"] - vae_ms) / PIPE_STEPS
        rec.update(vae_ms=vae_ms, ms_per_step=step_ms,
                   image_tokens_per_s=n_img / step_ms * 1e3)
        log(f"pipeline: request {r}: " + json.dumps(rec))
    log("pipeline: " + json.dumps({
        "requests": requests, "image_tokens": n_img, "steps": PIPE_STEPS,
        "t5_tokens": PIPE_T5, "clip_tokens": PIPE_CLIP,
        "t5_ms": statistics.mean(r["t5_ms"] for r in recs),
        "clip_ms": statistics.mean(r["clip_ms"] for r in recs),
        "ms_per_step": statistics.mean(r["ms_per_step"] for r in recs),
        "vae_ms": vae_ms,
        "seconds_per_image": statistics.mean(r["seconds_per_image"]
                                             for r in recs),
        "image_tokens_per_s": statistics.mean(r["image_tokens_per_s"]
                                              for r in recs),
        "peak_gib": peak, "peak_above_earlier_phases_gib": peak - resident,
        "launches": {k: v for k, v in counts.items() if v}}))
    for name in PIPE_REQUIRED:
        check(counts[name] > 0, f"pipeline path launched {name}")
    for image in images:
        check(tuple(image.shape) == (1, PIPE_SIDE, PIPE_SIDE, 3)
              and bool(torch.isfinite(image).all()),
              f"pipeline image {tuple(image.shape)} finite")
    if requests > 1:
        check(not torch.equal(images[0], images[1]),
              "pipeline: requests differ by their ids and noise")
    return counts


def pipeline_profile_phase(torch, dev, models, cfgs):
    """One text-to-image request, traced."""
    ids = pipeline_ids(torch, dev, cfgs, 600)
    profile_step(torch, "pipeline request", lambda: pipeline_request(
        torch, dev, models, cfgs, ids, 601), warm=0, after=1)


# Limits of the pipeline slice check (T5 and CLIP cut to 2 layers, the DiT
# to 1 double + 2 single blocks, the VAE whole; 2 Euler steps at 512x512,
# kernels against the all-plain path on the card): "t5", the T5 states'
# largest error over their largest entry; "image", the same over the image.
# About twice the sound readings on the H100, 1.24e-2 and 3.26e-3: the
# weight-only products sum in another order and round their bf16 outputs
# differently, which the bf16 residual stream of T5 carries on.
PIPE_SLICE_TOL = {"t5": 2.5e-2, "image": 7e-3}


def cut_pipeline(models, cfgs):
    """The first 2 layers of T5 and CLIP, 1 + 2 blocks of the DiT (``cut``),
    the VAE whole, and the matching configs."""
    import dataclasses
    dit, dcfg = cut(models["dit"])
    return (dict(dit=dit, vae=models["vae"],
                 t5=dict(models["t5"], block=models["t5"]["block"][:2]),
                 clip=dict(models["clip"],
                           layers=models["clip"]["layers"][:2])),
            dict(dit=dcfg, vae=cfgs["vae"],
                 t5=dataclasses.replace(cfgs["t5"], num_layers=2),
                 clip=dataclasses.replace(cfgs["clip"], num_layers=2)))


def pipeline_slice_phase(torch, dev, sliced) -> dict:
    """One request of the cut pipeline at 512x512 with 2 Euler steps
    through the kernels against the all-plain path, both on the card."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    models, cfgs = sliced
    ids = pipeline_ids(torch, dev, cfgs, 400)

    def run():
        return pipeline_request(torch, dev, models, cfgs, ids, 401,
                                side=512, steps=2)
    txt, image = run()
    reset_launch_counts()
    with plain_versions():
        rtxt, rimage = run()
    launched = launch_counts()
    check(not any(launched.values()),
          "slice pipeline: the plain path launched no kernel "
          + json.dumps(launched))
    readings = {k: float((a.float() - b.float()).abs().max()
                         / b.float().abs().max())
                for k, a, b in (("t5", txt, rtxt), ("image", image, rimage))}
    log("slice pipeline: T5 and CLIP 2 layers, the DiT 1 + 2 blocks, the "
        "VAE whole, 2 steps at 512x512, kernels against plain versions: "
        + json.dumps(readings))
    check(bool(torch.isfinite(image).all()), "slice pipeline: image finite")
    for key, tol in PIPE_SLICE_TOL.items():
        check(readings[key] <= tol, f"slice pipeline: kernel path vs plain "
              f"path {key} {readings[key]:.3e} <= {tol:.1e}")
    return readings


# ---------------------------------------------------------------------------
# phase 4i: model files, streamed and quantized on the card, and fit's
# checkpoints
# ---------------------------------------------------------------------------

IO_FLUX_DEPTH = (2, 4)         # of 19 + 38: 2.6 GB of bf16 to write
IO_LLM_LAYERS = 2              # of 32: 3.0 GB of bf16, most of it the
IO_LLM_PROMPT, IO_LLM_NEW = 128, 8   # embedding and the head
IO_TRAIN_DEPTH = (2, 2)
# the sources of the kernels phase 4i's paths launch (``--phase-4i``)
IO_SOURCES = ("quantize_rows", "scaled_mm", "dequant_gemv", "flash_attn",
              "scaled_mm_tn")
IO_FLUX_REQUIRED = ("quantize_rows", "scaled_gemm", "dequant_gemv",
                    "flash_attention")
IO_LLM_REQUIRED = ("quantize_rows", "scaled_gemm", "dequant_gemv",
                   "flash_attention:causal")
# free disk a part needs, as a multiple of the bytes it writes at most
IO_DISK_MARGIN = 1.25


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _is_node(x) -> bool:
    from sdnq_tpu_torch.optim.base import BufferQ
    from sdnq_tpu_torch.tensor import QTensor
    from sdnq_tpu_torch.train import TrainQTensor
    return isinstance(x, (QTensor, TrainQTensor, BufferQ))


def _arrays(leaf):
    """(name, tensor) of a leaf's tensors: a tensor, a QTensor's fields, a
    TrainQTensor's (not its gradient carrier), a BufferQ's; none of a
    scalar or None."""
    import torch
    if isinstance(leaf, torch.Tensor):
        return [("", leaf)]
    if not _is_node(leaf):
        return []
    if hasattr(leaf, "delta"):
        leaf = leaf.qt
    names = (("qdata", "scale", "zero_point", "svd_up", "svd_down")
             if hasattr(leaf, "meta") else ("qdata", "scale"))
    return [(n, getattr(leaf, n)) for n in names
            if getattr(leaf, n) is not None]


def tree_bytes(tree) -> int:
    from sdnq_tpu_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size()
               for leaf in tree_leaves(tree, is_leaf=_is_node)
               for _, t in _arrays(leaf))


def tree_mismatches(got, want) -> list[str]:
    """Paths where two trees differ: structure, a QTensor's meta, a
    BufferQ's shape, a scalar, or any tensor's dtype, shape or bits."""
    import torch
    from sdnq_tpu_torch.tree import tree_leaves_with_paths
    fg = tree_leaves_with_paths(got, is_leaf=_is_node)
    fw = tree_leaves_with_paths(want, is_leaf=_is_node)
    if [p for p, _ in fg] != [p for p, _ in fw]:
        return ["<structure>"]
    bad = []
    for (path, g), (_, w) in zip(fg, fw):
        if type(g) is not type(w):
            bad.append(path)
            continue
        if not isinstance(w, torch.Tensor) and not _is_node(w):
            if g != w:
                bad.append(path)
            continue
        if getattr(getattr(w, "qt", w), "meta", None) != getattr(
                getattr(g, "qt", g), "meta", None) or getattr(
                w, "shape", None) != getattr(g, "shape", None):
            bad.append(path)
            continue
        ag, aw = _arrays(g), _arrays(w)
        if [n for n, _ in ag] != [n for n, _ in aw] or not all(
                bits_equal(x, y) for (_, x), (_, y) in zip(ag, aw)):
            bad.append(path)
    return bad


def bits_equal(x, y) -> bool:
    """Same dtype, shape and bits (``y`` brought to ``x``'s device)."""
    import torch
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    y = y.to(x.device)
    if x.is_floating_point():
        view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[x.element_size()]
        x, y = x.detach().view(view), y.detach().view(view)
    return bool(torch.equal(x, y))


def io_rate(what: str, nbytes: int, secs: float, card: str) -> dict:
    rec = {"what": what, "bytes": nbytes, "seconds": secs,
           "gb_per_s": nbytes / secs / 1e9 if secs else None, "card": card}
    log("io: " + json.dumps(rec))
    return rec


def log_files(path) -> None:
    """The size of each file under ``path``."""
    for root, _, names in os.walk(path):
        for name in sorted(names):
            f = os.path.join(root, name)
            log(f"io file: {os.path.relpath(f, os.path.dirname(path))} "
                f"{os.path.getsize(f)} bytes")


def disk_check(path, need: int, what: str) -> None:
    """Fail the run, never skip, where the disk under ``path`` lacks
    IO_DISK_MARGIN times the ``need`` bytes."""
    import shutil
    free = shutil.disk_usage(path).free
    ok = free >= IO_DISK_MARGIN * need
    check(ok, f"io {what}: {free / 1e9:.1f} GB free under {path} for "
          f"{need / 1e9:.2f} GB to write (x{IO_DISK_MARGIN})")
    if not ok:
        raise RuntimeError(f"phase 4i: too little disk for {what}")


def diffusers_flux_state(params, cfg) -> dict:
    """The DiT tree in diffusers' FluxTransformer2DModel keys: qkv and
    linear1 split into to_q / to_k / to_v (and proj_mlp), norm_out as
    [scale, shift]: the inverse of ``io.keymaps.fuse_flux_params``.  The
    tensors are views of the tree's."""
    import torch
    d = cfg.hidden_size
    mlp = int(d * cfg.mlp_ratio)
    sd = {}

    def emit(stem, p):
        for leaf in ("weight", "bias"):
            if leaf in p:
                sd[f"{stem}.{leaf}"] = p[leaf]

    def split(p, sizes):
        out, o = [], 0
        for s in sizes:
            out.append({k: v[o:o + s] for k, v in p.items()})
            o += s
        return out

    for stem in ("x_embedder", "context_embedder", "proj_out"):
        emit(stem, params[stem])
    for ours, theirs in (("time_in", "timestep_embedder"),
                         ("vector_in", "text_embedder"),
                         ("guidance_in", "guidance_embedder")):
        if ours in params:
            emit(f"time_text_embed.{theirs}.linear_1", params[ours]["fc1"])
            emit(f"time_text_embed.{theirs}.linear_2", params[ours]["fc2"])
    emit("norm_out.linear", {k: torch.cat([v[d:], v[:d]]) for k, v in
                             params["norm_out"]["linear"].items()})
    for i, blk in enumerate(params["transformer_blocks"]):
        pre = f"transformer_blocks.{i}"
        emit(f"{pre}.norm1.linear", blk["img_mod"]["linear"])
        emit(f"{pre}.norm1_context.linear", blk["txt_mod"]["linear"])
        for attn, names, nq, nk, out in (
                ("img_attn", ("to_q", "to_k", "to_v"), "norm_q", "norm_k",
                 "to_out.0"),
                ("txt_attn", ("add_q_proj", "add_k_proj", "add_v_proj"),
                 "norm_added_q", "norm_added_k", "to_add_out")):
            for n, p in zip(names, split(blk[attn]["qkv"], [d, d, d])):
                emit(f"{pre}.attn.{n}", p)
            emit(f"{pre}.attn.{nq}", blk[attn]["norm_q"])
            emit(f"{pre}.attn.{nk}", blk[attn]["norm_k"])
            emit(f"{pre}.attn.{out}", blk[attn]["proj"])
        emit(f"{pre}.ff.net.0.proj", blk["img_mlp"]["fc1"])
        emit(f"{pre}.ff.net.2", blk["img_mlp"]["fc2"])
        emit(f"{pre}.ff_context.net.0.proj", blk["txt_mlp"]["fc1"])
        emit(f"{pre}.ff_context.net.2", blk["txt_mlp"]["fc2"])
    for i, blk in enumerate(params["single_transformer_blocks"]):
        pre = f"single_transformer_blocks.{i}"
        emit(f"{pre}.norm.linear", blk["norm"]["linear"])
        for n, p in zip(("attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp"),
                        split(blk["linear1"], [d, d, d, mlp])):
            emit(f"{pre}.{n}", p)
        emit(f"{pre}.attn.norm_q", blk["norm_q"])
        emit(f"{pre}.attn.norm_k", blk["norm_k"])
        emit(f"{pre}.proj_out", blk["linear2"])
    return sd


def flux_hf_config(cfg) -> dict:
    """The fields of diffusers' transformer/config.json that
    ``flux_config_from_hf`` reads."""
    return {"_class_name": "FluxTransformer2DModel",
            "in_channels": cfg.in_channels,
            "num_attention_heads": cfg.num_heads,
            "attention_head_dim": cfg.hidden_size // cfg.num_heads,
            "num_layers": cfg.depth_double,
            "num_single_layers": cfg.depth_single,
            "joint_attention_dim": cfg.txt_dim,
            "pooled_projection_dim": cfg.vec_dim,
            "axes_dims_rope": list(cfg.axes_dims),
            "guidance_embeds": cfg.guidance_embed}


def write_sharded(state: dict, path, shards: int = 2) -> int:
    """``state`` over ``shards`` files of about equal bytes, named as
    diffusers names them, with its index; returns the bytes."""
    from sdnq_tpu_torch.io._safetensors import INDEX_NAMES, save_file
    keys = sorted(state)
    sizes = [state[k].numel() * state[k].element_size() for k in keys]
    total, acc, groups = sum(sizes), 0, [[] for _ in range(shards)]
    for k, s in zip(keys, sizes):
        groups[min(shards - 1, int(acc * shards / max(total, 1)))].append(k)
        acc += s
    weight_map = {}
    for i, ks in enumerate(groups):
        name = f"diffusion_pytorch_model-{i + 1:05d}-of-{shards:05d}" \
               ".safetensors"
        save_file({k: state[k] for k in ks}, os.path.join(path, name))
        weight_map.update({k: name for k in ks})
    with open(os.path.join(path, INDEX_NAMES[1]), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    return total


def llama_hf_config(cfg) -> dict:
    """transformers' LlamaConfig fields of meta-llama/Meta-Llama-3-8B's
    config.json, with the model's layer count."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.ff_dim,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": 1e-5, "max_position_embeddings": 8192,
            "tie_word_embeddings": cfg.tie_embeddings,
            "torch_dtype": "bfloat16"}


def transformers_llama_state(params) -> dict:
    """The LLM tree in transformers' LlamaForCausalLM keys."""
    from sdnq_tpu_torch.tree import tree_leaves_with_paths
    return {(p if p.startswith("lm_head.") else "model." + p): t
            for p, t in tree_leaves_with_paths(params)}


def io_flux_part(torch, dev, tmp, card, cfg, side=1024, txt_len=512,
                 required=IO_FLUX_REQUIRED) -> dict:
    """FLUX.1-dev in diffusers' layout: written, streamed and quantized by
    ``load_flux`` on the card, bit-equal to ``quantize_model`` of the tree
    in memory, before and after ``save_quantized`` / ``load_quantized``;
    then the native reader and the packed transfer.  Returns the launch
    counts of the loaded model's forward."""
    from sdnq_tpu_torch import QuantConfig, quantize_model
    from sdnq_tpu_torch.io import (load_flux, load_quantized, save_quantized,
                                   stream_state_dict)
    from sdnq_tpu_torch.io._safetensors import checkpoint_files, load_file
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models.dit import init_dit
    from sdnq_tpu_torch.native import fast_load_safetensors
    from sdnq_tpu_torch.tree import tree_leaves
    from sdnq_tpu_torch.utils.transfer import device_put_packed

    qc = dict(weights_dtype="int8", use_quantized_matmul=True)
    params = init_dit(cfg, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(40))
    hf = os.path.join(tmp, "flux")
    os.makedirs(hf)
    state = diffusers_flux_state(params, cfg)
    disk_check(tmp, 2 * tree_bytes(state), "FLUX")
    t0 = time.perf_counter()
    nbytes = write_sharded(state, hf)
    io_rate("FLUX.1-dev bf16, diffusers layout, 2 shards: write", nbytes,
            time.perf_counter() - t0, card)
    del state
    with open(os.path.join(hf, "config.json"), "w") as f:
        json.dump(flux_hf_config(cfg), f)
    log_files(hf)

    t0 = time.perf_counter()
    for _ in stream_state_dict(hf):
        pass
    io_rate("FLUX.1-dev: the two shards read alone (stream_state_dict)",
            nbytes, time.perf_counter() - t0, card)
    _sync(torch)
    t0 = time.perf_counter()
    loaded, lcfg, _ = load_flux(hf, QuantConfig(**qc), device=dev)
    _sync(torch)
    io_rate("FLUX.1-dev: load_flux (stream, fuse, quantize int8)", nbytes,
            time.perf_counter() - t0, card)
    check(lcfg == cfg, "io FLUX: config.json read back as the model's")
    t0 = time.perf_counter()
    direct, _ = quantize_model(params, QuantConfig(**qc),
                               arch="FluxTransformer2DModel", device=dev)
    _sync(torch)
    io_rate("FLUX.1-dev: quantize_model of the tree in memory", nbytes,
            time.perf_counter() - t0, card)
    del params
    bad = tree_mismatches(loaded, direct)
    check(not bad, f"io FLUX: load_flux bit-equal to quantize_model in "
          f"memory ({len(bad)} leaves differ: {bad[:3]})")

    inp = dit_inputs(torch, dev, cfg, side=side, txt_len=txt_len)
    want = forward(direct, cfg, inp, dev)
    del direct
    _sync(torch)
    reset_launch_counts()
    got = forward(loaded, cfg, inp, dev)
    _sync(torch)
    counts = launch_counts()
    check(bits_equal(got, want), "io FLUX: the loaded model's forward at "
          f"{side}x{side} with {txt_len} text tokens bit-equal to the "
          "in-memory model's")
    check(bool(torch.isfinite(got).all()), "io FLUX: forward finite")
    for name in required:
        check(counts[name] > 0, f"io FLUX: the forward launched {name}")

    qdir = os.path.join(tmp, "flux_int8")
    qbytes = tree_bytes(loaded)
    disk_check(tmp, qbytes, "FLUX int8")
    _sync(torch)
    t0 = time.perf_counter()
    save_quantized(loaded, qdir, QuantConfig(**qc))
    io_rate("FLUX.1-dev int8: save_quantized", qbytes,
            time.perf_counter() - t0, card)
    log_files(qdir)
    t0 = time.perf_counter()
    again, qcfg = load_quantized(qdir, device=dev)
    _sync(torch)
    io_rate("FLUX.1-dev int8: load_quantized", qbytes,
            time.perf_counter() - t0, card)
    bad = tree_mismatches(again, loaded)
    check(not bad and qcfg.weights_dtype == "int8",
          f"io FLUX: save_quantized / load_quantized bit-equal "
          f"({len(bad)} leaves differ: {bad[:3]})")
    check(bits_equal(forward(again, cfg, inp, dev), want),
          "io FLUX: the forward after load_quantized bit-equal")
    del again

    shard = checkpoint_files(hf)[0]
    t0 = time.perf_counter()
    plain = load_file(shard)
    t_plain = time.perf_counter() - t0
    sbytes = tree_bytes(plain)
    io_rate("FLUX shard 1: the port's reader (one thread)", sbytes, t_plain,
            card)
    for target, what in (("cpu", "pageable"), (dev, "pinned")):
        t0 = time.perf_counter()
        native = fast_load_safetensors(shard, device=target)
        io_rate(f"FLUX shard 1: fast_load_safetensors (native threads, "
                f"{what})", sbytes, time.perf_counter() - t0, card)
    check(not tree_mismatches(native, plain),
          "io FLUX: fast_load_safetensors gives the reader's bytes")
    _sync(torch)
    t0 = time.perf_counter()
    moved = device_put_packed(native, dev)
    _sync(torch)
    io_rate("FLUX shard 1: device_put_packed", sbytes,
            time.perf_counter() - t0, card)
    check(not tree_mismatches(moved, plain), "io FLUX: device_put_packed of "
          "the shard bit-equal")
    del plain, native, moved
    host = device_put_packed(loaded, "cpu")
    _sync(torch)
    t0 = time.perf_counter()
    moved = device_put_packed(host, dev)
    _sync(torch)
    io_rate("FLUX.1-dev int8 tree: device_put_packed", qbytes,
            time.perf_counter() - t0, card)
    check(not tree_mismatches(moved, loaded) and all(
        t.device == torch.device(dev)
        for leaf in tree_leaves(moved, is_leaf=_is_node)
        for _, t in _arrays(leaf)),
        "io FLUX: device_put_packed of the int8 tree bit-equal on the card")
    return counts


def io_llama_part(torch, dev, tmp, card, cfg, prompt=IO_LLM_PROMPT,
                  new=IO_LLM_NEW, required=IO_LLM_REQUIRED) -> dict:
    """Llama-3-8B in transformers' layout: written, streamed and quantized
    by ``load_llama`` on the card, bit-equal to ``quantize_model`` of the
    tree in memory; ``generate`` of 2 prompts gives the same tokens and
    the causal forward bit-equal logits.  Returns the launch counts of
    the loaded model's ``generate`` and forward."""
    from sdnq_tpu_torch import QuantConfig, quantize_model
    from sdnq_tpu_torch.io import load_llama
    from sdnq_tpu_torch.io._safetensors import save_file
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models import generate, init_llm, llm_forward

    qc = dict(weights_dtype="int8", use_quantized_matmul=True)
    params = init_llm(cfg, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(41))
    hf = os.path.join(tmp, "llama")
    os.makedirs(hf)
    state = transformers_llama_state(params)
    nbytes = tree_bytes(state)
    disk_check(tmp, nbytes, "Llama")
    t0 = time.perf_counter()
    save_file(state, os.path.join(hf, "model.safetensors"),
              metadata={"format": "pt"})
    io_rate("Llama-3-8B bf16, transformers layout: write", nbytes,
            time.perf_counter() - t0, card)
    del state
    with open(os.path.join(hf, "config.json"), "w") as f:
        json.dump(llama_hf_config(cfg), f)
    log_files(hf)

    _sync(torch)
    t0 = time.perf_counter()
    loaded, lcfg, _ = load_llama(hf, QuantConfig(**qc), device=dev)
    _sync(torch)
    io_rate("Llama-3-8B: load_llama (stream, quantize int8)", nbytes,
            time.perf_counter() - t0, card)
    check(lcfg == cfg, "io Llama: config.json read back as the model's")
    direct, _ = quantize_model(params, QuantConfig(**qc), arch="llama",
                               kinds={"embed_tokens.weight": "embedding"},
                               device=dev)
    del params
    bad = tree_mismatches(loaded, direct)
    check(not bad, f"io Llama: load_llama bit-equal to quantize_model in "
          f"memory ({len(bad)} leaves differ: {bad[:3]})")

    ids = torch.randint(0, cfg.vocab_size, (2, prompt), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(42))
    want_toks = generate(direct, ids, cfg, max_new_tokens=new, device=dev)
    want, _ = llm_forward(direct, ids, cfg, device=dev)
    del direct
    _sync(torch)
    reset_launch_counts()
    toks = generate(loaded, ids, cfg, max_new_tokens=new, device=dev)
    got, _ = llm_forward(loaded, ids, cfg, device=dev)
    _sync(torch)
    counts = launch_counts()
    check(bool(torch.equal(toks, want_toks)), f"io Llama: generate of 2 x "
          f"{prompt} + {new} tokens equal to the in-memory model's")
    check(bits_equal(got, want), "io Llama: causal forward logits bit-equal")
    check(bool(torch.isfinite(got).all()), "io Llama: logits finite")
    for name in required:
        check(counts[name] > 0, f"io Llama: generate and forward launched "
              f"{name}")
    return counts


def snapshot(tree):
    """A copy of a training state whose tensors are clones: the optimizer
    updates the state in place."""
    import dataclasses
    import torch

    def copy(x):
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        if isinstance(x, torch.Tensor):
            return x.detach().clone().requires_grad_(x.requires_grad)
        if hasattr(x, "delta"):
            return dataclasses.replace(x, qt=copy(x.qt))
        if _is_node(x):
            return dataclasses.replace(x, **{n: t.clone()
                                             for n, t in _arrays(x)})
        return x
    return copy(tree)


@contextlib.contextmanager
def timed_saves(records: list):
    """Times each ``io.save_checkpoint`` call that ``fit`` makes."""
    import sdnq_tpu_torch.io as io
    real = io.save_checkpoint

    def save(path, state):
        _sync(__import__("torch"))
        t0 = time.perf_counter()
        real(path, state)
        records.append(time.perf_counter() - t0)
    io.save_checkpoint = save
    try:
        yield
    finally:
        io.save_checkpoint = real


def io_fit_part(torch, dev, tmp, card, cfg, side=TRAIN_SIDE,
                txt_len=TRAIN_TXT, required=TRAIN_REQUIRED) -> dict:
    """``fit`` on the training slice with checkpoints every step (keep 2):
    ``restore_checkpoint`` of step_1 bit-equal to the state after step 1,
    and a second ``fit`` resumed from step_1, the generator set to its
    state after step 1, bit-equal at its end to the uninterrupted run.
    Returns the launch counts of the uninterrupted run."""
    import shutil
    from sdnq_tpu_torch import QuantConfig, quantize_model
    from sdnq_tpu_torch.io import restore_checkpoint
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models.dit import init_dit
    from sdnq_tpu_torch.optim import adamw
    from sdnq_tpu_torch.train import convert_model_to_training, fit

    params = init_dit(cfg, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(43))
    qparams, _ = quantize_model(
        params, QuantConfig(weights_dtype="int8", use_quantized_matmul=True),
        arch="FluxTransformer2DModel", device=dev)
    del params
    opt = adamw(lr=1e-5, quantize_state=True, stochastic_rounding=True)
    tparams = convert_model_to_training(qparams)
    del qparams
    state = {"params": tparams, "opt": opt.init(tparams)}
    del tparams
    inp = train_inputs(torch, dev, cfg, seed=44, side=side, txt_len=txt_len)

    def step_fn(st, gen):
        loss = train_loss(st["params"], cfg, inp, dev)
        loss.backward()

        def apply():
            opt.update(None, st["opt"], st["params"], generator=gen)
            return st
        return loss, apply

    ck_bytes = tree_bytes(state)
    disk_check(tmp, 3 * ck_bytes, "fit checkpoints")
    run_a, run_b = os.path.join(tmp, "fit"), os.path.join(tmp, "resume")
    gen = torch.Generator(device=dev).manual_seed(45)
    after_1 = {}

    def on_metrics(step, loss, step_time):
        if step == 0:
            after_1["state"] = snapshot(state)
            after_1["gen"] = gen.get_state()
            after_1["loss"] = loss

    saves = []
    _sync(torch)
    reset_launch_counts()
    with timed_saves(saves):
        full = fit(step_fn, state, 2, generator=gen, device=dev,
                   ckpt_dir=run_a, save_every=1, keep=2,
                   on_metrics=on_metrics)
    _sync(torch)
    counts = launch_counts()
    for name in required:
        check(counts[name] > 0, f"io fit: the two steps launched {name}")
    check(sorted(os.listdir(run_a)) == ["step_1", "step_2"],
          f"io fit: checkpoints {sorted(os.listdir(run_a))}")
    log_files(run_a)
    for s in saves:
        io_rate("fit checkpoint (2 + 2 blocks, int8, AdamW 8-bit moments, "
                "Kahan): save_checkpoint", ck_bytes, s, card)
    t0 = time.perf_counter()
    restored = restore_checkpoint(os.path.join(run_a, "step_1"), state)
    _sync(torch)
    io_rate("fit checkpoint: restore_checkpoint", ck_bytes,
            time.perf_counter() - t0, card)
    bad = tree_mismatches(restored, after_1["state"])
    check(not bad, f"io fit: restore_checkpoint of step_1 bit-equal to "
          f"the state after step 1 ({len(bad)} leaves differ: {bad[:3]})")
    del restored, after_1["state"]

    os.makedirs(run_b)
    shutil.copytree(os.path.join(run_a, "step_1"),
                    os.path.join(run_b, "step_1"), copy_function=os.link)
    gen_b = torch.Generator(device=dev)
    gen_b.set_state(after_1["gen"])
    resumed = fit(step_fn, full, 2, generator=gen_b, device=dev,
                  ckpt_dir=run_b, save_every=1, keep=2)
    _sync(torch)
    bad = tree_mismatches(resumed, full)
    check(not bad and resumed is not full, f"io fit: resumed from step_1, "
          f"bit-equal to the uninterrupted run ({len(bad)} leaves differ: "
          f"{bad[:3]})")
    check(sorted(os.listdir(run_b)) == ["step_1", "step_2"],
          "io fit: the resumed run saved step_2")
    log("io fit: " + json.dumps({
        "depth": [cfg.depth_double, cfg.depth_single],
        "checkpoint_bytes": ck_bytes, "loss_step_1": after_1["loss"]}))
    return counts


def io_phase(torch, dev) -> dict:
    """Phase 4i at full width: FLUX.1-dev (IO_FLUX_DEPTH), Llama-3-8B
    (IO_LLM_LAYERS) and the training slice (IO_TRAIN_DEPTH), every file
    in one temporary directory that is removed at the end.  Returns the
    launch counts of each path."""
    import dataclasses
    import shutil
    import tempfile
    from sdnq_tpu_torch.models import FLUX_DEV_CONFIG, LLAMA3_8B_CONFIG

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="sdnq_io_")
    counts = {}
    try:
        counts["io_flux"] = io_flux_part(
            torch, dev, tmp, smi, dataclasses.replace(
                FLUX_DEV_CONFIG, depth_double=IO_FLUX_DEPTH[0],
                depth_single=IO_FLUX_DEPTH[1]))
        shutil.rmtree(os.path.join(tmp, "flux"))
        shutil.rmtree(os.path.join(tmp, "flux_int8"))
        torch.cuda.empty_cache()
        counts["io_llama"] = io_llama_part(
            torch, dev, tmp, smi, dataclasses.replace(
                LLAMA3_8B_CONFIG, num_layers=IO_LLM_LAYERS))
        shutil.rmtree(os.path.join(tmp, "llama"))
        torch.cuda.empty_cache()
        counts["io_fit"] = io_fit_part(torch, dev, tmp, smi,
                                       train_config(IO_TRAIN_DEPTH))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    log(f"io: phase 4i took {time.perf_counter() - t_start:.1f} s ({smi})")
    return counts


# ---------------------------------------------------------------------------
# phase 4u: the SD1.5 / SDXL UNet, DDIM and sd_generate
# ---------------------------------------------------------------------------

# the sources phases 4m-4o and their rows launch (``--phases-4m-4b-4o``)
MBO_SOURCES = ("quantize_rows", "scaled_mm", "dequant_gemv",
                   "decode_weight", "wgmma_mm", "flash_attn",
                   "flash_attn_d256", "flash_attn_e4m3")
UNET_SOURCES = ("quantize_rows", "scaled_mm", "dequant_gemv", "decode_weight",
                "wgmma_mm", "flash_attn", "flash_attn_e4m3")
UNET_CTX = 77                 # CLIP's text tokens: cross-attention keys
UNET_FP8_ATTN = {"matmul_dtype": "fp8", "pv_matmul_dtype": "int8"}
# (label, model, side, requests, steps, attn_config, required kernel modes
# (a key, or a tuple of keys of which one must count)).  "sd15": BASELINE
# config 1, int8 weight-only (B2 on the linears; the convolutions' int8
# weights dequantized for cuDNN, as in JAX); "sdxl": BASELINE config 2,
# int8 with the quantized matmul on the linears and the im2col convolutions
# (B1 + B4); "sd15_fp8": the SD1.5 model with fp8 e4m3 Q.K and head-mode
# int8 P.V.  "auto" attention takes int8 Q.K at 4096 tokens (D 64) and bf16
# below.
UNET_RECIPES = (
    ("sd15", "sd15", 512, 2, 4, None,
     ("dequant_mm", "dequant_gemv", "flash_attention:int8_qk")),
    ("sdxl", "sdxl", 1024, 1, 4, None,
     ("quantize_rows", "scaled_gemm", "dequant_gemv",
      "flash_attention:int8_qk", "flash_attention:bf16_qk")),
    ("sd15_fp8", "sd15", 512, 1, 2, UNET_FP8_ATTN,
     ("flash_attention:head_pv", "flash_attention:e4m3_qk")),
)
# Limit of the UNet slice (phase 5): the kernel path against the all-plain
# path on the card, the largest error over the largest output, about twice
# its sound reading on the H100, 2.13e-2 (1.76e-2 of it with "auto"
# attention: B2's bf16 rounding over the slice's 22 resnets and 7
# transformers; the rest e4m3 Q.K's and head mode's P codes at ties).  The
# planted e4m3 fault reads 5.87e-2 (the head-mode fault breaks the bf16 /
# int8 library, which the slice's e4m3 attention does not use).
UNET_SLICE_TOL = {"max": 4.5e-2}


def unet_recipe(label):
    """The QuantConfig and skip-key architecture of a UNet model."""
    from sdnq_tpu_torch import QuantConfig
    if label == "sd15":
        return QuantConfig(weights_dtype="int8", quant_conv=True), "SD15UNet"
    return QuantConfig(weights_dtype="int8", quant_conv=True,
                       use_quantized_matmul=True,
                       use_quantized_matmul_conv=True), "SDXLUNet"


def build_unet(torch, dev, cfg, label, seed=40):
    """A UNet at full width from a seeded generator in bf16, quantized with
    its label's recipe; the bf16 weights freed afterwards."""
    from sdnq_tpu_torch import quantize_model
    from sdnq_tpu_torch.models import init_unet
    from sdnq_tpu_torch.tree import tree_leaves
    t0 = time.perf_counter()
    params = init_unet(cfg, generator=torch.Generator(device=dev).manual_seed(
        seed), device=dev, dtype=torch.bfloat16)
    n_params = sum(x.numel() for x in tree_leaves(params))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    qc, arch = unet_recipe(label)
    qparams, _ = quantize_model(params, qc, arch=arch, device=dev)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"{label}: UNet {cfg.block_out_channels} x {cfg.layers_per_block} "
        f"({n_params / 1e9:.3f} G parameters) built in {t1 - t0:.1f} s, "
        f"quantized in {time.perf_counter() - t1:.1f} s to "
        f"{tree_bytes(qparams) / 2**30:.2f} GiB, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return qparams


def unet_inputs(torch, dev, cfg, seed):
    """Random conditional and unconditional text states (1, 77,
    cross_attention_dim) and, for SDXL, added conditions (1, 2816)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    text, uncond = (torch.randn(1, UNET_CTX, cfg.cross_attention_dim,
                                device=dev, generator=g) for _ in range(2))
    added = (torch.randn(1, cfg.addition_embed_dim, device=dev,
                         generator=g) if cfg.addition_embed_dim else None)
    return text, uncond, added


@contextlib.contextmanager
def im2col_counted(counts):
    """Count the convolutions that take im2col (``counts["im2col"]``) and
    the B4 launches made inside them (``counts["im2col_scaled_gemm"]``)."""
    from sdnq_tpu_torch import layers
    from sdnq_tpu_torch.kernels import scaled_gemm
    real = layers._qconv_im2col

    def counted(*a, **kw):
        before = scaled_gemm.launches
        out = real(*a, **kw)
        counts["im2col"] += 1
        counts["im2col_scaled_gemm"] += scaled_gemm.launches - before
        return out
    layers._qconv_im2col = counted
    try:
        yield
    finally:
        layers._qconv_im2col = real


def unet_path(torch, dev, params, cfg, vae, vcfg, label, side, requests,
              steps, attn_config, required, dtype=None):
    """``sd_generate`` (DDIM, guidance 7.5, 77 text tokens) at side x side:
    ``requests`` requests of ``steps`` steps with the launch counts zeroed
    just before and read just after; the VAE timed alone on a latent of the
    request's shape splits a request into its UNet steps and its VAE.
    Launches per UNet forward by kernel and mode, and the calls of the XLA
    attention function (the 77-key cross-attention) per forward.  Every key
    in ``required`` must have launched, the images must be finite.  The
    text states in ``dtype`` where given (the fp16 recipe's).  Returns the
    counts."""
    from sdnq_tpu_torch.kernels import attention as ka
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models import vae_decode
    from sdnq_tpu_torch.pipeline import sd_generate

    text, uncond, added = unet_inputs(torch, dev, cfg, 50)
    if dtype is not None:
        text, uncond = text.to(dtype), uncond.to(dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ka.attention_xla.calls = ka.attention_xla.head_calls = 0
    conv = {"im2col": 0, "im2col_scaled_gemm": 0}
    images, walls = [], []
    with torch.no_grad(), im2col_counted(conv):
        for r in range(requests):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            images.append(sd_generate(
                params, vae, text, uncond, unet_cfg=cfg, vae_cfg=vcfg,
                steps=steps, height=side, width=side, guidance_scale=7.5,
                generator=torch.Generator(device=dev).manual_seed(60 + r),
                added_cond=added, attn_config=attn_config, device=dev))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
    counts = launch_counts()
    counts.update(conv, attention_xla=ka.attention_xla.calls,
                  attention_xla_head=ka.attention_xla.head_calls)
    peak = torch.cuda.max_memory_allocated() / 2**30
    lat = torch.randn(1, side // 8, side // 8, cfg.in_channels, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(9))
    with torch.no_grad():
        vae_ms = time_ms(lambda: vae_decode(vae, lat, vcfg, device=dev),
                         reps=2, warmup=1)
    del lat
    forwards = 2 * requests * steps
    for r, wall in enumerate(walls):
        unet_s = wall - vae_ms / 1e3
        log(f"{label}: request {r}: {wall:.3f} s per image: UNet "
            f"{unet_s:.3f} s ({unet_s / steps * 1e3:.1f} ms a DDIM step of "
            f"2 forwards), VAE {vae_ms:.1f} ms")
    log(f"{label}: " + json.dumps({
        "side": side, "latent": side // 8, "requests": requests,
        "steps": steps, "text_tokens": UNET_CTX,
        "attn_config": attn_config or "auto",
        "seconds_per_image": statistics.mean(walls), "vae_ms": vae_ms,
        "peak_gib": peak,
        "launches_per_forward": {k: v / forwards for k, v in counts.items()
                                 if v}}))
    for name in required:
        alts = (name,) if isinstance(name, str) else name
        check(any(counts[a] > 0 for a in alts),
              f"{label} path launched {' or '.join(alts)}")
    check(counts["attention_xla"] > 0,
          f"{label}: the cross-attention took the XLA function "
          f"({counts['attention_xla'] / forwards:.0f} calls a forward)")
    if attn_config:
        check(counts["attention_xla_head"] == counts["attention_xla"],
              f"{label}: the cross-attention took head mode's XLA branch")
    if cfg.addition_embed_dim:
        check(counts["im2col_scaled_gemm"] > 0
              and counts["scaled_gemm"] > counts["im2col_scaled_gemm"],
              f"{label}: B4 launched on the linears and on the im2col "
              f"convolutions ({counts['im2col_scaled_gemm']} of "
              f"{counts['scaled_gemm']})")
    for image in images:
        check(tuple(image.shape) == (1, side, side, 3)
              and bool(torch.isfinite(image).all()),
              f"{label} image {tuple(image.shape)} finite")
    if requests > 1:
        check(not torch.equal(images[0], images[1]),
              f"{label}: requests differ by their noise")
    return counts


def unet_profile_phase(torch, dev, params, cfg, label, side):
    """One DDIM step (two UNet forwards) at side x side, traced."""
    from sdnq_tpu_torch.models import make_staged_unet_forward
    from sdnq_tpu_torch.pipeline import DDIMScheduler
    text, uncond, added = unet_inputs(torch, dev, cfg, 70)
    lat = torch.randn(1, side // 8, side // 8, cfg.in_channels, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(71))
    forward = make_staged_unet_forward(cfg)
    sched = DDIMScheduler()
    t = torch.full((1,), 801, device=dev)

    @torch.no_grad()
    def step():
        eps_c = forward(params, lat, t.float(), text, added, device=dev)
        eps_u = forward(params, lat, t.float(), uncond, added, device=dev)
        eps = eps_u + 7.5 * (eps_c - eps_u)
        return sched.step(eps.float(), t, t - 250, lat)
    profile_step(torch, f"{label} DDIM step", step)


def unet_slice(torch, dev, cfg=None, params=None, dtype=None):
    """SD1.5 at full width cut to one resnet a level (and its transformer),
    int8 weight-only (or ``params`` of ``cfg``), for phase 5; with its
    inputs at 32x32 latents in ``dtype``."""
    import dataclasses
    from sdnq_tpu_torch.models import SD15_CONFIG
    if cfg is None:
        cfg = dataclasses.replace(SD15_CONFIG, layers_per_block=1)
        params = build_unet(torch, dev, cfg, "sd15", seed=41)
    text, _, _ = unet_inputs(torch, dev, cfg, 80)
    g = torch.Generator(device=dev).manual_seed(81)
    dtype = dtype or torch.float32
    return dict(params=params, cfg=cfg, text=text.to(dtype),
                x=torch.randn(1, 32, 32, 4, device=dev, generator=g).to(dtype),
                t=torch.full((1,), 601.0, device=dev))


def unet_slice_phase(torch, dev, sliced) -> dict:
    """The UNet slice, one forward with fp8 Q.K and head-mode P.V, through
    the kernels against the all-plain path, both on the card; returns
    {"max": the largest error over the largest output}."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models import unet_forward

    def run():
        with torch.no_grad():
            return unet_forward(sliced["params"], sliced["x"], sliced["t"],
                                sliced["text"], sliced["cfg"],
                                attn_config=UNET_FP8_ATTN,
                                device=dev).float()
    reset_launch_counts()
    out = run()
    launched = launch_counts()
    reset_launch_counts()
    with plain_versions():
        ref = run()
    plain = launch_counts()
    check(launched["flash_attention:head_pv"] > 0
          and launched["flash_attention:e4m3_qk"] > 0,
          "slice unet: the kernel path ran head mode and e4m3 Q.K")
    check(not any(plain.values()),
          "slice unet: the plain path launched no kernel " + json.dumps(plain))
    rel = float((out - ref).abs().max() / ref.abs().max())
    log("slice unet: SD1.5 at full width, one resnet a level, 32x32 "
        f"latents, {UNET_CTX} text tokens, fp8 Q.K and head-mode P.V, "
        "kernels against plain versions")
    check(rel <= UNET_SLICE_TOL["max"] and bool(torch.isfinite(out).all()),
          f"slice unet: kernel path vs plain path rel err {rel:.3e} <= "
          f"{UNET_SLICE_TOL['max']:.1e}")
    return {"max": rel}


def unet_phase(torch, dev, traced: bool = True):
    """Phase 4u: SD1.5 (int8 weight-only) and SDXL (int8 with the quantized
    matmul) at full width and depth, random weights from seeded generators,
    the SD VAE in bf16 weights; the recipes of UNET_RECIPES through
    ``sd_generate``; the SDXL DDIM step traced (phase 6) where ``traced``.
    Returns (counts by recipe, the phase-5 slice)."""
    from sdnq_tpu_torch.models import (
        SD15_CONFIG, SD_VAE_CONFIG, SDXL_CONFIG, init_vae)
    t_start = time.perf_counter()
    cfgs = {"sd15": SD15_CONFIG, "sdxl": SDXL_CONFIG}
    vae = init_vae(SD_VAE_CONFIG, generator=torch.Generator(
        device=dev).manual_seed(42), device=dev, dtype=torch.bfloat16)
    counts = {}
    for model in ("sd15", "sdxl"):
        params = build_unet(torch, dev, cfgs[model], model)
        for label, m, side, requests, steps, attn, required in UNET_RECIPES:
            if m == model:
                counts[label] = unet_path(
                    torch, dev, params, cfgs[model], vae, SD_VAE_CONFIG,
                    label, side, requests, steps, attn, required)
        if model == "sdxl" and traced:
            unet_profile_phase(torch, dev, params, cfgs[model], "sdxl",
                               1024)
        del params
        torch.cuda.empty_cache()
    del vae
    sliced = unet_slice(torch, dev)
    unet_slice_phase(torch, dev, sliced)
    log(f"unet: phase 4u took {time.perf_counter() - t_start:.1f} s")
    return counts, sliced


# ---------------------------------------------------------------------------
# Phases 4m-4o: MoE (phase 4m), continuous batching (4b), a Llama
# at head dim 100 (4o), SD1.5 at fp16 (4u's fp16 recipe), and the phase 3
# rows of their kernel modes
# ---------------------------------------------------------------------------

# openlm-research/open_llama_3b_v2 config.json: hidden 3200, 26 layers, 32
# heads and 32 KV heads of 100, intermediate 8640, vocab 32000,
# LlamaForCausalLM; rms_norm_eps 1e-6 (the eps both packages fix)
OPENLLAMA_3B_V2 = dict(vocab_size=32000, hidden_size=3200, num_layers=26,
                       num_heads=32, num_kv_heads=32, head_dim=100,
                       ff_dim=8640, rope_theta=10000.0)
MOE_TOKENS = (4, 1024)   # batch x sequence: C = 1280 rows an expert
# phase 4b: 4 slots, 6 requests of 2, 3 and 4 FlowMatch steps at
# 1024x1024 with 512 text tokens
BATCH_SLOTS, BATCH_STEPS = 4, (2, 3, 4, 2, 3, 4)
BATCH_SIDE, BATCH_TXT = 1024, 512
# Limits of the new paths' checks, the largest error over the largest
# output, each about twice its sound reading on the H100 (NVIDIA H100
# 80GB HBM3, 700 W).  Phase 4m against its all-plain path: int8 with the
# quantized matmul reads 0 (B1's codes and B4's int8 product and
# epilogue are bit-equal to their plain versions, and the einsums run
# alike); the weight-only bank 5.65e-3 (B4's bf16 products summed in
# another order than the plain fp32 product: the bf16 hidden state and
# the bf16 output an ulp apart, 2^-8 of the largest output).  Phase 4b,
# each request against itself alone at batch 1: 3.15e-3 (the same
# kernels at another M).  Phase 4u's fp16 recipe, the UNet slice at fp16
# against its plain path: 1.95e-3.
MBO_TOL = {"moe_qmm": 1e-6, "moe_wo": 1.2e-2, "batch": 7e-3,
               "sd15_fp16": 4e-3}


def with_tails(torch, dev, params, seed: int = 3) -> int:
    """Every 2-D weight of ``params`` (in place) redrawn at its own std
    with the tail of DYN_LAWS' cycle; returns the number redrawn."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = 0

    def walk(tree):
        nonlocal n
        for v in (tree.values() if isinstance(tree, dict) else tree):
            if isinstance(v, (dict, list)):
                walk(v)
            elif v.dim() == 2:
                t = student_t(torch, tuple(v.shape), DYN_LAWS[n % 4], g, dev)
                v.copy_(t.mul_(v.float().std() / t.std()))
                n += 1
                del t
    walk(params)
    return n


def mbo_rows(torch, dev, g, t, record, runs):
    """Phase 3 rows of phases 4m-4o's kernel modes: B3 at head dim
    100 (OpenLLaMA-3B-v2's, padded to 128) at phase 4o's prefill and
    causal shapes, at 160, at 256 and with v's head dim other than q's; B9
    at D 256 on a ring block of the zigzag layout; B2's e5m2 codes (the
    GEMV at phase 4b's modulation, M = the 4 slots; the tiles at its image
    qkv), fp16 x on B2's bit-plane GEMV and tiles, its unpacked tiles and
    B5, at SD1.5's shapes (phase 4u's fp16 recipe).  The B3 rows at padded
    head dims go through ``quantized_attention`` (its scale, q's own head
    dim's, and its padding) against the plain version on the unpadded
    operands; the B2 rows through ``dequant_matmul``."""
    import torch.nn.functional as F
    import sdnq_tpu_torch as T
    from sdnq_tpu_torch.kernels import attention as ka
    from sdnq_tpu_torch.kernels import dequant_mm as kd
    from sdnq_tpu_torch.quant.core import quantize_int_mm

    src, rep = ("sdnq_tpu_torch/csrc/flash_attn.cuh",
                "sdnq_tpu/kernels/attention.py:67")
    kinds = {"bf16": "bf16", "int8": "int8", "e4m3": "fp8", "token": "int8",
             "head": "int8"}

    def attn_row(label, b, h, n, kn, d, vd, qk, pv, path, count,
                 on_path=False, causal=False):
        q = torch.randn(b, h, n, d, device=dev, generator=g)
        k = torch.randn(b, h, kn, d, device=dev, generator=g)
        v = torch.randn(b, h, kn, vd, device=dev, generator=g)
        qkw = {"bf16": dict(matmul_dtype=None),
               "int8": dict(matmul_dtype="int8"),
               "e4m3": dict(matmul_dtype="fp8")}[qk]
        if pv != "bf16":
            qkw.update(pv_matmul_dtype="int8", pv_scale_mode=pv)
        kernel = (lambda: ka.quantized_attention(
            q, k, v, is_causal=causal, out_dtype=torch.float32, **qkw))
        got = kernel()
        args, kw = attn_mode_operands(
            torch, q.reshape(b * h, n, d), k.reshape(b * h, kn, d),
            v.reshape(b * h, kn, vd), qk, pv)
        want = ka.flash_attention_plain(*args, out_dtype=torch.float32,
                                        causal=causal, **kw)
        got = got.reshape(b * h, n, vd)
        err = (got - want).abs()
        reading = float((err.amax(-1) / want.abs().amax(-1)).max())
        del got
        qb, vb = (2 if qk == "bf16" else 1), (2 if pv == "bf16" else 1)
        pairs = b * h * (n * (n + 1) // 2 if causal else n * kn)
        moved = (b * h * n * d * qb + b * h * kn * (d * qb + vd * vb)
                 + (b * h * (n + kn) * 4 if qk != "bf16" else 0)
                 + (b * h * kn * 4 if pv == "token" else 0)
                 + b * h * n * vd * 4)
        bnd = bound_mixed_ms(moved, (2 * d * pairs, kinds[qk]),
                             (2 * vd * pairs, kinds[pv]))
        # SDPA takes v's head dim apart from q's too (the yardstick)
        q16, k16, v16 = (x.bfloat16() for x in (q, k, v))
        sdpa = (lambda: F.scaled_dot_product_attention(
            q16, k16, v16, is_causal=causal, scale=d ** -0.5))
        tol = (2 ** -6 if pv == "bf16" else 2 ** -7 if qk == "e4m3"
               else 2 ** -10)
        record("flash_attention", "cuda", src, rep, float(err.max()), tol,
               kernel, t.once(lambda: ka.flash_attention_plain(
                   *args, causal=causal, **kw)), bnd, t(sdpa),
               f"B{b} H{h} N{n} KN{kn} D{d}" + (f" vD{vd}" if vd != d else "")
               + f" {qk}-QK {pv}-P.V" + (" causal" if causal else "")
               + f" ({label}; the kernel's D "
               f"{ka.kernel_head_dim(max(d, vd))})",
               on_path=on_path, path=path, count=count, reading=reading,
               library_fn=sdpa, symbol="flash_attn")
        del q, k, v, want, args

    if runs("flash_attn"):
        if t.fresh("flash_attention:padded"):
            # phase 4o: the prefill of 4 x 896 tokens into the int8 cache
            # (token mode) and the causal forward (bf16 P.V), D 100 -> 128
            attn_row("OpenLLaMA prefill", 4, 32, 896, 1024, 100, 100, "int8",
                     "token", "llm100_int8kv", "flash_attention:padded",
                     on_path=True)
            attn_row("OpenLLaMA causal", 2, 32, 1024, 1024, 100, 100,
                     "int8", "bf16", "llm100_causal",
                     "flash_attention:padded", on_path=True, causal=True)
            attn_row("D 160", 1, 32, 2048, 2048, 160, 160, "int8", "bf16",
                     "llm100_causal", "flash_attention:padded")
            attn_row("vD != D", 1, 32, 2048, 2048, 100, 128, "int8", "bf16",
                     "llm100_causal", "flash_attention:padded")
    if runs("flash_attn_d256") and t.fresh("flash_attention:d256"):
        attn_row("D 256", 1, 32, 2048, 2048, 256, 256, "int8", "bf16",
                 "llm100_causal", "flash_attention:d256")
        attn_row("D 256", 1, 32, 2048, 2048, 256, 256, "int8", "token",
                 "llm100_causal", "flash_attention:d256")
        attn_row("D 256 causal", 1, 32, 2048, 2048, 256, 256, "bf16", "bf16",
                 "llm100_causal", "flash_attention:d256", causal=True)
    if runs("flash_attn_e4m3") and t.fresh("flash_attention:e4m3_qk"):
        attn_row("D 256", 1, 32, 2048, 2048, 256, 256, "e4m3", "head",
                 "llm100_causal", "flash_attention:e4m3_qk")

    # B9 at D 256: a block of the zigzag layout at P = 4 (1024-row chunks),
    # 32 heads
    if runs("flash_attn_d256") and t.fresh("flash_attention:d256"):
        bsrc = "sdnq_tpu/kernels/attention.py:259"
        for mode in ("bf16", "int8", "int8_token"):
            q, k, v = (torch.randn(32, 1024, 256, device=dev, generator=g)
                       for _ in range(3))
            args, kw = b9_operands(torch, q, k, v, mode)
            args.append(None)
            got = ka.flash_attention_block(*args, **kw)
            want = ka.flash_attention_block_plain(*args, **kw)
            rd = b9_readings(got, want)
            tol = B9_TOL.get(mode, B9_TOL["bf16_p"])
            qb = 1 if mode != "bf16" else 2
            vb = 1 if mode.endswith("_token") else 2
            ops = 4 * 256 * 32 * 1024 * 1024
            moved = 32 * 1024 * 256 * (qb + qb + vb) + 32 * 1024 * 258 * 4
            bnd = (bound_ms(moved, 0.75 * ops, "bf16") if mode == "int8"
                   else bound_ms(moved, ops,
                                 "int8" if mode != "bf16" else "bf16"))
            q16, k16, v16 = (x.bfloat16()[None] for x in (q, k, v))
            sdpa = (lambda: F.scaled_dot_product_attention(
                q16, k16, v16, scale=256 ** -0.5)) if mode == "bf16" else None
            log(f"B9 D 256 {mode}: readings " + json.dumps(rd) + " limits "
                + json.dumps(tol))
            record("flash_attention_block", "cuda", src, bsrc,
                   float((got[0] / got[2] - want[0] / want[2]).abs().max()),
                   1.0, lambda: ka.flash_attention_block(*args, **kw),
                   t(lambda: ka.flash_attention_block_plain(*args, **kw),
                     reps=3), bnd, t(sdpa) if sdpa else None,
                   f"BH32 N1024 KN1024 D256 {mode} (Llama-style zigzag "
                   "block at D 256)", on_path=False, path="ring",
                   count="flash_attention_block:d256",
                   reading=max(rd[key] / tol[key] for key in rd),
                   what="largest reading (out, m, l) over its limit",
                   readings=rd, limits=tol, library_fn=sdpa)
            del q, k, v, got, want, args

    def b2_row(label, m, k, o, fmt, gsize, xdt, path, count, on_path=True,
               seed=0, tails=False):
        """dequant_matmul on a weight quantized on the card, against the
        plain version on the same operands: each output's error over 1e-5
        of its sum of |terms| (the weight rounded to x's type where the
        kernel rounds it), held against 1."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        w = student_t(torch, (o, k), 3 if tails else None, gen, dev) * 0.02
        qt = T.quantize_tensor(w, fmt, group_size=gsize)
        del w
        meta = qt.meta
        codes = qt.qdata if meta.is_packed else qt.qdata.reshape(o, -1)
        scale = qt.scale.reshape(o, -1)
        zp = None if qt.zero_point is None else qt.zero_point.reshape(o, -1)
        gs = k // scale.shape[1]
        x = torch.randn(m, k, device=dev, generator=gen).to(xdt)
        bias = torch.randn(o, device=dev, generator=gen)
        args = (x, codes, scale, zp, bias, meta.format, gs)
        kw = dict(out_dtype=torch.float32, pack_layout=meta.pack_layout)
        kernel = lambda: kd.dequant_matmul(*args, **kw)  # noqa: E731
        got = kernel()
        plain = {"dequant_gemv": kd.dequant_gemv_plain,
                 "dequant_mm": kd.dequant_mm_plain,
                 "groupdot_mm": None}[count.split(":")[0]]
        if plain is None:
            from sdnq_tpu_torch.kernels.dequant_mm import _group_operands
            s, zpc = _group_operands(scale, zp, meta.format)
            pargs = (x, codes, s, zpc, bias, meta.format.code_bits,
                     torch.float32, meta.format)
            plain_fn = lambda: kd.groupdot_mm_plain(*pargs)  # noqa: E731
        else:
            fmt_arg = meta.format if meta.is_packed else None
            plain_fn = lambda: plain(x, codes, scale, zp, bias,  # noqa: E731
                                     torch.float32, fmt_arg)
        want = plain_fn()
        wd = T.dequantize(qt, torch.float32)
        if plain is None:   # B5: each group's exact codes times its scale
            vals = kd._halfsplit_values(codes, meta.format.code_bits, k,
                                        meta.format).reshape(o, -1, gs)
            wx = (vals.abs() * s[..., None] + zpc.abs()[..., None]).reshape(
                o, k)
            del vals
        else:               # the weight as x's type rounds it
            wx = wd.to(xdt).float()
        terms = x.float().abs() @ wx.abs().T + bias.abs()
        reading = float(((got - want).abs() / (1e-5 * terms + 1e-30)).max())
        wl = wd.to(xdt if xdt != torch.float32 else torch.bfloat16)
        xl = x if xdt != torch.float32 else x.bfloat16()
        lib = lambda: F.linear(xl, wl)  # noqa: E731
        name = count.split(":")[0]
        codes_b = codes.numel() * codes.element_size()
        bnd = bound_ms(m * k * x.element_size() + codes_b + o * 8
                       + m * o * 4, 2 * m * o * k,
                       "bf16" if xdt != torch.float32 else "fp32")
        record(name, "cuda",
               {"dequant_gemv": "sdnq_tpu_torch/csrc/dequant_gemv.cu",
                "dequant_mm": "sdnq_tpu_torch/csrc/decode_weight.cu + "
                              "wgmma_mm.cu",
                "groupdot_mm": "sdnq_tpu_torch/csrc/decode_weight.cu + "
                               "wgmma_mm.cu"}[name],
               {"groupdot_mm": "sdnq_tpu/kernels/dequant_mm.py:355"}.get(
                   name, "sdnq_tpu/kernels/dequant_mm.py:60"),
               float((got - want).abs().max()), 1.0, kernel,
               t(plain_fn, reps=3), bnd, t(lib),
               f"M{m} K{k} -> {o} {fmt} g{gsize if gsize > 0 else 'row'} "
               f"{str(xdt)[6:]} x ({label})", on_path=on_path, path=path,
               count=count, reading=reading,
               what="largest error over 1e-5 of its output's sum of |terms|")
        del qt, codes, x, got, want, wd, wx, wl

    if runs("dequant_gemv") and t.fresh("dequant_gemv:e5m2"):
        # phase 4b: a double block's modulation at 4 slots (fp32 vec)
        b2_row("FLUX modulation, 4 slots", 4, 3072, 18432, "float8_e5m2", 0,
               torch.float32, "batch_e5m2", "dequant_gemv:e5m2", seed=1)
    if runs("decode_weight", "wgmma_mm") and t.fresh("dequant_mm:e5m2"):
        b2_row("FLUX img qkv, 4 slots", 16384, 3072, 9216, "float8_e5m2", 0,
               torch.bfloat16, "batch_e5m2", "dequant_mm:e5m2", seed=2)
    if runs("dequant_gemv") and t.fresh("dequant_gemv:fp16"):
        # SD1.5's time embedding at the doubled batch (R1's bit-plane
        # formats on weights with tails) at fp16 x: off phase 4u's fp16
        # recipe, whose time embedding is fp32
        b2_row("SD1.5 time embedding", 2, 1280, 1280, "float8_e3m4fn", 1024,
               torch.float16, "sd15_fp16", "dequant_gemv:fp16",
               on_path=False, seed=3, tails=True)
        b2_row("SD1.5 time embedding", 2, 320, 1280, "float9_e3m5fn", -1,
               torch.float16, "sd15_fp16", "dequant_gemv:fp16",
               on_path=False, seed=4, tails=True)
    if runs("decode_weight", "wgmma_mm") and t.fresh("dequant_mm:fp16"):
        # SD1.5 level 0 at 512x512 (2 x 4096 tokens): the GEGLU projection
        # 320 -> 2560 on R1's bit-plane codes and int8 grouped codes, and
        # B5 (uint4 g128, off the path) at the same shape
        b2_row("SD1.5 L0 GEGLU", 8192, 320, 2560, "float9_e3m5fn", -1,
               torch.float16, "sd15_fp16", "dequant_mm:bitplane", seed=5,
               tails=True)
        b2_row("SD1.5 L1 ff out", 2048, 2560, 640, "int8", 1280,
               torch.float16, "sd15_fp16", "dequant_mm:fp16", seed=6)
        b2_row("SD1.5 L1 ff out, B5", 2048, 2560, 640, "uint4", 128,
               torch.float16, "sd15_fp16", "groupdot_mm:fp16",
               on_path=False, seed=7)
    torch.cuda.empty_cache()


# ---- phase 4m: MoE ---------------------------------------------------------

def moe_banks(torch, dev):
    """Mixtral-8x7B's expert FFN (``MoEConfig()``) from a seeded generator
    in bf16, quantized two ways: int8 with the quantized matmul (rowwise
    int8 codes: B1 + B4) and int8 weight-only (grouped codes, dequantized
    for B4's bf16 mode)."""
    from sdnq_tpu_torch.models import MoEConfig, init_moe, quantize_moe
    cfg = MoEConfig()
    t0 = time.perf_counter()
    params = init_moe(cfg, generator=torch.Generator(device=dev).manual_seed(
        17), device=dev, dtype=torch.bfloat16)
    qmm = quantize_moe(params, "int8", use_quantized_matmul=True)
    wo = quantize_moe(params, "int8")
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    nbytes = sum(qmm[k]["weight"].nbytes() for k in ("gate_proj", "up_proj",
                                                     "down_proj"))
    log(f"moe: Mixtral-8x7B expert banks ({cfg.num_experts} x "
        f"{cfg.hidden_size} x {cfg.ff_dim}, top-{cfg.top_k}, capacity "
        f"{cfg.capacity_factor}) drawn and quantized twice in "
        f"{time.perf_counter() - t0:.1f} s; int8 banks {nbytes / 1e9:.2f} GB")
    return cfg, {"moe_qmm": qmm, "moe_wo": wo}


def moe_tokens(torch, dev, cfg, seed=18, shape=MOE_TOKENS):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, cfg.hidden_size, device=dev,
                       generator=g).bfloat16()


def moe_check(torch, dev, cfg, params, label, x) -> dict:
    """``moe_ffn`` through the kernels against the all-plain path on the
    card; returns {"max": the largest error over the largest output}."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models import moe_ffn
    with torch.no_grad():
        y, aux = moe_ffn(params, x, cfg)
        reset_launch_counts()
        with plain_versions():
            ref, ref_aux = moe_ffn(params, x, cfg)
    plain = launch_counts()
    check(not any(plain.values()),
          f"{label}: the plain path launched no kernel "
          + json.dumps({k: v for k, v in plain.items() if v}))
    rel = float((y.float() - ref.float()).abs().max()
                / ref.float().abs().max())
    check(rel <= MBO_TOL[label] and bool(torch.isfinite(y).all())
          and float(aux) == float(ref_aux),
          f"{label}: kernel path vs plain path rel err {rel:.3e} <= "
          f"{MBO_TOL[label]:.1e}, aux loss equal")
    return {"max": rel}


def moe_phase(torch, dev, traced: bool = True):
    """Phase 4m: ``moe_ffn`` at Mixtral-8x7B's expert widths on 4 x 1024
    bf16 tokens (capacity 1280 rows an expert) with each bank: the launch
    counts zeroed just before and read just after a call, the time of a
    call (CUDA events), the dropped-token share and the aux loss, the
    output against the all-plain path; one call traced.  Returns (counts
    by label, (cfg, banks) for phase 7's slice)."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models import moe_ffn
    from sdnq_tpu_torch.models.moe import top_k

    t_start = time.perf_counter()
    cfg, banks = moe_banks(torch, dev)
    x = moe_tokens(torch, dev, cfg)
    t_tok = x.shape[0] * x.shape[1]
    cap = max(1, int(cfg.capacity_factor * cfg.top_k * t_tok
                     / cfg.num_experts))
    with torch.no_grad():   # the routing, as moe_ffn computes it
        xf = x.reshape(t_tok, -1)
        probs = torch.softmax(xf.float() @ banks["moe_qmm"]["router"][
            "weight"].float().T, -1)
        _, idx = top_k(probs, cfg.top_k)
        oh = torch.nn.functional.one_hot(idx, cfg.num_experts).int()
        flat = oh.reshape(-1, cfg.num_experts)
        pos = ((torch.cumsum(flat, 0) - flat).reshape(oh.shape) * oh).sum(-1)
        dropped = float((pos >= cap).float().mean())
        per_expert = oh.sum((0, 1)).tolist()
    counts = {}
    required = {"moe_qmm": ("quantize_rows", "scaled_gemm"),
                "moe_wo": ("scaled_gemm:bf16",)}
    for label, params in banks.items():
        torch.cuda.synchronize()
        reset_launch_counts()
        with torch.no_grad():
            y, aux = moe_ffn(params, x, cfg)
        torch.cuda.synchronize()
        counts[label] = launch_counts()
        with torch.no_grad():
            ms = time_ms(lambda: moe_ffn(params, x, cfg), reps=3, warmup=1)
        readings = moe_check(torch, dev, cfg, params, label, x)
        log(f"{label}: " + json.dumps({
            "tokens": t_tok, "capacity": cap, "ms_a_call": ms,
            "tokens_per_s": t_tok / ms * 1e3,
            "dropped_share": dropped, "choices_per_expert": per_expert,
            "aux_loss": float(aux), "readings": readings,
            "launches": {k: v for k, v in counts[label].items() if v}}))
        for name in required[label]:
            check(counts[label][name] > 0, f"{label} path launched {name}")
        check(tuple(y.shape) == tuple(x.shape)
              and bool(torch.isfinite(y).all()),
              f"{label} output {tuple(y.shape)} finite")
        if label == "moe_qmm":
            check(counts[label]["scaled_gemm"] == 3 * cfg.num_experts,
                  f"{label}: B4 launched once an expert and projection "
                  f"({counts[label]['scaled_gemm']})")
        if traced:
            profile_step(torch, f"{label} moe_ffn",
                         torch.no_grad()(lambda: moe_ffn(params, x, cfg)))
    log(f"moe: phase 4m took {time.perf_counter() - t_start:.1f} s")
    return counts, (cfg, banks)


def moe_slice_phase(torch, dev, sliced) -> dict:
    """Phase 7's MoE check: the int8 quantized-matmul bank on 512 tokens
    against its all-plain path."""
    cfg, banks = sliced
    x = moe_tokens(torch, dev, cfg, seed=19, shape=(1, 512))
    return moe_check(torch, dev, cfg, banks["moe_qmm"], "moe_qmm", x)


# ---- phase 4b: continuous batching of FLUX.1-dev ---------------------------

def flux_slot_step(params, cfg, freqs, dev):
    """One flow-matching Euler step of every slot at its own timestep: slot
    s is at step t_idx[s] of its request's schedule cond["ts"][s] (zeros
    past its last step), so t and the next t are gathered per slot, and
    the update is ``flux_denoise``'s; inactive slots keep their latents."""
    import torch
    from sdnq_tpu_torch.models.dit import dit_forward

    def step(lat, cond, t_idx, active):
        rows = torch.arange(lat.shape[0], device=lat.device)
        # an idle slot may stand past its schedule: any in-range index
        i = t_idx.long().clamp(max=cond["ts"].shape[1] - 2)
        t, t_prev = cond["ts"][rows, i], cond["ts"][rows, i + 1]
        g = torch.full((lat.shape[0],), 3.5, device=lat.device)
        v = dit_forward(params, lat, cond["txt"], t, cond["pooled"], cfg,
                        guidance=g, freqs=freqs, device=dev)
        new = lat + (t_prev - t)[:, None, None] * v.float()
        return torch.where(active[:, None, None], new, lat)
    return step


def batch_requests(torch, dev, cfg, txt_len=512, steps=BATCH_STEPS):
    """The queue of phase 4b: a request a step count, each with its own
    text states, pooled vector, noise seed and FlowMatch schedule (shift
    3, zeros past its last step)."""
    from sdnq_tpu_torch.pipeline import FlowMatchScheduler, Request
    sched = FlowMatchScheduler(shift=3.0)
    reqs = []
    for i, n in enumerate(steps):
        g = torch.Generator(device=dev).manual_seed(200 + i)
        ts = torch.zeros(max(steps) + 1, device=dev)
        ts[:n] = sched.timesteps(n, device=dev)
        reqs.append(Request(i, {
            "txt": torch.randn(txt_len, cfg.txt_dim, device=dev, generator=g),
            "pooled": torch.randn(cfg.vec_dim, device=dev, generator=g),
            "ts": ts}, n, rng_seed=300 + i))
    return reqs


def batch_run(torch, dev, params, cfg, side, txt_len, slots, steps,
              label, required=(), solo=True):
    """``ContinuousBatcher`` over ``batch_requests``: the counts zeroed
    just before the run and read just after, the efficiency, iterations
    and slot-steps a second; then each request alone through
    ``flux_denoise`` at batch 1 on the same noise: returns (counts, the
    largest error of a request over its solo run's largest value)."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models.dit import make_rope_freqs
    from sdnq_tpu_torch.pipeline import ContinuousBatcher, flux_denoise

    lh = lw = side // 16
    freqs = make_rope_freqs(cfg, txt_len, (lh, lw), device=dev)

    def init(req):
        g = torch.Generator(device=dev).manual_seed(req.rng_seed)
        return torch.randn(lh * lw, cfg.in_channels, device=dev, generator=g)

    reqs = batch_requests(torch, dev, cfg, txt_len, steps)
    batcher = ContinuousBatcher(flux_slot_step(params, cfg, freqs, dev),
                                init, slots, max(steps))
    for r in reqs:
        batcher.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        done = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    iters = batcher.total_slot_steps // slots
    log(f"{label}: " + json.dumps({
        "slots": slots, "requests": len(reqs), "steps": list(steps),
        "image_tokens": lh * lw, "text_tokens": txt_len,
        "finish_order": [r.request_id for r in done],
        "iterations": iters, "efficiency": batcher.efficiency,
        "seconds": wall, "ms_an_iteration": wall / iters * 1e3,
        "slot_steps_per_s": batcher.total_slot_steps / wall,
        "active_slot_steps_per_s": batcher.active_slot_steps / wall,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_iteration": {k: v / iters for k, v in counts.items()
                                   if v}}))
    for name in required:
        check(counts[name] > 0, f"{label} path launched {name}")
    check(sorted(r.request_id for r in done) == list(range(len(reqs))),
          f"{label}: every request completed")
    worst = 0.0
    if solo:
        with torch.no_grad():
            for r in done:
                ref = flux_denoise(params, r.cond["txt"][None],
                                   r.cond["pooled"][None], cfg,
                                   steps=r.num_steps, height=side,
                                   width=side, latents=init(r)[None],
                                   device=dev)[0]
                got = torch.from_numpy(r.result).to(dev)
                err = float((got - ref).abs().max() / ref.abs().max())
                worst = max(worst, err)
                check(bool(torch.isfinite(got).all()),
                      f"{label}: request {r.request_id} finite")
        log(f"{label}: each request against its solo run at batch 1: "
            f"largest error over the largest value {worst:.3e}")
    return counts, worst


def batch_phase(torch, dev, traced: bool = True):
    """Phase 4b: FLUX.1-dev (19 + 38 blocks) with every linear stored as
    native float8_e5m2 (weight-only) behind ``ContinuousBatcher``: 4
    slots, 6 requests of 2, 3 and 4 steps at 1024x1024 with 512 text
    tokens; each request against its solo run; one 4-slot step traced.
    Returns (counts, the phase-7 slice)."""
    from sdnq_tpu_torch import QuantConfig
    from sdnq_tpu_torch.models import FLUX_DEV_CONFIG
    from sdnq_tpu_torch.models.dit import make_rope_freqs

    t_start = time.perf_counter()
    cfg = FLUX_DEV_CONFIG
    qparams = build_model(torch, dev, QuantConfig(
        weights_dtype="float8_e5m2"), "batch_e5m2")
    counts, worst = batch_run(
        torch, dev, qparams, cfg, BATCH_SIDE, BATCH_TXT, BATCH_SLOTS,
        BATCH_STEPS,
        "batch_e5m2", required=("dequant_gemv:e5m2", "dequant_mm:e5m2",
                                "flash_attention"))
    check(worst <= MBO_TOL["batch"],
          f"batch_e5m2: every request equals its solo run within "
          f"{MBO_TOL['batch']:.1e} ({worst:.3e})")
    if traced:
        hw = BATCH_SIDE // 16
        freqs = make_rope_freqs(cfg, BATCH_TXT, (hw, hw), device=dev)
        step = flux_slot_step(qparams, cfg, freqs, dev)
        reqs = batch_requests(torch, dev, cfg, BATCH_TXT)[:BATCH_SLOTS]
        g = torch.Generator(device=dev).manual_seed(5)
        lat = torch.randn(BATCH_SLOTS, hw * hw, cfg.in_channels, device=dev,
                          generator=g)
        cond = {k: torch.stack([r.cond[k] for r in reqs])
                for k in ("txt", "pooled", "ts")}
        t_idx = torch.zeros(BATCH_SLOTS, dtype=torch.int32, device=dev)
        active = torch.ones(BATCH_SLOTS, dtype=torch.bool, device=dev)
        profile_step(torch, "batch_e5m2 4-slot step", torch.no_grad()(
            lambda: step(lat, cond, t_idx, active)))
    batch_mesh_check(torch, dev, qparams, cfg)
    sliced = cut(qparams)
    slice_phase(torch, dev, sliced, "e5m2")
    del qparams
    torch.cuda.empty_cache()
    log(f"batch: phase 4b took {time.perf_counter() - t_start:.1f} s")
    return counts, sliced


# ---- phase 4o: a Llama at head dim 100 ------------------------------------

def llm100_phase(torch, dev, traced: bool = True):
    """Phase 4o: OpenLLaMA-3B-v2's widths (head dim 100, padded to the
    kernel's 128) with int8 weights and the quantized matmul through
    ``llm_path`` (1 request of 4 x 896 prompt tokens into the int8 cache
    of 1024, 128 new tokens; the decode step at N = 1 on the XLA route, as
    in the JAX package) and the causal forward of 2 x 1024 tokens; a
    prefill and a decode step traced.  Returns (counts by label, the
    phase-7 slice)."""
    import dataclasses
    from sdnq_tpu_torch.kernels import attention as ka
    from sdnq_tpu_torch.models import LLMConfig

    t_start = time.perf_counter()
    cfg = LLMConfig(**OPENLLAMA_3B_V2)
    params, cfg = build_llm(torch, dev, cfg, "llm100")
    counts = {}
    ka.attention_xla.calls = 0
    counts["llm100_int8kv"] = llm_path(
        torch, dev, params, cfg, "llm100_int8kv", "int8", 1,
        ("quantize_rows", "scaled_gemm", "dequant_gemv",
         "flash_attention:padded", "flash_attention:int8_pv",
         "flash_attention:masked"))
    check(ka.attention_xla.calls > 0,
          f"llm100_int8kv: the decode steps (N = 1) took the XLA route "
          f"({ka.attention_xla.calls} calls)")
    log(f"llm100_int8kv: {ka.attention_xla.calls} attention_xla calls "
        "(the decode steps at N = 1: the JAX package's XLA route)")
    counts["llm100_causal"] = llm_causal_path(
        torch, dev, params, cfg, "llm100_causal",
        ("quantize_rows", "scaled_gemm", "flash_attention:padded",
         "flash_attention:causal"))
    if traced:
        llm_profile_phase(torch, dev, params, cfg, "llm100_int8kv")
    sliced = cut_llm(params, cfg)
    llm_slice_phase(torch, dev, sliced, "llm100_int8kv")
    del params
    torch.cuda.empty_cache()
    log(f"llm100: phase 4o took {time.perf_counter() - t_start:.1f} s")
    return counts, sliced


# ---- phase 4u's fp16 recipe -------------------------------------------------

def build_unet_fp16(torch, dev, cfg, label, seed=43):
    """SD1.5 at fp16 parameters from a seeded generator, its 2-D weights
    redrawn with tails (as phase 4g's), quantized with the dynamic R1
    ladder from int8 (dequant dtype fp16); prints the format histogram."""
    from sdnq_tpu_torch import QuantConfig, quantize_model
    from sdnq_tpu_torch.models import init_unet
    t0 = time.perf_counter()
    params = init_unet(cfg, generator=torch.Generator(device=dev).manual_seed(
        seed), device=dev, dtype=torch.float16)
    n = with_tails(torch, dev, params)
    qc = QuantConfig(weights_dtype="int8", use_dynamic_quantization=True,
                     dequant_dtype="float16")
    t1 = time.perf_counter()
    qparams, qcfg = quantize_model(params, qc, arch="SD15UNet", device=dev)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    hist = {f: len(p) for f, p in sorted(qcfg.modules_dtype_dict.items())}
    log(f"{label}: SD1.5 UNet at fp16 ({n} 2-D weights with tails) built in "
        f"{t1 - t0:.1f} s, quantized dynamically in "
        f"{time.perf_counter() - t1:.1f} s; format histogram "
        f"{json.dumps(hist)}, {tree_bytes(qparams) / 2**30:.2f} GiB")
    return qparams


def unet_fp16_phase(torch, dev):
    """Phase 4u's fp16 recipe: SD1.5 at fp16 activations and parameters
    (the dtype diffusers runs SD1.5 in) with the dynamic R1 ladder from
    int8, 1 request x 2 DDIM steps at 512x512 through ``sd_generate``
    (B2's bit-plane and unpacked tiles at fp16 x), the SD VAE in bf16 as
    phase 4u's (its random weights could overflow fp16); then the UNet
    slice at fp16 against its plain path.  The UNet's time embedding is
    fp32 (its sinusoidal features are, in both packages), so its MLP and
    the resnets' time projections (2 rows: B2's GEMV) take fp32 x; the
    GEMV at fp16 x is held in phase 3.  Returns (counts, the phase-7
    slice)."""
    import dataclasses
    from sdnq_tpu_torch.models import SD15_CONFIG, SD_VAE_CONFIG, init_vae

    t_start = time.perf_counter()
    vae = init_vae(SD_VAE_CONFIG, generator=torch.Generator(
        device=dev).manual_seed(42), device=dev, dtype=torch.bfloat16)
    params = build_unet_fp16(torch, dev, SD15_CONFIG, "sd15_fp16")
    counts = unet_path(torch, dev, params, SD15_CONFIG, vae, SD_VAE_CONFIG,
                       "sd15_fp16", 512, 1, 2, None,
                       ("dequant_mm:fp16", "dequant_mm:bitplane"),
                       dtype=torch.float16)
    log("sd15_fp16: B2 launches at fp16 x " + json.dumps({
        k: counts[k] for k in ("dequant_mm", "dequant_mm:fp16",
                               "dequant_gemv", "dequant_gemv:fp16")})
        + "; the GEMV's rows (the time embedding's, 2 rows) take fp32 x")
    del params, vae
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(SD15_CONFIG, layers_per_block=1)
    sliced = unet_slice(torch, dev, cfg=cfg, params=build_unet_fp16(
        torch, dev, cfg, "sd15_fp16 slice", seed=44), dtype=torch.float16)
    unet_fp16_slice_phase(torch, dev, sliced)
    log(f"unet: the fp16 recipe took {time.perf_counter() - t_start:.1f} s")
    return counts, sliced


def unet_fp16_slice_phase(torch, dev, sliced) -> dict:
    """The fp16 UNet slice, one forward with "auto" attention, through the
    kernels against the all-plain path on the card."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models import unet_forward

    def run():
        with torch.no_grad():
            return unet_forward(sliced["params"], sliced["x"], sliced["t"],
                                sliced["text"], sliced["cfg"],
                                device=dev).float()
    reset_launch_counts()
    out = run()
    launched = launch_counts()
    reset_launch_counts()
    with plain_versions():
        ref = run()
    plain = launch_counts()
    check(launched["dequant_mm:fp16"] > 0,
          "slice sd15_fp16: the kernel path ran B2's tiles at fp16 x")
    check(not any(plain.values()),
          "slice sd15_fp16: the plain path launched no kernel "
          + json.dumps(plain))
    rel = float((out - ref).abs().max() / ref.abs().max())
    tol = MBO_TOL["sd15_fp16"]
    log("slice sd15_fp16: SD1.5 at fp16, one resnet a level, R1 from int8, "
        f"32x32 latents, kernels against plain versions: {rel:.3e}")
    check(rel <= tol and bool(torch.isfinite(out).all()),
          f"slice sd15_fp16: kernel path vs plain path rel err {rel:.3e} <= "
          f"{tol:.1e}")
    return {"max": rel}


# ---------------------------------------------------------------------------
# phase 6: where one denoise step spends its device time
# ---------------------------------------------------------------------------

_GROUPS = (
    ("B1 quantize_rows", ("quantize_rows_",)),
    ("B4 scaled_gemm nt, TMA + wgmma (B1 GEMM half)",
     ("scaled_mm_wgmma_kernel",)),
    ("B4 scaled_gemm nn, TMA + wgmma (B1's grad-input)",
     ("scaled_mm_nn_wgmma_kernel",)),
    ("B2 dequant_gemv bit-plane", ("dequant_gemv_kernel_bitplane",)),
    ("B2 dequant_gemv", ("dequant_gemv_kernel", "dequant_gemv_mma_kernel")),
    ("B2 tiles: decode bit-plane", ("decode_weight_bitplane",)),
    ("B2 tiles: decode grouped / row", ("decode_weight_unpacked",)),
    ("B7: decode half-split into int8", ("decode_weight_halfsplit<signed char",
                                         "decode_weight_halfsplit<char")),
    ("B5: decode half-split", ("decode_weight_halfsplit",)),
    ("GEMM, bias epilogue (B2 grouped / bit-plane)", ("wgmma_mm_kernel<0",)),
    ("GEMM, row epilogue (B2 row mode)", ("wgmma_mm_kernel<1",)),
    ("GEMM, group fold (B5)", ("wgmma_mm_kernel<2", "wgmma_mm_kernel<3")),
    ("GEMM, int8 group fold (B7)", ("wgmma_i8_fold_kernel",)),
    ("B3 / B9 int8 P.V: V^T copy", ("flash_attn_vt_kernel",)),
    ("B9 flash_attention_block (bf16 / int8 / e4m3 Q.K; bf16 or token-mode "
     "int8 P.V)",
     tuple(f"flash_attn_{kern}_kernel<{d}, {qk}, {m}, true>"
           for kern in ("wgmma", "tok") for d in (128, 256)
           for qk in (0, 1, 2) for m in ("false", "true"))),
    ("B3 flash_attention", ("flash_attn_wgmma_kernel",)),
    ("B6 blockdiag_mm general (multi-plane, minifloat)",
     tuple(f"blockdiag_mm_kernel<{b}, true" for b in range(1, 8))
     + tuple(f"blockdiag_mm_kernel<{b}, false" for b in (3, 5, 6, 7))),
    ("B6 blockdiag_mm", ("blockdiag_mm_kernel",)),
    ("B3 flash_attention, int8 P.V (token and head mode)",
     ("flash_attn_tok_kernel",)),
    ("B8 blockdiag_i8_mm", ("blockdiag_i8_mm_kernel",)),
    ("B10 scaled_mm_tn, TMA + wgmma", ("scaled_mm_tn_wgmma_kernel",)),
    ("fp64 products (attention_xla: decode, the UNet's cross-attention, "
     "training backward)", ("f64", "dgemm", "Dgemm")),
    ("softmax (attention_xla, the VAE's attention)", ("softmax",)),
    ("cuDNN convolutions (the VAE)", ("fprop", "convolve", "implicit_gemm",
                                      "winograd", "cudnn")),
    ("cuBLAS (unquantized linears, SVD factors, lm_head)", (
        "gemm", "gemv", "cutlass", "xmma", "nvjet")),
    ("torch elementwise / reductions", ("elementwise", "reduce", "cat",
                                        "Copy", "copy", "index")),
)


def profile_phase(torch, dev, qparams, label, depth=None):
    """One Euler step of the FLUX.1-dev model (at ``depth`` where cut),
    traced."""
    cfg = flux_config(depth)
    inp = dit_inputs(torch, dev, cfg)
    profile_step(torch, label, lambda: inp["img"] + (-0.25) * forward(
        qparams, cfg, inp, dev).float())


def llm_profile_phase(torch, dev, params, cfg, label="llm_int8kv"):
    """One prefill (4 x 896 tokens into a fresh int8 cache of 1024) and one
    decode step (4 x 1 token at position 896) of the model, traced."""
    import dataclasses
    from sdnq_tpu_torch.models import init_cache, llm_forward

    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    ids = llm_prompts(torch, dev, cfg, 100)
    state = {}

    @torch.no_grad()
    def prefill():
        state["caches"] = init_cache(cfg, LLM_BATCH, LLM_PROMPT + LLM_NEW,
                                     device=dev)
        _, state["caches"] = llm_forward(params, ids, cfg,
                                         caches=state["caches"], device=dev)

    @torch.no_grad()
    def decode():
        caches = [c[:-1] + (LLM_PROMPT,) for c in state["caches"]]
        llm_forward(params, ids[:, :1], cfg, caches=caches, device=dev,
                    positions=torch.full((LLM_BATCH, 1), LLM_PROMPT,
                                         device=dev))

    profile_step(torch, f"{label} prefill", prefill)
    profile_step(torch, f"{label} decode", decode)


def profile_step(torch, label, step, warm: int = 1, after: int = 2):
    """Trace one ``step`` with torch.profiler after ``warm`` untraced ones
    (one: every path has run before it is traced);
    print the step's host-clock time, device busy time (kernel times summed
    on the one stream), the idle share, device time by kernel group, and
    the host-clock times of ``after`` untraced steps."""
    from collections import defaultdict
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
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
    for _ in range(after):
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
# phases 4n (Muon) and 4t (tensor, expert and data parallelism)
# ---------------------------------------------------------------------------

# The sources the paths of phases 4n and 4t run (``--phases-4n-4t``).
NT_SOURCES = ("quantize_rows", "scaled_mm", "scaled_mm_tn", "dequant_gemv",
              "flash_attn", "decode_weight", "wgmma_mm")
# A Muon leaf at FLUX's linear1 width: (21504, 3072), worked on transposed
# as 3072 x 21504, so B4 runs at the Gram (3072, 3072, K 21504), its
# square (3072^3) and the update (3072, 21504, K 3072).
MUON_LEAF = (21504, 3072)
MUON_SQUARE = 3072             # the leaf of the quantized-vs-fp32 NS row
GIVEN_SCALE_ROWS = (4608, 15360)   # linear2's input rows at 1024x1024
MUON_STEPS = 2                 # timed, after one warm-up step
MUON_LR = 1e-3
TP_SIZES = (2, 4)              # phase 4t's virtual tensor ranks
EP_SIZES = (2, 4, 8)           # phase 4t's virtual expert ranks
# Limits of phases 4n and 4t and of their phase-3 and phase-5 checks, each
# about twice its sound reading on the H100 (NVIDIA H100 80GB HBM3, 700 W;
# ``--phases-4n-4t``).  tp2 / tp4: the TP forward of the 19 + 38 blocks at
# virtual T = 2 / 4 against the unsharded forward, the largest error over
# the largest output (read 2.38e-2 / 2.41e-2): the row-parallel layers'
# fp32 partial sums are added in another order, and an ulp there moves an
# activation code at a rounding tie in a later layer, as between the two
# packages, compounded over the blocks.  tp_slice / tp_heads: phase 5's
# 1 + 2-block cut at T = 2 against the plain path / the unsharded forward
# (8.8e-3 / 6.0e-3).  ep: the expert-parallel call against moe_ffn, both
# with fp32 output (8.6e-8, about one fp32 ulp of the largest output: the
# experts' fp32 parts summed in rank order; rounding each rank's part to
# bf16 would read about 2^-9).  muon_ns: NS's quantized product against the
# fp32 one at 3072^2 (1.31e-2).  tp_step_*: the TP x DP step at T = 2
# against the unsharded step: loss 3.7e-5, gradients 1.56e-2 (activation
# codes at ties, as tp2), the share of updated codes that differ 3.1e-9
# (one code; the limit a few hundred).  muon_slice_*: one Muon step of the
# 2 + 2-block slice through the kernels against the all-plain path: loss
# 2.4e-5, codes that differ 1.2e-3.
NT_TOL = {"tp2": 5e-2, "tp4": 5e-2, "tp_slice": 2e-2, "tp_heads": 1.2e-2,
          "ep": 2 ** -22, "muon_ns": 3e-2, "tp_step_loss": 1e-4,
          "tp_step_grad": 3.5e-2, "tp_step_codes": 1e-6,
          "muon_slice_codes": 2.5e-3, "muon_slice_loss": 1e-4}


def _ns_bound(shapes):
    """The bound of a Newton-Schulz call's B4 GEMMs: each (M, N, K) reads
    its int8 operands, writes fp32, and does 2MNK int8 operations."""
    nbytes = sum(m * k + n * k + 4 * m * n + 4 * (m + n)
                 for m, n, k in shapes)
    return bound_ms(nbytes, sum(2 * m * n * k for m, n, k in shapes),
                    "int8")


def _b4_shapes(fn):
    """The (M, N, K) of every B4 GEMM ``fn`` runs through
    ``scaled_mm.scaled_mm``."""
    from sdnq_tpu_torch.kernels import scaled_mm as ks
    seen, real = [], ks.scaled_mm

    def spy(a, b, *args, **kw):
        seen.append((a.shape[0], b.shape[0], a.shape[1]))
        return real(a, b, *args, **kw)
    ks.scaled_mm = spy
    try:
        fn()
    finally:
        ks.scaled_mm = real
    return seen


def nt_rows(torch, dev, g, t, record, runs):
    """Phase 3's rows of phases 4n and 4t: B1 with a given row scale (a
    row-parallel shard's rows against the whole rows' scale); B4 nt at the
    Newton-Schulz shapes of a FLUX leaf, beside ``torch._int_mm``; the
    whole quantized NS of that leaf (classic, Gram-NS and adaptive mode's
    sign input) on B4 against NS on B4's plain version (bit-equal); the
    and the quantized NS against fp32 NS on a 3072^2 leaf.  The Muon
    module is looked up at the call, so that phase 7's broken copy takes
    its place."""
    import importlib
    from sdnq_tpu_torch.kernels import scaled_mm as ks

    if runs("quantize_rows"):
        m, k = GIVEN_SCALE_ROWS   # a rank's half of linear2's inputs
        x = torch.randn(m, k, device=dev, generator=g).bfloat16()
        whole = ks.quantize_rows_plain(x)
        part = x[:, k // 2:].contiguous()
        s = whole[1].reshape(-1)
        got = ks.quantize_rows(part, row_scale=s)
        want = ks.quantize_rows_plain(part, row_scale=s)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got[:2], want[:2]))
        err = max(err, float((got[0].float()
                              - whole[0][:, k // 2:].float()).abs().max()))
        record("quantize_rows", "cuda",
               "sdnq_tpu_torch/csrc/quantize_rows.cu",
               "sdnq_tpu/kernels/scaled_mm.py:230", err, 0.0,
               lambda: ks.quantize_rows(part, row_scale=s),
               t(lambda: ks.quantize_rows_plain(part, row_scale=s), reps=3),
               bound_ms(m * (k // 2) * 3 + m * 8, 2 * m * (k // 2), "fp32"),
               None, f"M{m} K{k // 2} bf16, the whole rows' scale given",
               path="tp", count="quantize_rows:given_scale")
        del x, whole, part

    if runs("scaled_mm"):
        n, w = MUON_LEAF[1], MUON_LEAF[0]
        for mm_, nn_, kk, what in ((n, n, w, "Gram x.xT"),
                                   (n, n, n, "its square"),
                                   (n, w, n, "the update, bT as (N, K)")):
            a = torch.randint(-127, 128, (mm_, kk), device=dev, generator=g,
                              dtype=torch.int8)
            b = torch.randint(-127, 128, (nn_, kk), device=dev, generator=g,
                              dtype=torch.int8)
            xs = torch.rand(mm_, 1, device=dev, generator=g) * 1e-3 + 1e-5
            ws = torch.rand(nn_, 1, device=dev, generator=g) * 1e-3 + 1e-5
            got = ks.scaled_mm(a, b, xs, ws, out_dtype=torch.float32)
            want = ks.scaled_gemm_plain(a, b, torch.float32, xs, ws)
            err = float((got - want).abs().max())
            record("scaled_gemm", "cuda", "sdnq_tpu_torch/csrc/scaled_mm.cu",
                   "sdnq_tpu/kernels/scaled_mm.py:57", err, 0.0,
                   lambda: ks.scaled_mm(a, b, xs, ws,
                                        out_dtype=torch.float32),
                   t.once(lambda: ks.scaled_gemm_plain(
                       a, b, torch.float32, xs, ws)),
                   _ns_bound([(mm_, nn_, kk)]),
                   t(lambda: torch._int_mm(a, b.t())),
                   f"M{mm_} N{nn_} K{kk} int8 fp32 out, Muon NS: {what}",
                   path="muon", count="scaled_gemm")
            del a, b, got, want

    if runs("scaled_mm"):
        tm = importlib.import_module("sdnq_tpu_torch.optim.muon")
        u = torch.randn(*MUON_LEAF, device=dev, generator=g)
        for mode, kw, on_path in (("classic", {}, True),
                                  ("Gram-NS", dict(use_gram_ns=True), False),
                                  ("adaptive (sign input)", {}, False)):
            inp = torch.sign(u) if mode.startswith("adaptive") else u

            def ns(inp=inp, kw=kw):
                return tm.zeropower_via_newtonschulz5(
                    inp, 5, use_quantized_matmul=True, **kw)
            try:
                got = ns()
                with plain_versions():
                    want = ns()
                err = float((got - want).abs().max())
                shapes = _b4_shapes(ns)
            except (RuntimeError, ValueError) as e:   # a broken glue
                log(f"muon NS {mode}: raised {e!r}")
                err, shapes = math.inf, [(1, 1, 1)]
            record("scaled_gemm", "cuda", "sdnq_tpu_torch/csrc/scaled_mm.cu",
                   "sdnq_tpu/kernels/scaled_mm.py:57", err, 0.0, ns,
                   t.once(lambda: _plain_call(ns)), _ns_bound(shapes), None,
                   f"Muon {mode} NS of a 21504 x 3072 leaf ({len(shapes)} "
                   f"GEMMs), B4 against its plain version",
                   on_path=on_path, path="muon", count="scaled_gemm")
        del u
        # the quantized product of NS (``_make_mm``: both operands to int8
        # codes, bᵀ as (N, K), then B4) against the fp32 product, on a
        # Gram x.xᵀ and a product of two leaves
        x = torch.randn(MUON_SQUARE, MUON_SQUARE, device=dev, generator=g)
        y = torch.randn(MUON_SQUARE, MUON_SQUARE, device=dev, generator=g)
        mm = tm._make_mm(True, torch.float32)
        try:
            reading = max(float((mm(a, b) - a @ b).abs().max()
                                / (a @ b).abs().max())
                          for a, b in ((x, x.T), (x, y)))
        except (RuntimeError, ValueError) as e:
            log(f"muon NS product: raised {e!r}")
            reading = math.inf
        record("scaled_gemm", "cuda", "sdnq_tpu_torch/csrc/scaled_mm.cu",
               "sdnq_tpu/kernels/scaled_mm.py:57", reading, NT_TOL["muon_ns"],
               lambda: mm(x, y), t(lambda: x @ y, reps=3),
               _ns_bound([(MUON_SQUARE,) * 3]), None,
               f"Muon's quantized NS product at {MUON_SQUARE}^2 (x.xT and "
               "x.y) against the fp32 product",
               on_path=False, path="muon", count="muon_ns", reading=reading,
               what="largest error over the fp32 product's largest value")
        del x, y


def _plain_call(fn):
    with plain_versions():
        return fn()


def _train_copy(torch, params):
    """A training tree whose updates leave ``params`` as they are: each
    TrainQTensor a new carrier over the same codes (an update replaces
    them), each float leaf a copy."""
    from sdnq_tpu_torch.train import TrainQTensor
    from sdnq_tpu_torch.train.matmul import grad_carrier
    from sdnq_tpu_torch.tree import tree_map

    def one(x):
        if isinstance(x, TrainQTensor):
            return TrainQTensor(qt=x.qt, delta=grad_carrier(
                x.delta.shape, x.qt.qdata.device))
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.detach().clone().requires_grad_(x.requires_grad)
        return x
    return tree_map(one, params, is_leaf=lambda x: isinstance(
        x, TrainQTensor))


def _qcodes(tree):
    from sdnq_tpu_torch import QTensor
    from sdnq_tpu_torch.train import TrainQTensor
    from sdnq_tpu_torch.tree import tree_leaves
    out = []
    for x in tree_leaves(tree, is_leaf=lambda v: isinstance(
            v, (QTensor, TrainQTensor))):
        if isinstance(x, TrainQTensor):
            x = x.qt
        if isinstance(x, QTensor):
            out.append(x.qdata)
    return out


def tp_phase(torch, dev, qparams):
    """Phase 4t on phase 4's int8 FLUX.1-dev (19 + 38 blocks, 1024x1024,
    512 text tokens): an NCCL process group of one on the card, its
    collectives through ``DistComm``; the forward of ``shard_params(...,
    DIT_TP_RULES)`` through create_mesh(tensor=1), bit-equal to
    ``dit_forward``; then ``local_tp`` at virtual T = 2 and 4 (the ranks
    in turn on the card: overhead, not speed-up) against the unsharded
    forward, with the launches of B1, B4, B3 and B2 a forward.  Returns the
    counts of the T = 2 forward."""
    import socket
    import torch.distributed as dist
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models import FLUX_DEV_CONFIG as cfg
    from sdnq_tpu_torch.parallel import (
        DIT_TP_RULES, create_mesh, shard_params,
    )
    from sdnq_tpu_torch.parallel._collectives import DistComm
    from sdnq_tpu_torch.parallel.dryrun import dryrun_multichip
    from sdnq_tpu_torch.parallel.tp import local_tp

    t_start = time.perf_counter()
    inp = dit_inputs(torch, dev, cfg, seed=43)
    with torch.no_grad():
        forward(qparams, cfg, inp, dev)          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = forward(qparams, cfg, inp, dev)
        torch.cuda.synchronize()
    secs = {"unsharded": time.perf_counter() - t0}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = create_mesh(tensor=1, device=dev)
        comm = DistComm(mesh, "tensor")   # the collectives through NCCL
        x = torch.randn(64, 128, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(44))
        parts = comm._gather_list(x)
        y = x.clone()
        dist.broadcast(y, 0, group=mesh.get_group("tensor"))
        z = x.clone()
        dist.all_reduce(z, group=mesh.get_group("tensor"))
        torch.cuda.synchronize()
        check(len(parts) == 1 and torch.equal(parts[0], x)
              and torch.equal(y, x) and torch.equal(z, x),
              f"tp: NCCL ({dist.get_backend()}) world of one: all_gather, "
              "broadcast and all_reduce give the tensor back")
        sharded = shard_params(qparams, mesh, DIT_TP_RULES)
        with torch.no_grad():
            forward(sharded, cfg, inp, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = forward(sharded, cfg, inp, dev)
            torch.cuda.synchronize()
        secs["t1"] = time.perf_counter() - t0
        check(torch.equal(out, ref), "tp: T = 1 through create_mesh("
              "tensor=1) on NCCL bit-equal to dit_forward")
        del sharded, out
        # the JAX dry run's quantized training step, on this process group
        t0 = time.perf_counter()
        loss = dryrun_multichip(1, device=dev)
        check(math.isfinite(loss), f"tp: dryrun_multichip(1) on NCCL, loss "
              f"{loss:.6f} finite ({time.perf_counter() - t0:.2f} s)")
    finally:
        dist.destroy_process_group()
    counts = {}
    readings = {}
    for n in TP_SIZES:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = local_tp(qparams, inp["img"], inp["txt"], inp["t"],
                           inp["pooled"], cfg, n, guidance=inp["guidance"],
                           freqs=inp["freqs"], device=dev)
        torch.cuda.synchronize()
        secs[f"t{n}"] = time.perf_counter() - t0
        c = launch_counts()
        counts[n] = c
        readings[n] = float((out.float() - ref.float()).abs().max()
                            / ref.float().abs().max())
        check(readings[n] <= NT_TOL[f"tp{n}"]
              and bool(torch.isfinite(out).all()),
              f"tp: virtual T = {n} against the unsharded forward "
              f"{readings[n]:.3e} <= {NT_TOL[f'tp{n}']:.1e}")
        for name in ("quantize_rows", "quantize_rows:given_scale",
                     "scaled_gemm", "flash_attention", "dequant_gemv"):
            check(c[name] > 0, f"tp: T = {n} launched {name}")
        log(f"tp: T = {n}: " + json.dumps({
            "seconds_a_forward_sharding_included": secs[f"t{n}"],
            "reading": readings[n],
            "launches_a_forward": {k: c[k] for k in (
                "quantize_rows", "quantize_rows:given_scale", "scaled_gemm",
                "flash_attention", "dequant_gemv")}}))
        del out
        torch.cuda.empty_cache()
    log("tp: FLUX.1-dev 19 + 38 blocks, 1024x1024, 512 text tokens, "
        "seconds a forward: " + json.dumps(secs)
        + f"; phase 4t's forwards took {time.perf_counter() - t_start:.1f} s")
    return counts[2]


def tp_slice_phase(torch, dev, sliced) -> dict:
    """Phase 5's TP check: ``local_tp`` at T = 2 on a 1 + 2-block cut
    through the kernels against the same through the plain versions
    ("max"), and against the unsharded forward through the kernels
    ("heads": the heads and MLP slice each rank holds), all on the card.
    The sharding module is looked up at the call, so that phase 7's broken
    copy's layout takes its place."""
    import importlib
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.parallel.tp import local_tp
    sh = importlib.import_module("sdnq_tpu_torch.parallel.sharding")
    params, cfg = sliced
    inp = dit_inputs(torch, dev, cfg, seed=45)

    def run():
        with torch.no_grad():
            return local_tp(params, inp["img"], inp["txt"], inp["t"],
                            inp["pooled"], cfg, 2, guidance=inp["guidance"],
                            freqs=inp["freqs"], device=dev,
                            segments=sh.DIT_TP_SEGMENTS)
    got = run()
    with torch.no_grad():
        whole = forward(params, cfg, inp, dev)
    heads = float((got.float() - whole.float()).abs().max()
                  / whole.float().abs().max())
    del whole
    reset_launch_counts()
    with plain_versions():
        want = run()
    launched = launch_counts()
    check(not any(launched.values()), "slice tp: the plain path launched "
          "no kernel")
    reading = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
    log(f"slice tp: 1 + 2 blocks at T = 2, kernels against plain versions "
        f"{reading:.3e}, against the unsharded forward {heads:.3e}")
    check(reading <= NT_TOL["tp_slice"], f"slice tp: {reading:.3e} <= "
          f"{NT_TOL['tp_slice']:.1e}")
    check(heads <= NT_TOL["tp_heads"], f"slice tp: against the unsharded "
          f"forward {heads:.3e} <= {NT_TOL['tp_heads']:.1e}")
    return {"max": reading, "heads": heads}


def ep_phase(torch, dev, cfg, banks):
    """Phase 4t's expert parallelism: phase 4m's int8 banks (quantized
    matmul) spread by ``shard_moe`` over virtual 2, 4 and 8 ranks, each
    call against ``moe_ffn`` on the whole banks."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models.moe import moe_ffn, shard_moe
    from sdnq_tpu_torch.parallel._collectives import run_virtual
    x = moe_tokens(torch, dev, cfg)
    qp = banks["moe_qmm"]
    f32 = torch.float32   # fp32 out: the sums' order shows in fp32 ulps
    with torch.no_grad():
        ref = moe_ffn(qp, x, cfg, out_dtype=f32)[0]
    out = {}
    for n in EP_SIZES:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            y = run_virtual(lambda m: moe_ffn(shard_moe(qp, m), x, cfg,
                                              out_dtype=f32)[0],
                            {"tensor": n}, "cuda")[0]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c = launch_counts()
        err = float((y.float() - ref.float()).abs().max()
                    / ref.float().abs().max())
        check(err <= NT_TOL["ep"], f"ep: {n} virtual ranks against moe_ffn "
              f"{err:.3e} <= {NT_TOL['ep']:.1e}")
        check(c["scaled_gemm"] == 3 * cfg.num_experts,
              f"ep: {n} ranks launched B4 once an expert and projection "
              f"({c['scaled_gemm']})")
        out[n] = dict(seconds_sharding_included=secs, reading=err,
                      launches={k: v for k, v in c.items() if v})
        del y
    with torch.no_grad():
        ms = time_ms(lambda: moe_ffn(qp, x, cfg), reps=3, warmup=1)
    log("ep: Mixtral-8x7B banks over virtual ranks: " + json.dumps(
        {"whole_ms_a_call": ms, **{str(k): v for k, v in out.items()}}))
    return out


def batch_mesh_check(torch, dev, params, cfg):
    """Phase 4t's batcher: one iteration of phase 4b's 4-slot step with the
    slot axis over a data axis of one (create_mesh(data=1)), bit-equal to
    ``mesh=None``."""
    from sdnq_tpu_torch.models.dit import make_rope_freqs
    from sdnq_tpu_torch.parallel import create_mesh
    from sdnq_tpu_torch.pipeline import ContinuousBatcher
    lh = BATCH_SIDE // 16
    freqs = make_rope_freqs(cfg, BATCH_TXT, (lh, lh), device=dev)

    def init(req):
        gen = torch.Generator(device=dev).manual_seed(req.rng_seed)
        return torch.randn(lh * lh, cfg.in_channels, device=dev,
                           generator=gen)
    lats = []
    for mesh in (None, create_mesh(data=1, device=dev)):
        b = ContinuousBatcher(flux_slot_step(params, cfg, freqs, dev), init,
                              BATCH_SLOTS, max(BATCH_STEPS), mesh=mesh)
        for r in batch_requests(torch, dev, cfg, BATCH_TXT):
            b.submit(r)
        with torch.no_grad():
            b.run(max_iterations=1)
        lats.append(b.latents)
    check(torch.equal(lats[0], lats[1]), "batch: one iteration with the "
          "slots over create_mesh(data=1) bit-equal to mesh=None")


def muon_phase(torch, dev, tparams, cfg, adamw_ms=None):
    """Phase 4n: phase 4e's training model under a fresh ``muon(
    use_quantized_matmul_ns=True)`` with 8-bit state, stochastic rounding
    and Kahan: one warm-up and MUON_STEPS timed steps, forward, backward
    and optimizer ms, the NS calls' ms, B4 launches in the optimizer (15 a
    classic NS leaf), peak GiB, the loss (finite) and the share of weight
    codes moved (above 0).  Returns the counts over the steps."""
    import importlib
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.train import TrainQTensor
    from sdnq_tpu_torch.tree import tree_leaves
    tm = importlib.import_module("sdnq_tpu_torch.optim.muon")

    inp = train_inputs(torch, dev, cfg, seed=46)
    opt = tm.muon(lr=MUON_LR, use_quantized_matmul_ns=True,
                  quantize_state=True, stochastic_rounding=True)
    t0 = time.perf_counter()
    state = opt.init(tparams)
    torch.cuda.synchronize()
    n_muon = sum(1 for st in state["per_param"] if st and st["muon"])
    log(f"muon: state built in {time.perf_counter() - t0:.1f} s, {n_muon} "
        f"NS leaves, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    gen = torch.Generator(device=dev).manual_seed(47)
    qleaves = [p for p in tree_leaves(tparams, is_leaf=lambda x: isinstance(
        x, TrainQTensor)) if isinstance(p, TrainQTensor)]
    n_codes = sum(p.qt.qdata.numel() for p in qleaves)
    real_ns = tm.zeropower_via_newtonschulz5
    ns_events = []

    def timed_ns(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_ns(*a, **kw)
        ev[1].record()
        ns_events.append(ev)
        return out
    tm.zeropower_via_newtonschulz5 = timed_ns
    records = []
    try:
        reset_launch_counts()
        for i in range(1 + MUON_STEPS):
            old = [p.qt.qdata.cpu() for p in qleaves]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ns_events.clear()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            loss = train_loss(tparams, cfg, inp, dev)
            ev[1].record()
            loss.backward()
            ev[2].record()
            torch.cuda.synchronize()
            before = launch_counts()
            opt.update(None, state, tparams, generator=gen)
            ev[3].record()
            torch.cuda.synchronize()
            after = launch_counts()
            b4 = after["scaled_gemm"] - before["scaled_gemm"]
            moved = sum(int((p.qt.qdata != o.to(dev)).sum())
                        for p, o in zip(qleaves, old))
            del old
            fwd, bwd, upd = (ev[j].elapsed_time(ev[j + 1]) for j in range(3))
            rec = dict(step=i, warm_up=i == 0, loss=float(loss.detach()),
                       forward_ms=fwd, backward_ms=bwd, optimizer_ms=upd,
                       ns_ms=sum(a.elapsed_time(b) for a, b in ns_events),
                       ns_calls=len(ns_events), b4_launches_optimizer=b4,
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                       codes_moved_share=moved / n_codes)
            log("muon: " + json.dumps(rec))
            records.append(rec)
            del loss
            check(math.isfinite(rec["loss"]), f"muon step {i}: loss finite")
            check(rec["codes_moved_share"] > 0, f"muon step {i}: the update "
                  f"moved {rec['codes_moved_share']:.3e} of the codes")
            check(b4 == 15 * n_muon and rec["ns_calls"] == n_muon,
                  f"muon step {i}: {b4} B4 launches in the optimizer, 15 "
                  f"each of {n_muon} NS leaves")
        counts = launch_counts()
    finally:
        tm.zeropower_via_newtonschulz5 = real_ns
    timed = records[1:]
    log("muon: " + json.dumps({
        "depth": list(TRAIN_DEPTH), "timed_steps": len(timed),
        "mean_optimizer_ms": statistics.mean(r["optimizer_ms"]
                                             for r in timed),
        "mean_ns_ms": statistics.mean(r["ns_ms"] for r in timed),
        "mean_forward_ms": statistics.mean(r["forward_ms"] for r in timed),
        "mean_backward_ms": statistics.mean(r["backward_ms"] for r in timed),
        "adamw_mean_optimizer_ms": adamw_ms,
        "peak_gib": max(r["peak_gib"] for r in records)}))
    del state
    return counts


def muon_slice_phase(torch, dev, sliced) -> dict:
    """Phase 5's Muon check: one Muon step (quantized NS, 8-bit state,
    SR from a seeded generator, Kahan) on the 2 + 2-block training slice
    through the kernels against the all-plain path, both on the card: the
    loss and the share of updated codes that differ."""
    import importlib
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    tm = importlib.import_module("sdnq_tpu_torch.optim.muon")
    params, cfg = sliced
    inp = train_inputs(torch, dev, cfg, seed=48)

    def run():
        p = _train_copy(torch, params)
        opt = tm.muon(lr=MUON_LR, use_quantized_matmul_ns=True,
                      quantize_state=True, stochastic_rounding=True)
        st = opt.init(p)
        loss = train_loss(p, cfg, inp, dev)
        loss.backward()
        opt.update(None, st, p,
                   generator=torch.Generator(device=dev).manual_seed(49))
        return float(loss.detach()), _qcodes(p)
    try:
        loss, codes = run()
        reset_launch_counts()
        with plain_versions():
            ref_loss, ref_codes = run()
    except (RuntimeError, ValueError) as e:   # a broken glue may raise
        check(False, f"slice muon: the step raised {e!r}")
        return {"loss": math.inf, "codes": math.inf}
    launched = launch_counts()
    check(not any(launched.values()), "slice muon: the plain path launched "
          "no kernel")
    diff = sum(int((a != b).sum()) for a, b in zip(codes, ref_codes))
    total = sum(a.numel() for a in codes)
    readings = {"loss": abs(loss - ref_loss) / abs(ref_loss),
                "codes": diff / total}
    log("slice muon: one step of the 2 + 2-block slice, kernels against "
        "plain versions: " + json.dumps(readings))
    check(math.isfinite(loss), "slice muon: loss finite")
    check(readings["loss"] <= NT_TOL["muon_slice_loss"]
          and readings["codes"] <= NT_TOL["muon_slice_codes"],
          f"slice muon: loss {readings['loss']:.3e} <= "
          f"{NT_TOL['muon_slice_loss']:.1e}, codes that differ "
          f"{readings['codes']:.3e} <= {NT_TOL['muon_slice_codes']:.1e}")
    return readings


def tp_train_phase(torch, dev, sliced, label="int8", shape=None,
                   rules=None, required=("scaled_mm_tn", "scaled_gemm:nn",
                                         "quantize_rows:colscale",
                                         "quantize_rows:given_scale",
                                         "scaled_gemm"),
                   codes: bool = True):
    """Phase 4t's TP x DP step at virtual T = 2 (or the mesh ``shape``,
    sharded by ``rules``) on phase 5's 2 + 2-block training slice
    (``local_train_step``: AdamW with 8-bit state and SR, each rank's
    generator seeded alike), against the unsharded step: the loss, every
    weight gradient, and (``codes``) the updated codes; the kernels in
    ``required`` must have launched."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.optim import adamw
    from sdnq_tpu_torch.parallel import DIT_TP_RULES, shard_params
    from sdnq_tpu_torch.parallel._collectives import run_virtual
    from sdnq_tpu_torch.parallel.dryrun import local_train_step
    from sdnq_tpu_torch.parallel.sharding import unshard_params
    from sdnq_tpu_torch.train import extract_weight_grads
    from sdnq_tpu_torch.tree import tree_leaves
    params, cfg = sliced
    inp = train_inputs(torch, dev, cfg, seed=50)
    batch = dict(img=inp["img"], txt=inp["txt"], timesteps=inp["t"],
                 pooled=inp["pooled"], guidance=inp["guidance"],
                 target=inp["target"])
    opt = adamw(lr=1e-5, quantize_state=True, stochastic_rounding=True)
    ref = _train_copy(torch, params)
    st = opt.init(ref)
    loss = train_loss(ref, cfg, inp, dev)
    loss.backward()
    ref_grads = tree_leaves(extract_weight_grads(ref))
    opt.update(None, st, ref,
               generator=torch.Generator(device=dev).manual_seed(51))
    shape = shape or {"tensor": 2}
    trees = run_virtual(lambda m: shard_params(params, m,
                                               rules or DIT_TP_RULES),
                        shape, "cuda")
    states = [opt.init(params) for _ in trees]
    gens = [torch.Generator(device=dev).manual_seed(51) for _ in trees]
    grads = []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    tp_loss = local_train_step(trees, opt, states, batch, cfg, shape,
                               freqs=inp["freqs"], generators=gens,
                               device=dev, grads_out=grads)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    whole = run_virtual(lambda m: unshard_params(trees[m.index]), shape,
                        "cuda")[0]
    g_err = max(float((a.float() - b.float()).abs().max()
                      / b.float().abs().max().clamp_min(1e-30))
                for a, b in zip(grads, ref_grads)
                if a is not None and b is not None)
    got_c, want_c = _qcodes(whole), _qcodes(ref)
    diff = sum(int((a != b).sum()) for a, b in zip(got_c, want_c))
    total = sum(a.numel() for a in want_c)
    readings = {"loss": abs(tp_loss.item() - loss.item()) / abs(loss.item()),
                "grad": g_err, "codes": diff / total}
    log(f"tp step {label}: virtual {shape} on the 2 + 2-block training "
        "slice against the unsharded step: " + json.dumps({
            **readings, "seconds": secs,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": {k: v for k, v in counts.items() if v}}))
    for key in ("loss", "grad", "codes") if codes else ("loss", "grad"):
        check(readings[key] <= NT_TOL[f"tp_step_{key}"],
              f"tp step {label}: {key} {readings[key]:.3e} <= "
              f"{NT_TOL[f'tp_step_{key}']:.1e}")
    for name in required:
        check(counts[name] > 0, f"tp step {label} launched {name}")
    return readings


def nt_phases(torch, dev, mark):
    """``--phases-4n-4t``: phases 4n and 4t with the models they reuse
    built here (phase 4's int8 FLUX.1-dev, phase 4e's training model,
    phase 4m's banks, phase 4b's e5m2 FLUX.1-dev) and their phase-5
    checks; returns the counts by path label."""
    from sdnq_tpu_torch import QuantConfig
    from sdnq_tpu_torch.models import FLUX_DEV_CONFIG
    counts = {}
    qparams = build_model(torch, dev, QuantConfig(
        weights_dtype="int8", use_quantized_matmul=True), "int8")
    counts["tp"] = tp_phase(torch, dev, qparams)
    tp_slice_phase(torch, dev, cut(qparams))
    del qparams
    torch.cuda.empty_cache()
    mark("phase 4t (TP forwards)")
    tparams, tcfg = build_train_model(torch, dev)
    counts["muon"] = muon_phase(torch, dev, tparams, tcfg)
    train_cut = cut_train(tparams)
    del tparams
    torch.cuda.empty_cache()
    tp_train_phase(torch, dev, train_cut)
    muon_slice_phase(torch, dev, train_cut)
    del train_cut
    torch.cuda.empty_cache()
    mark("phase 4n, the TP x DP step")
    cfg, banks = moe_banks(torch, dev)
    ep_phase(torch, dev, cfg, banks)
    del banks
    torch.cuda.empty_cache()
    qparams = build_model(torch, dev, QuantConfig(
        weights_dtype="float8_e5m2"), "batch_e5m2")
    batch_mesh_check(torch, dev, qparams, FLUX_DEV_CONFIG)
    del qparams
    torch.cuda.empty_cache()
    mark("phase 4t (EP, batcher)")
    return counts


# ---------------------------------------------------------------------------
# phase 4l: int8 contractions of 2^17 rows and more; phase 4t's training
# cases where the port raised before
# ---------------------------------------------------------------------------

# FLUX.1-dev's linear1 (3072 -> 21504) over a training step at batch 32 and
# 1024x1024 (32 x 4608 = 147,456 tokens): its grad-weight contracts past
# 2^17 tokens
LONG_TOKENS = 32 * 4608
LONG_LINEAR = (3072, 21504)
# a Muon leaf at Qwen2.5-7B's embedding widths (``Qwen/Qwen2.5-7B``
# config.json: vocab_size 152064, hidden_size 3584; off the repository's
# models), whose NS Gram contracts 152,064 rows; and a vocabulary head of
# that size's grad-input over 4096 tokens (4096 x K 152064 -> 3584)
LONG_LEAF = (152064, 3584)
LONG_HEAD_TOKENS = 4096
# the sources phases 4l and 4t's training cases run (``--phases-4l-4t``)
LONG_SOURCES = NT_SOURCES + ("blockdiag_mm", "blockdiag_i8_mm")
# phase 4t's training cases on the 2 + 2-block slice: (label, recipe (None:
# phase 4e's int8 model's slice), mesh shape, rules, required launches).
# uint8 in groups of 128 with the quantized matmul: the column-parallel
# grad-input quantizes W's columns by their all-reduced ranges, the
# row-parallel layers their input rows and re-quantized weight rows
# (B1's given range); int8 in groups of 128: the row-parallel weight
# re-quantized against its whole rows' scale (B1's given scale); the
# uint4 + SVD r32 recipe (converted to training without its SVD, as in
# both packages; its packed row-parallel layers are replicated, a packed
# row spanning the whole input); the int8 model's linears fsdp-sharded.
TP_TRAIN_CASES = (
    ("uint8_g128", dict(weights_dtype="uint8", group_size=128,
                        use_quantized_matmul=True), {"tensor": 2}, "tp",
     ("scaled_mm_tn", "scaled_gemm:nn", "quantize_rows:given_scale")),
    ("int8_g128", dict(weights_dtype="int8", group_size=128,
                       use_quantized_matmul=True), {"tensor": 2}, "tp",
     ("scaled_mm_tn", "scaled_gemm:nn", "quantize_rows:given_scale")),
    ("uint4_svd_r32", dict(weights_dtype="uint4", use_svd=True, svd_rank=32,
                           use_quantized_matmul=True), {"tensor": 2}, "tp",
     ("scaled_mm_tn", "scaled_gemm:nn")),
    ("fsdp", None, {"fsdp": 2}, "fsdp",
     ("scaled_mm_tn", "scaled_gemm:nn", "quantize_rows:colscale",
      "scaled_gemm")),
)


def _long_codes(torch, shape, g, dev, lines, dim):
    """Random int8 codes with ``lines`` (index, code) of rows (dim 0) or
    columns (dim 1) set to one extreme code, so that sums along them pass
    2^31, which an int32 sum would wrap."""
    x = torch.randint(-128, 128, shape, device=dev, generator=g,
                      dtype=torch.int8)
    for i, c in lines:
        x.select(dim, i).fill_(c)
    return x


def long_rows(torch, dev, g, t, record):
    """Phase 3's rows of phase 4l, each bit-equal to its plain version
    (limit 0) where lines of -128 and 127 make sums past 2^31: B10 at
    linear1's grad-weight over LONG_TOKENS in parts; B4 nt at the NS Gram of a
    LONG_LEAF leaf, B4 nn at its vocabulary head's grad-input (off the
    paths), and B4 nt just under 2^17, the plan unchanged (off the
    paths); each beside ``torch._int_mm`` on operands laid out for it."""
    from sdnq_tpu_torch.kernels import scaled_mm as ks
    runs = t.runs
    src, rep = ("sdnq_tpu_torch/csrc/scaled_mm.cu",
                "sdnq_tpu/kernels/scaled_mm.py:57")
    # in the fault phase, for the faults of the long modes' keys alone
    if runs("scaled_mm_tn") and t.fresh("scaled_mm_tn:parts"):
        m, (k, n) = LONG_TOKENS, LONG_LINEAR   # out (N, K) = (21504, 3072)
        a = _long_codes(torch, (m, n), g, dev, ((0, -128), (1, 127)), 1)
        b = _long_codes(torch, (m, k), g, dev, ((0, -128), (1, -128)), 1)
        a_s = torch.rand(n, device=dev, generator=g) * 1e-5 + 1e-7
        b_s = torch.rand(k, device=dev, generator=g) * 1e-3 + 1e-5
        raw = ks.scaled_mm_tn_plain(a[:, :2], b[:, :2])
        check(float(raw.abs().max()) > 2 ** 31, "long B10 row: sums past "
              f"2^31 ({float(raw.abs().max()):.4g})")
        want = ks.scaled_mm_tn_plain(a, b, a_s, b_s)
        err = float((ks.scaled_mm_tn(a, b, a_s, b_s) - want).abs().max())
        del want
        at, bt = a.t().contiguous(), b.t().contiguous().t()

        def library():
            return torch._int_mm(at, bt)
        lib_ms = yardstick_ms(t, library, "scaled_mm_tn long")
        record("scaled_mm_tn", "cuda", "sdnq_tpu_torch/csrc/scaled_mm_tn.cu",
               "sdnq_tpu/kernels/scaled_mm.py:534", err, 0.0,
               lambda: ks.scaled_mm_tn(a, b, a_s, b_s),
               t.once(lambda: ks.scaled_mm_tn_plain(a, b, a_s, b_s)),
               bound_ms(m * n + m * k + 4 * n * k + 4 * (n + k),
                        2 * m * n * k, "int8"),
               lib_ms, f"M{m} N{n} K{k} int8, sums past 2^31 (linear1 "
               f"grad-weight at batch 32, {ks.long_parts(m)} parts)",
               path="long", count="scaled_mm_tn:parts",
               library_fn=library if lib_ms else None)
        del a, b, at, bt
        torch.cuda.empty_cache()
    if not (runs("scaled_mm") and t.fresh("scaled_gemm:long")):
        return
    vocab, hidden = LONG_LEAF
    for kk, on_path in ((vocab, True), ((1 << 17) - 128, False)):
        a = _long_codes(torch, (hidden, kk), g, dev,
                        ((0, -128), (1, 127)), 0)
        xs = torch.rand(hidden, 1, device=dev, generator=g) * 1e-6 + 1e-8
        ws = torch.rand(hidden, 1, device=dev, generator=g) * 1e-6 + 1e-8
        got = ks.scaled_mm(a, a, xs, ws, out_dtype=torch.float32)
        want = ks.scaled_gemm_plain(a, a, torch.float32, xs, ws)
        err = float((got - want).abs().max())
        del got, want
        parts = ks.long_parts(kk)
        record("scaled_gemm", "cuda", src, rep, err, 0.0,
               lambda a=a, xs=xs, ws=ws: ks.scaled_mm(
                   a, a, xs, ws, out_dtype=torch.float32),
               t.once(lambda: ks.scaled_gemm_plain(a, a, torch.float32, xs,
                                                   ws)),
               _ns_bound([(hidden, hidden, kk)]),
               t(lambda a=a: torch._int_mm(a, a.t())),
               f"M{hidden} N{hidden} K{kk} int8 fp32 out, Muon NS Gram "
               f"({parts} part{'s' if parts > 1 else ''} a tile)",
               on_path=on_path, path="muon_long",
               count="scaled_gemm:long" if on_path else "scaled_gemm")
        del a
    m = LONG_HEAD_TOKENS
    a = _long_codes(torch, (m, vocab), g, dev, ((0, -128), (1, 127)), 0)
    b = _long_codes(torch, (vocab, hidden), g, dev, ((0, -128), (1, -128)),
                    1)
    xs = torch.rand(m, 1, device=dev, generator=g) * 1e-6 + 1e-8
    got = ks.scaled_gemm(a, b, torch.float32, xs, b_layout="nn")
    want = ks.scaled_gemm_plain(a, b, torch.float32, xs, b_layout="nn")
    err = float((got - want).abs().max())
    del got, want
    b_cm = b.t().contiguous().t()

    def library():
        return torch._int_mm(a, b_cm)
    lib_ms = yardstick_ms(t, library, "scaled_gemm nn long")
    nb, whole, splits = ks.nn_plan(m, hidden, vocab, torch.int8,
                                   ks._sm_count(a.device))
    record("scaled_gemm", "cuda", src, rep, err, 0.0,
           lambda: ks.scaled_gemm(a, b, torch.float32, xs, b_layout="nn"),
           t.once(lambda: ks.scaled_gemm_plain(a, b, torch.float32, xs,
                                               b_layout="nn")),
           bound_ms(m * vocab + vocab * hidden + 4 * m * hidden + 4 * m,
                    2 * m * vocab * hidden, "int8"),
           lib_ms, f"M{m} K{vocab} N{hidden} int8 nn (a vocabulary head's "
           "grad-input)", on_path=False, count="scaled_gemm:nn",
           library_fn=library if lib_ms else None,
           plan=f"128 x {128 * nb} tiles, {whole} whole, every tile split "
           f"{splits} ways")
    del a, b, b_cm
    torch.cuda.empty_cache()


def long_qlinear_path(torch, dev):
    """Phase 4l: a trainable int8 ``qlinear`` at FLUX.1-dev's linear1
    width with the quantized matmul (``train_qlinear``), forward and
    backward over LONG_TOKENS tokens (B1, B4 nt, B1 colscale + B4 nn, B10
    in parts); the output and the input gradient of the first 4608 rows (each row its own quantization) and the whole weight
    gradient held against the plain versions on the card, bit-equal.
    Returns the launch counts."""
    from sdnq_tpu_torch import quantize_tensor
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.kernels import scaled_mm as ks
    from sdnq_tpu_torch.layers import qlinear
    from sdnq_tpu_torch.train import matmul as tm
    g = torch.Generator(device=dev).manual_seed(60)
    k, n = LONG_LINEAR
    qt = quantize_tensor(torch.randn(n, k, device=dev, generator=g) * 0.02,
                         "int8", use_quantized_matmul=True)
    w = tm.TrainQTensor(qt=qt, delta=tm.grad_carrier((n, k), dev))
    x = torch.randn(LONG_TOKENS, k, device=dev,
                    generator=g).bfloat16().requires_grad_()
    gy = torch.randn(LONG_TOKENS, n, device=dev, generator=g).bfloat16()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    y = tm.train_qlinear(x, w)
    ev[1].record()
    y.backward(gy)
    ev[2].record()
    torch.cuda.synchronize()
    counts = launch_counts()
    rec = dict(tokens=LONG_TOKENS, width=list(LONG_LINEAR),
               forward_ms=ev[0].elapsed_time(ev[1]),
               backward_ms=ev[1].elapsed_time(ev[2]),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches={key: v for key, v in counts.items() if v})
    rows = slice(0, 4608)
    y_head = y[rows].clone()
    del y
    gx, gw = x.grad, w.delta.grad
    with plain_versions():
        ok_y = torch.equal(qlinear(x[rows].detach(), qt), y_head)
        ok_x = torch.equal(tm._grad_input(gy[rows], qt, torch.bfloat16)
                           .to(torch.bfloat16), gx[rows])
        want = ks.dynamic_mm_tn(gy, x.detach(), "int8")
        ok_w = torch.equal(want.reshape(gw.shape), gw)
    rec.update(output_equal=ok_y, grad_input_equal=ok_x,
               grad_weight_equal=ok_w,
               finite=bool(torch.isfinite(gw).all() and
                           torch.isfinite(gx).all()))
    log("long qlinear: " + json.dumps(rec))
    check(ok_y and ok_x and ok_w and rec["finite"],
          "long qlinear: output, grad-input and grad-weight bit-equal to "
          "the plain versions on the card, finite")
    for key in ("scaled_mm_tn:parts", "scaled_gemm:nt",
                "scaled_gemm:nn", "quantize_rows:colscale"):
        check(counts[key] > 0, f"long qlinear launched {key}")
    del x, gy, gx, gw, want, w, qt
    torch.cuda.empty_cache()
    return counts


def long_muon_path(torch, dev):
    """Phase 4n at a long side: one Muon step (``use_quantized_matmul_ns``,
    fp32 state) on a LONG_LEAF leaf, its NS worked on as 3584 x 152064, so
    that each of its 5 steps' Gram contracts 152,064 rows on B4 in parts;
    held bit-equal to the same step through the plain versions on the
    card.  Returns the launch counts."""
    import importlib
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    tm = importlib.import_module("sdnq_tpu_torch.optim.muon")
    g = torch.Generator(device=dev).manual_seed(61)
    w0 = torch.randn(*LONG_LEAF, device=dev, generator=g) * 0.02
    grad = torch.randn(*LONG_LEAF, device=dev, generator=g) * 1e-3

    def step():
        p = {"embed": w0.clone().requires_grad_()}
        p["embed"].grad = grad
        opt = tm.muon(lr=MUON_LR, use_quantized_matmul_ns=True)
        opt.update(None, opt.init(p), p)
        return p["embed"].detach()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    with plain_versions():
        want = step()
    rec = dict(leaf=list(LONG_LEAF), seconds=secs,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               b4_launches=counts["scaled_gemm"],
               b4_long_launches=counts["scaled_gemm:long"],
               moved=float((got - w0).abs().max()),
               equal=torch.equal(got, want))
    log("long muon: " + json.dumps(rec))
    check(rec["equal"] and rec["moved"] > 0, "long muon: the step moved "
          "the leaf, bit-equal to the plain NS on the card")
    check(counts["scaled_gemm:long"] == 5, "long muon: one long B4 Gram "
          f"each NS step ({counts['scaled_gemm:long']} of 5)")
    del w0, grad, got, want
    torch.cuda.empty_cache()
    return counts


def build_train_slice(torch, dev, qconfig: dict):
    """The 2 + 2-block FLUX.1-dev slice at full width, bf16 weights from a
    seeded generator quantized by ``qconfig``, converted to training, and
    its config."""
    from sdnq_tpu_torch import QuantConfig, quantize_model
    from sdnq_tpu_torch.models.dit import init_dit
    from sdnq_tpu_torch.train import convert_model_to_training
    cfg = train_config((2, 2))
    params = init_dit(cfg, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(62))
    qparams, _ = quantize_model(params, QuantConfig(**qconfig),
                                arch="FluxTransformer2DModel", device=dev)
    del params
    return convert_model_to_training(qparams), cfg


def tp_train_cases(torch, dev, int8_slice):
    """Phase 4t's training cases (TP_TRAIN_CASES), each against the
    unsharded step at the TP x DP step's limits of loss and gradients;
    returns their readings."""
    from sdnq_tpu_torch.parallel import DIT_TP_RULES
    out = {}
    for label, qc, shape, kind, required in TP_TRAIN_CASES:
        sliced = int8_slice if qc is None else build_train_slice(
            torch, dev, qc)
        rules = (DIT_TP_RULES if kind == "tp"
                 else {key: "fsdp" for key in DIT_TP_RULES})
        torch.cuda.reset_peak_memory_stats()
        out[label] = tp_train_phase(torch, dev, sliced, label, shape, rules,
                                    required, codes=False)
        del sliced
        torch.cuda.empty_cache()
    return out


# Phase 4t's layer check: FLUX.1-dev's MLP widths (fc1 3072 -> 12288
# column parallel, fc2 12288 -> 3072 row parallel) over one 1024x1024
# image's 4608 tokens, bf16 activations, at virtual T = 2, in each recipe
TP_LAYER_SHAPE = (4608, 3072, 12288)
TP_LAYER_RECIPES = {"uint8_g128": dict(fmt="uint8", group_size=128),
                    "int8_g128": dict(fmt="int8", group_size=128)}
# Its limits, each reading of a recipe (the output z, the weight gradients
# gw, the input gradient gx; the largest error over the largest value, and
# the error's norm over the norm), about twice the readings (H100, 700 W):
# uint8 z 3.4e-3 and 1.1e-4, gw 1.5e-7, gx 6.9e-3 and 2.8e-3 (the
# unsharded layer rounds its product to bf16 before it adds the zero
# points' rank-1 term, the shards' fp32 sum once); int8 z 1.7e-3 and
# 1.3e-5, gw 1.5e-7, gx 1.7e-3 and 1.2e-5 (bf16 roundings of fp32 sums in
# another order).  A shard quantized by its own statistics reads about
# 1e-2 in the norm.
TP_LAYER_TOL = {
    **{f"uint8_g128_{k}": v for k, v in (
        ("z_max", 7e-3), ("z_rms", 2.5e-4), ("gw_max", 4e-7),
        ("gx_max", 1.4e-2), ("gx_rms", 6e-3))},
    **{f"int8_g128_{k}": v for k, v in (
        ("z_max", 4e-3), ("z_rms", 3e-5), ("gw_max", 4e-7),
        ("gx_max", 4e-3), ("gx_rms", 3e-5))}}


def _tp_mlp(torch, p, x):
    from sdnq_tpu_torch.models.dit import _lin
    return _lin(p["fc2"], torch.nn.functional.gelu(_lin(p["fc1"], x),
                                                   approximate="tanh"))


def tp_layer_phase(torch, dev):
    """Phase 4t's layer check: a trainable MLP (TP_LAYER_SHAPE; fc1 column
    parallel, fc2 row parallel, the quantized matmul) forward and backward
    at virtual T = 2 against the same layers unsharded, on the same inputs
    and cotangent: each shard's activation rows and re-quantized weight
    rows (fc2) and its uint8 / int8 grad-input operands (fc1) quantized by
    the whole rows' and columns' statistics, so that the output, the
    weight gradients and the input gradient equal the unsharded layers'
    but for fp32 sums in another order (one bf16 rounding at most).
    Where the whole step moves quantization codes at ties, this holds each
    sharded statistic at one layer.  Returns the readings (TP_LAYER_TOL's
    keys)."""
    from sdnq_tpu_torch import quantize_tensor
    from sdnq_tpu_torch.parallel import shard_params
    from sdnq_tpu_torch.parallel._collectives import run_virtual
    from sdnq_tpu_torch.parallel.dryrun import whole_grads
    from sdnq_tpu_torch.parallel.tp import local_tree
    from sdnq_tpu_torch.train import (
        convert_model_to_training, extract_weight_grads,
    )
    from sdnq_tpu_torch.tree import tree_leaves
    m, d, h = TP_LAYER_SHAPE
    rules, shape = {"fc1": "col", "fc2": "row"}, {"tensor": 2}

    def rd(a, b):
        a, b = a.float(), b.float()
        return (float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)),
                float((a - b).norm() / b.norm().clamp_min(1e-30)))
    out = {}
    for name, kw in TP_LAYER_RECIPES.items():
        kw = dict(kw)
        fmt = kw.pop("fmt")
        g = torch.Generator(device=dev).manual_seed(62)
        tree = {k: {"weight": quantize_tensor(
            torch.randn(o, i, device=dev, generator=g) * 0.02, fmt,
            use_quantized_matmul=True, **kw),
            "bias": torch.randn(o, device=dev, generator=g) * 0.01}
            for k, (o, i) in (("fc1", (h, d)), ("fc2", (d, h)))}
        x = torch.randn(m, d, device=dev, generator=g).bfloat16()
        gz = torch.randn(m, d, device=dev, generator=g)
        t = convert_model_to_training(tree)
        xx = x.clone().requires_grad_()
        z0 = _tp_mlp(torch, t, xx)
        (z0.float() * gz).sum().backward()
        g0 = [v for v in tree_leaves(extract_weight_grads(t))
              if v is not None]
        t = convert_model_to_training(tree)
        shs = run_virtual(lambda mesh: shard_params(t, mesh, rules), shape,
                          dev.type)
        xs = [x.clone().requires_grad_() for _ in shs]
        zs = run_virtual(lambda mesh: _tp_mlp(
            torch, local_tree(shs[mesh.index]), xs[mesh.index]), shape,
            dev.type)
        torch.stack([(z.float() * gz).sum() for z in zs]).sum().backward()
        with torch.no_grad():
            g1 = [v for v in run_virtual(lambda mesh: whole_grads(
                shs[mesh.index]), shape, dev.type)[0] if v is not None]
        check(len(g1) == len(g0) == 4, f"tp layers {name}: 4 gradients")
        zr, xr = rd(zs[0], z0), rd(xs[0].grad, xx.grad)
        out.update({f"{name}_z_max": zr[0], f"{name}_z_rms": zr[1],
                    f"{name}_gw_max": max(rd(a, b)[0]
                                          for a, b in zip(g1, g0)),
                    f"{name}_gx_max": xr[0], f"{name}_gx_rms": xr[1]})
        del tree, t, shs, xs, zs, z0, xx, g0, g1
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log("tp layers: virtual T 2 against the unsharded layers: "
        + json.dumps(out))
    for key, lim in TP_LAYER_TOL.items():
        check(out[key] <= lim, f"tp layers: {key} {out[key]:.3e} <= "
              f"{lim:.1e}")
    return out


def long_phases(torch, dev, mark):
    """``--phases-4l-4t``: phase 4l (the long qlinear, the long Muon step)
    and phase 4t's training cases on an int8 2 + 2-block slice built
    here; returns the counts by path label."""
    counts = {"long": long_qlinear_path(torch, dev),
              "muon_long": long_muon_path(torch, dev)}
    mark("phase 4l")
    int8_slice = build_train_slice(torch, dev, dict(
        weights_dtype="int8", use_quantized_matmul=True))
    tp_train_cases(torch, dev, int8_slice)
    tp_layer_phase(torch, dev)
    mark("phase 4t's training cases")
    return counts


# ---------------------------------------------------------------------------
# phase 7: planted bugs that the checks of phases 3 and 5 must see
# ---------------------------------------------------------------------------

# (tag, source, kernel, slice, [(text, broken text)]): each a bug a kernel
# could ship with, the phase 3 count key of the rows it must fail, and the
# slice check that runs it.  An edit applies to the source's kernel file
# (KERNEL_FILES); one of (file, text, broken text) breaks another file of
# the source's build (common.cuh), for that build alone.
# The broken sources are built beside the real ones, swapped in one at a
# time, and phases 3 and 5 rerun against them.
FAULTS = (
    ("attn_skips_first_kv_tile", "flash_attn", "flash_attention", "int8",
     [("issue_pv<D>(of, p, v_stage(st));",
       "if (kv0 != 0) issue_pv<D>(of, p, v_stage(st));")]),
    ("attn_no_running_max_rescale_of_o", "flash_attn", "flash_attention",
     "int8", [("*= al0;", "*= 1.f;"), ("*= al1;", "*= 1.f;")]),
    ("gemm_drops_last_k_stage", "scaled_mm", "scaled_gemm", "int8",
     [("const int nk = (K + BKE - 1) / BKE;  // the k-stages of a tile",
       "const int nk = (K + BKE - 1) / BKE - 1;")]),
    ("b4_drops_the_n_tail", "scaled_mm", "scaled_gemm", "int8",
     [("hopper.cuh", "const int ncols = min(BN, N - n0);",
       "const int ncols = N - n0 < BN ? 0 : BN;")]),
    ("gemv_reduce_one_shuffle_short", "dequant_gemv", "dequant_gemv", "int8",
     [("off > 0; off >>= 1", "off > 1; off >>= 1")]),
    ("quantize_rounds_half_away", "quantize_rows", "quantize_rows", "int8",
     [("static_cast<int>(sdnq::quant_div(v, scale))",
       "static_cast<int>(roundf(__fdiv_rn(v, scale)))")]),
    ("quantize_ignores_the_given_scale", "quantize_rows",
     "quantize_rows:given_scale", "tp",
     [("if (a.gs) {", "if (false) {")]),
    ("quantize_without_the_division_fallback", "quantize_rows",
     "quantize_rows", "int8",
     [("if (near) {  // a quotient next to a half-integer: the division decides",
       "if (false) {  // a quotient next to a half-integer: the division decides")]),
    ("groupdot_decodes_the_other_nibble", "decode_weight", "groupdot_mm",
     "uint4_wo", [("const unsigned sh = hs.width[p] * t;",
                   "const unsigned sh = (hs.width[p] * t) ^ 4;")]),
    ("blockdiag_scale_of_the_previous_group", "blockdiag_mm", "blockdiag_mm",
     "uint4_wo", [("sc[r] = __ldg(a.scale + (size_t)o * a.G + gi);",
                   "sc[r] = __ldg(a.scale + (size_t)o * a.G + (gi + a.G - 1) % a.G);"
                   )]),
    ("groupdot_i8_keeps_the_other_field_bits", "decode_weight",
     "groupdot_i8_mm", "uint4_qmm",
     [("c[j] |= ((byte >> sh) & mask) << hs.shift[p];",
       "c[j] |= (byte >> sh) << hs.shift[p];")]),
    ("attn_mask_ignored_on_first_tile", "flash_attn",
     "flash_attention:masked", "llm_bf16kv",
     [("if (MASKED && keep && (!EDGE || col < a.KN)) {",
       "if (MASKED && keep && !EDGE) {")]),
    ("attn_masked_skips_a_middle_kv_tile", "flash_attn",
     "flash_attention:masked", "llm_bf16kv",
     [("bool keep = true;\n      if constexpr (EDGE)",
       "bool keep = !(MASKED && kv0 == 384);\n      if constexpr (EDGE)")]),
    ("attn_causal_skips_a_middle_kv_tile", "flash_attn",
     "flash_attention:causal", "llm_causal",
     [("bool keep = true;\n      if constexpr (EDGE)",
       "bool keep = !(a.causal && kv0 == 384);\n      if constexpr (EDGE)")]),
    ("attn_p_scale_per_64_key_tile", "flash_attn", "flash_attention:int8_pv",
     "llm_int8kv", [("const int PB = a.pblock;", "const int PB = TBN;")]),
    ("attn_causal_skip_one_tile_early", "flash_attn",
     "flash_attention:causal", "llm_causal",
     [("return a.causal ? min(a.KN, q0 + bq) : a.KN;",
       "return a.causal ? min(a.KN, q0 + bq - 128) : a.KN;")]),
    ("attn_gqa_head_modulo", "flash_attn", "flash_attention:int8_pv",
     "llm_int8kv", [("return (bh / a.H) * KH + hh / a.qpk;",
                     "return (bh / a.H) * KH + hh % KH;")]),
    ("blockdiag_i8_scale_of_the_previous_group", "blockdiag_i8_mm",
     "blockdiag_i8_mm", "qlinear_b8",
     [("(size_t)(col < a.N ? col : 0) * a.G + e0 + j,",
       "(size_t)(col < a.N ? col : 0) * a.G + (q < BN ? (e0 + j + a.G - 1) "
       "% a.G : e0 + j),")]),
    ("b8_ignores_the_second_field_plane", "blockdiag_i8_mm",
     "blockdiag_i8_mm", "qlinear_b8",
     [("m4[p] = p < hs.n ? 0x01010101u", "m4[p] = p < 1 ? 0x01010101u")]),
    ("tn_drops_the_m_tail", "scaled_mm_tn", "scaled_mm_tn", "train",
     [("const int nk = (M + tok - 1) / tok;  // the stages of a tile",
       "const int nk = M / tok;")]),
    ("tn_swaps_a_and_b_scales", "scaled_mm_tn", "scaled_mm_tn", "train",
     [("sa[hr] = ep.as ? __ldg(ep.as + min(nk0.x + rl + 8 * hr, N - 1)) : 1.f;",
       "sa[hr] = ep.bs ? __ldg(ep.bs + min(nk0.x + rl + 8 * hr, N - 1) % K) : 1.f;"),
      ("sb[e] = ep.bs ? __ldg(ep.bs + min(k0 + e, K - 1)) : 1.f;",
       "sb[e] = ep.as ? __ldg(ep.as + min(k0 + e, K - 1) % N) : 1.f;")]),
    ("tn_transpose_swaps_a_byte_lane", "scaled_mm_tn", "scaled_mm_tn",
     "train", [("hopper.cuh", "x1 = rr & 2 ? 0x3276u : 0x7632u;",
                "x1 = rr & 2 ? 0x3276u : 0x6732u;")]),
    ("colscale_ignored", "quantize_rows", "quantize_rows:colscale", "train",
     [("for (int e = 0; e < EPV; ++e) f[e] = __fmul_rn(f[e], c[e]);",
       "for (int e = 0; e < EPV; ++e) f[e] = __fmul_rn(f[e], 1.f);")]),
    ("nn_transpose_swaps_a_byte_lane", "scaled_mm", "scaled_gemm:nn", "train",
     [("hopper.cuh", "x1 = rr & 2 ? 0x3276u : 0x7632u;",
       "x1 = rr & 2 ? 0x3276u : 0x6732u;")]),
    ("nn_split_drops_the_last_slice", "scaled_mm", "scaled_gemm:nn", "train",
     [("w.kb1 = ((w.split + 1) * p.nk) / p.splits;",
       "w.kb1 = w.split == p.splits - 1 && p.splits > 1 ? w.kb0 : ((w.split + 1) * p.nk) / p.splits;")]),
    ("nn_split_keeps_its_counters", "scaled_mm", "scaled_gemm:nn", "train",
     [("        if (*last) counters[w.part] = 0;", "")]),
    ("b4_long_sum_in_int32", "scaled_mm", "scaled_gemm:long", "muon",
     [("hopper.cuh", "long long s0 = acc[i], s1 = acc[i + 1];",
       "int s0 = acc[i], s1 = acc[i + 1];")]),
    ("b4_long_drops_the_last_part", "scaled_mm", "scaled_gemm:long", "muon",
     [("hopper.cuh",
       "return make_int2((part * nk) / parts, ((part + 1) * nk) / parts);",
       "return make_int2((part * nk) / parts, parts > 1 && part == parts - 1"
       " ? (part * nk) / parts : ((part + 1) * nk) / parts);")]),
    ("tn_long_sum_in_int32", "scaled_mm_tn", "scaled_mm_tn:parts", "train",
     [("hopper.cuh", "long long s0 = acc[i], s1 = acc[i + 1];",
       "int s0 = acc[i], s1 = acc[i + 1];")]),
    ("nn_drops_the_m_tail", "scaled_mm", "scaled_gemm:nn", "train",
     [("tensor_map(&ta, a, M, K, lda, BM, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 128)",
       "tensor_map(&ta, a, M > BM ? M - M % BM : M, K, lda, BM, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 128)")]),
    ("b2_scale_of_the_next_group", "decode_weight", "dequant_mm:grouped",
     "pipeline", [("const float s = scale[(size_t)n * G + gi];",
                   "const float s = scale[(size_t)n * G + (gi + 1) % G];")]),
    ("b2_drops_the_zero_point", "decode_weight", "dequant_mm:grouped",
     "pipeline", [("v[j] = zp ? __fmaf_rn(w, s, z) : __fmul_rn(w, s);",
                   "v[j] = __fmul_rn(w, s);")]),
    ("attn_float_mask_ignored_on_one_tile", "flash_attn",
     "flash_attention:float_mask", "pipeline",
     [("x = __fadd_rn(x, __fmul_rn(mv[e], kLog2e));",
       "x = kv0 == 128 ? x : __fadd_rn(x, __fmul_rn(mv[e], kLog2e));")]),
    ("attn_float_mask_without_log2e", "flash_attn",
     "flash_attention:float_mask", "pipeline",
     [("__fmul_rn(mv[e], kLog2e)", "mv[e]")]),
    ("b2_bitplane_planes_reversed", "decode_weight", "dequant_mm:bitplane",
     "dyn_r1", [("row + (size_t)j * S + b", "row + (size_t)(bits - 1 - j) * S + b")]),
    ("b2_minifloat_flushes_subnormals", "decode_weight", "dequant_mm:bitplane",
     "dyn_r1", [("common.cuh", "return __fmul_rn(__uint_as_float(b), f.pow2);",
                 "return __fmul_rn(__uint_as_float(b & 0x7f800000u ? b : 0u), "
                 "f.pow2);")]),
    ("b5_ignores_the_second_field_plane", "decode_weight",
     "groupdot_mm:multiplane", "dyn_r2",
     [("if (p < hs.n) {", "if (p < 1) {")]),
    ("gemm_full_barrier_phase_off_by_one", "wgmma_mm", "wgmma_mm:bias",
     "pipeline", [("mbar_wait(&full[s], ph);", "mbar_wait(&full[s], ph ^ 1);")]),
    ("b5_group_restarts_one_k_step_late", "wgmma_mm", "wgmma_mm:fold",
     "uint4_wo", [("mma128<AT>(p, da + 2 * kk, db + 2 * kk, step != 0);",
                   "mma128<AT>(p, da + 2 * kk, db + 2 * kk, step != 1);")]),
    ("gemm_epilogue_drops_the_n_tail", "wgmma_mm", "wgmma_mm:tail",
     "pipeline", [("hopper.cuh", "const int ncols = min(BN, N - n0);",
                   "const int ncols = N - n0 < BN ? 0 : BN;")]),
    ("b6_drops_the_minifloat_sign", "blockdiag_mm", "blockdiag_mm:minifloat",
     "dyn_r2", [("tab[i] = a.table[i];", "tab[i] = fabsf(a.table[i]);")]),
    ("b6_minifloat_table_one_entry_off", "blockdiag_mm",
     "blockdiag_mm:minifloat", "dyn_r2",
     [("tab[(c4 >> (8 * e)) & 0xFFu]",
       "tab[((c4 >> (8 * e)) + 1) & ((1u << BITS) - 1u)]")]),
    ("b7_fold_takes_the_next_groups_xsum", "wgmma_mm", "groupdot_i8_mm",
     "uint4_qmm", [("xsum + (size_t)gi * M + (row < M ? row : 0)",
                    "xsum + (size_t)((gi + 1) % (K / g)) * M + "
                    "(row < M ? row : 0)")]),
    ("b7_partial_not_restarted_at_group_end", "wgmma_mm", "groupdot_i8_mm",
     "uint4_qmm", [("const int acc_in = ka != k0;", "const int acc_in = ka != 0;")]),
    ("gemv_bitplane_planes_reversed", "dequant_gemv", "dequant_gemv:bitplane",
     "dyn_r1", [("const uint8_t* p = wr + (size_t)j * S + b;",
                 "const uint8_t* p = wr + (size_t)(bits - 1 - j) * S + b;")]),
    # one code late within the row: a read past the end of x can land on
    # unmapped memory, and the illegal address ends the whole run
    ("gemv_bitplane_x_one_code_late", "dequant_gemv", "dequant_gemv:bitplane",
     "dyn_r1", [("sdnq::to_f32(x[(size_t)(r >> 3) * K + (size_t)i * S + b])",
                 "sdnq::to_f32(x[(size_t)(r >> 3) * K + ((size_t)i * S + b + 1) % K])")]),
    ("b9_writes_acc_normalised", "flash_attn", "flash_attention_block",
     "ring",
     [("make_float2(o_acc[dt][0], o_acc[dt][1]);",
       "make_float2(o_acc[dt][0] / l0, o_acc[dt][1] / l0);"),
      ("make_float2(o_acc[dt][2], o_acc[dt][3]);",
       "make_float2(o_acc[dt][2] / l1, o_acc[dt][3] / l1);")]),
    ("b9_m_in_base_2_units", "flash_attn", "flash_attention_block", "ring",
     [("a.m_out[bh * a.N + r0] = m0;",
       "a.m_out[bh * a.N + r0] = m0 * kLog2e;"),
      ("a.m_out[bh * a.N + r1] = m1;",
       "a.m_out[bh * a.N + r1] = m1 * kLog2e;")]),
    ("b9_takes_b3s_base_2_exponent", "flash_attn", "flash_attention_block",
     "ring", [("return NATURAL ? expf(x) : exp2f(x);", "return exp2f(x);")]),
    ("b9_token_l_not_rescaled_by_alpha", "flash_attn",
     "flash_attention_block", "ring",
     [("l0 = __fadd_rn(__fmul_rn(l0, al0), ps0);", "l0 = __fadd_rn(l0, ps0);"),
      ("l1 = __fadd_rn(__fmul_rn(l1, al1), ps1);",
       "l1 = __fadd_rn(l1, ps1);")]),
    ("tok_mask_of_the_next_row_on_one_tile", "flash_attn",
     "flash_attention:int8_pv", "llm_int8kv",
     [("false>(s, sks + (kv0 - pb0), qs0, qs1, a, kv0, r0, r1,\n"
       "                                                mr0, mr1, t4);",
       "false>(s, sks + (kv0 - pb0), qs0, qs1, a, kv0, r0, r1,\n"
       "                                                kv0 == 128 ? mr1 : mr0, mr1, t4);")]),
    ("tok_causal_diagonal_tile_unmasked", "flash_attn",
     "flash_attention:int8_pv", "llm_causal",
     [("if (a.causal && kv0 + TBN > q0)  // the tile of the diagonal",
       "if (a.causal && kv0 + TBN > q0 + TBM)  // the tile of the diagonal")]),
    ("tok_vt_slots_in_another_order", "flash_attn", "flash_attention:int8_pv",
     "llm_int8kv", [("+ (pos & 1) + 8 * ((pos >> 1) & 1);",
                     "+ ((pos >> 1) & 1) + 8 * (pos & 1);")]),
    ("gemv_scale_of_the_next_group", "dequant_gemv", "dequant_gemv:grouped",
     "pipeline",
     [("min(sdnq::div_magic(k0, a.g, a.ginv), a.G - 1);",
       "(min(sdnq::div_magic(k0, a.g, a.ginv), a.G - 1) + 1) % a.G;"),
      ("const int gi = min(sdnq::div_magic(min(k, K - 1), a.g, a.ginv), a.G - 1);",
       "const int gi = (min(sdnq::div_magic(min(k, K - 1), a.g, a.ginv), a.G - 1) + 1) % a.G;")]),
    ("gemv_k_split_drops_the_last_slice", "dequant_gemv", "dequant_gemv",
     "llm_int8kv", [("for (int j = 1; j < S; ++j) {",
                     "for (int j = 1; j < S - 1; ++j) {"),
                    ("for (int p = 1; p < S; ++p) {",
                     "for (int p = 1; p < S - 1; ++p) {")]),
    ("attn_k_stage_parity_flipped", "flash_attn", "flash_attention", "int8",
     [("mbar_wait(&k_full[i % ST], (i / ST) & 1);",
       "mbar_wait(&k_full[i % ST], ((i / ST) & 1) ^ 1);")]),
    ("attn_pv_reads_the_previous_v_stage", "flash_attn", "flash_attention",
     "int8", [("issue_pv<D>(of, p, v_stage(st));",
               "issue_pv<D>(of, p, v_stage((st + ST - 1) % ST));")]),
    ("attn_second_warpgroup_stores_the_first_ones_rows", "flash_attn",
     "flash_attention", "int8",
     [("(a, bh, r0, r1, t4, o, l0, l1);",
       "(a, bh, r0 - 64 * wg, r1 - 64 * wg, t4, o, l0, l1);")]),
    ("attn_head_mode_drops_the_log2_127_shift", "flash_attn",
     "flash_attention:head_pv", "unet",
     [("__fsub_rn(mn0, kLog2_127)", "mn0"),
      ("__fsub_rn(mn1, kLog2_127)", "mn1")]),
    ("attn_e4m3_takes_the_next_keys_scale", "flash_attn_e4m3",
     "flash_attention:e4m3_qk", "unet",
     [("(x, i < 2 ? qs0 : qs1), sks[c]);",
       "(x, i < 2 ? qs0 : qs1), sks[c ^ 1]);")]),
    ("attn_d256_blocks_all_write_the_first_columns", "flash_attn_d256",
     "flash_attention:d256", "ring",
     [("const int c0 = blockIdx.z * NDT * 8;", "const int c0 = 0;")]),
    ("gemv_decodes_e5m2_as_e4m3", "dequant_gemv", "dequant_gemv:e5m2",
     "e5m2", [("e5m2 ? __NV_E5M2 : __NV_E4M3", "__NV_E4M3")]),
    ("decode_reads_e5m2_as_e4m3", "decode_weight", "dequant_mm:e5m2",
     "e5m2", [("  if constexpr (KIND == E5M2) {  // the high byte of an fp16",
               "  if constexpr (false) {  // the high byte of an fp16")]),
    ("bitplane_gemv_rounds_fp16_weights_through_bf16", "dequant_gemv",
     "dequant_gemv:fp16", "sd15_fp16",
     [("    const __half2 a = __floats2half2_rn(w[0], w[1]);",
       "    const __half2 a = __floats2half2_rn(__bfloat162float("
       "__float2bfloat16_rn(w[0])), w[1]);")]),
)

# Faults of the Python wrappers: (tag, module under sdnq_tpu_torch/, the
# csrc sources whose phase 3 rows rerun, kernel, slice, [(text, broken
# text)]).  The module is loaded again from its broken text in its place
# (``module_swapped``) while phase 3 and the slice rerun.  A kernel of
# None: a layout fault, which no kernel's row sees and its slice must
# catch.
PY_FAULTS = (
    ("muon_mm_quantizes_b_not_bT", "optim/muon.py", ("scaled_mm",),
     "muon_ns", "muon",
     [("b_q, b_s = quantize_int_mm(b.T.contiguous(), -1)",
       "b_q, b_s = quantize_int_mm(b.contiguous(), -1)")]),
    ("tp_qkv_heads_shifted_by_one", "parallel/sharding.py", (), None, "tp",
     [('    "qkv": lambda o, k: (o // 3,) * 3,',
       '    "qkv": lambda o, k: (o // 3 + 128, o // 3 - 128, o // 3),')]),
    ("tiles_cast_fp16_x_to_bf16", "kernels/dequant_mm.py",
     ("decode_weight", "wgmma_mm"), "dequant_mm:fp16", "sd15_fp16",
     [("    if is_cuda(x) and x.dtype == torch.float32:\n"
       "        return x.to(torch.bfloat16)",
       "    if is_cuda(x) and x.dtype != torch.bfloat16:\n"
       "        return x.to(torch.bfloat16)")]),
    ("attn_softmax_scale_of_the_padded_head_dim", "kernels/attention.py",
     ("flash_attn",), "flash_attention:padded", "llm100_int8kv",
     [("        scale = d ** -0.5",
       "        scale = kernel_head_dim(d) ** -0.5")]),
    ("tp_row_stats_by_shard", "parallel/tp.py", (), None, "tp_layers",
     [("c.amax if n > 1 else None", "(lambda v: v) if n > 1 else None")]),
    ("tp_grad_input_stats_by_shard", "parallel/tp.py", (), None,
     "tp_layers",
     [("train_backward(k, g, needs[3 * r:3 * r + 3], stats,",
       "train_backward(k, g, needs[3 * r:3 * r + 3], per[r],")]),
)


# Every fault build of the sources on csrc/hopper.cuh's barriers
# (WATCHED) gives up a barrier wait after 2^22 cycles (about 2 ms) and sets
# a flag, where the sound build traps after 2^36: a broken barrier then
# ends in a wrong result that phase 3 reads, not in a failed launch that
# ends the process.
WATCHED = ("wgmma_mm", "flash_attn", "flash_attn_e4m3", "flash_attn_d256",
           "scaled_mm",
           "scaled_mm_tn", "dequant_gemv")
WGMMA_WATCHDOG = (
    ("hopper.cuh", "// ---- mbarriers",
     "__device__ int g_watchdog;\n// ---- mbarriers"),
    ("hopper.cuh", "if (clock64() - t0 > TRAP_CYCLES) __trap();",
     "if (clock64() - t0 > (1ll << 22)) {\n      g_watchdog = 1;\n"
     "      return;\n    }"))
WGMMA_WATCHDOG_READER = """
// Whether a barrier wait gave up since the last call; clears the flag.
extern "C" int sdnq_wgmma_watchdog(int* fired) {
  const int zero = 0;
  cudaError_t err = cudaMemcpyFromSymbol(fired, sdnq::g_watchdog, sizeof(int));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(sdnq::g_watchdog, &zero, sizeof(int));
  return static_cast<int>(err);
}
"""


# The file a fault's (text, broken text) edits apply to: its source, or
# for the two flash attention libraries the kernels they share.
KERNEL_FILES = {"flash_attn": "flash_attn.cuh",
                "flash_attn_e4m3": "flash_attn.cuh",
                "flash_attn_d256": "flash_attn.cuh"}


def build_edits(src, edits) -> list:
    """A fault build's edits as (file, text, broken text): the fault's own,
    then the barrier watchdog where the source is WATCHED."""
    home = KERNEL_FILES.get(src, f"{src}.cu")
    out = [edit if len(edit) == 3 else (home, *edit) for edit in edits]
    if src in WATCHED:
        out += WGMMA_WATCHDOG
    return out


def watchdog_fired(lib_path) -> bool:
    """Whether a barrier wait of the fault build ``lib_path`` (of a source
    in WATCHED) gave up since the last call (clears the flag)."""
    import ctypes
    fired = ctypes.c_int(0)
    rc = ctypes.CDLL(str(lib_path)).sdnq_wgmma_watchdog(ctypes.byref(fired))
    if rc != 0:
        raise RuntimeError(f"sdnq_wgmma_watchdog: CUDA error {rc}")
    return bool(fired.value)


def start_fault_builds():
    """Write each source of FAULTS with its edits into
    _build/faults/<tag>/ and start its nvcc; returns {tag: (process,
    library path)}."""
    from sdnq_tpu_torch.kernels import _build
    csrc = ROOT / "sdnq_tpu_torch" / "csrc"
    entries = [(tag, src, build_edits(src, edits))
               for tag, src, _, _, edits in FAULTS]
    texts = {}
    for tag, src, edits in entries:  # every edit applies, or none builds
        files = {f: (csrc / f).read_text() for f in (f"{src}.cu",
                                                     *_build._HEADERS)}
        if src in WATCHED:
            files[f"{src}.cu"] += WGMMA_WATCHDOG_READER
        for name, old, new in edits:
            if old not in files[name]:
                raise RuntimeError(f"fault {tag}: {old!r} not in {name}")
            files[name] = files[name].replace(old, new)
        texts[tag] = files
    procs = {}
    for tag, src, _ in entries:
        d = _build.build_dir() / "faults" / tag
        d.mkdir(parents=True, exist_ok=True)
        for name, text in texts[tag].items():
            (d / name).write_text(text)
        lib = d / f"lib{src}.so"
        with open(d / "build.log", "w") as out:
            # at the lowest CPU priority: they build while the timed phases
            # run, and must not take the host from them
            procs[tag] = (subprocess.Popen(
                _build.command(d / f"{src}.cu", lib), stdout=out,
                stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(19)),
                lib)
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


def py_fault_text(rel, edits) -> str:
    """The text of sdnq_tpu_torch/``rel`` with ``edits`` applied; raises
    where one's text is not there."""
    text = (ROOT / "sdnq_tpu_torch" / rel).read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{rel}: {old!r} not found")
        text = text.replace(old, new)
    return text


@contextlib.contextmanager
def module_swapped(tag, rel, edits):
    """sdnq_tpu_torch/``rel`` loaded again from its broken text (written
    under _build/faults/<tag>/) under its own name, in its place in
    ``sys.modules`` and in its package, while the block runs."""
    import importlib.util
    from sdnq_tpu_torch.kernels import _build
    name = "sdnq_tpu_torch." + rel[:-3].replace("/", ".")
    parent, attr = name.rsplit(".", 1)
    path = _build.build_dir() / "faults" / tag / Path(rel).name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(py_fault_text(rel, edits))
    spec = importlib.util.spec_from_file_location(name, path)
    broken = importlib.util.module_from_spec(spec)
    real = sys.modules[name]
    sys.modules[name] = broken
    try:
        spec.loader.exec_module(broken)
        setattr(sys.modules[parent], attr, broken)
        yield
    finally:
        sys.modules[name] = real
        setattr(sys.modules[parent], attr, real)


def fault_phase(torch, dev, slices, procs):
    """Rerun phase 3 (untimed; the rows of the kernels built from the
    broken source) and phase 5's slice of the fault's path with each planted
    fault in place.  Phase 3 must fail for the broken kernel; phase 5's
    readings (on the slice whose path runs the kernel; ``slices`` maps a
    label to a function returning its readings) are reported beside their
    limits."""
    # every slice check's limits; "qlinear_b8" is the B8 qlinear check's
    all_tol = {**{k: {"max": v} for k, v in SLICE_TOL.items()},
               **LLM_SLICE_TOL, "qlinear_b8": {"max": 2 ** -7},
               "train": TRAIN_SLICE_TOL, "pipeline": PIPE_SLICE_TOL,
               "ring": {"max": RING_SLICE_TOL}, "unet": UNET_SLICE_TOL,
               "moe": {"max": MBO_TOL["moe_qmm"]},
               "tp": {"max": NT_TOL["tp_slice"],
                      "heads": NT_TOL["tp_heads"]},
               "muon": {"loss": NT_TOL["muon_slice_loss"],
                        "codes": NT_TOL["muon_slice_codes"]},
               "tp_layers": TP_LAYER_TOL,
               "sd15_fp16": {"max": MBO_TOL["sd15_fp16"]}}
    for tag, (proc, _) in procs.items():
        if proc.wait() != 0:
            check(False, f"fault {tag}: broken source built")
    if FAILURES:
        return
    results = []
    t0 = time.perf_counter()
    for tag, src, kernel, label, _ in FAULTS:
        sound = list(FAILURES)
        with library_swapped(src, procs[tag][1]):
            rows = kernel_phase(torch, dev, timed=False, only={src},
                                count=kernel)
            readings = slices[label]()
            # a broken ring may leave the GEMM's barrier waits to give up
            watchdog = src in WATCHED and watchdog_fired(procs[tag][1])
        FAILURES[:] = sound  # the checks were meant to fail here
        # a NaN reading fails its check too
        caught = [r for r in rows if not r["reading"] <= r["tolerance"]]
        tol = all_tol[label]
        results.append(dict(
            fault=tag, kernel=kernel,
            phase3_failed=[f"{r['count']} {r['shape']}: {r['reading']:.3e}"
                           f" > {r['tolerance']:.3e} (max_abs_err "
                           f"{r['max_abs_err']:.3e})" for r in caught],
            slice=label, slice_readings=readings, slice_tol=tol,
            slice_failed=sorted(k for k in tol if not readings[k] <= tol[k]),
            watchdog_fired=watchdog))
        check(any(r["count"] == kernel for r in caught),
              f"fault {tag}: phase 3 fails {kernel}")
    for tag, rel, sources, kernel, label, edits in PY_FAULTS:
        sound = list(FAILURES)
        with module_swapped(tag, rel, edits):
            rows = kernel_phase(torch, dev, timed=False, only=set(sources),
                                count=kernel) if sources else []
            readings = slices[label]()
        FAILURES[:] = sound  # the checks were meant to fail here
        caught = [r for r in rows if not r["reading"] <= r["tolerance"]]
        tol = all_tol[label]
        results.append(dict(
            fault=tag, kernel=kernel, module=rel,
            phase3_failed=[f"{r['count']} {r['shape']}: {r['reading']:.3e}"
                           f" > {r['tolerance']:.3e} (max_abs_err "
                           f"{r['max_abs_err']:.3e})" for r in caught],
            slice=label, slice_readings=readings, slice_tol=tol,
            slice_failed=sorted(k for k in tol if not readings[k] <= tol[k])))
        if kernel is None:   # a layout fault: its phase-5 slice must fail
            check(results[-1]["slice_failed"],
                  f"fault {tag}: phase 5's {label} slice fails")
        else:
            check(any(r["count"] == kernel for r in caught),
                  f"fault {tag}: phase 3 fails {kernel}")
    log("faults: " + json.dumps(results))
    log(f"fault phase: {len(FAULTS) + len(PY_FAULTS)} faults in "
        f"{time.perf_counter() - t0:.1f} s")


def b1_probes(torch, dev):
    """``--b1-probes``: B1's row quantizer at phase 3's three shapes and at
    the grad-input's without its column scale (CUDA events over bursts and
    the profiler's device time, beside the bytes bound), then B4 nn at each
    shape of NN_SHAPES under every plan (tiles 128 x 128 or 128 x 256; all
    whole, or full rounds whole and the other tiles' contraction split
    1-16 ways; the profiler's device time of the kernel): the readings
    ``nn_plan`` is fitted to.  One line a shape and one JSON line of the nn
    plans' readings."""
    from sdnq_tpu_torch.kernels import scaled_mm as ks
    g = torch.Generator(device=dev).manual_seed(77)
    for m, k, dt, cs in ((4608, 3072, torch.float32, False),
                         (4608, 15360, torch.bfloat16, False),
                         (1536, 21504, torch.bfloat16, True),
                         (1536, 21504, torch.bfloat16, False)):
        x = torch.randn(m, k, device=dev, generator=g).to(dt)
        c = (torch.rand(k, device=dev, generator=g) * 2e-3 + 1e-5
             if cs else None)
        got = ks.quantize_rows(x, colscale=c)
        want = ks.quantize_rows_plain(x, colscale=c)
        check(all(torch.equal(u, v) for u, v in zip(got[:2], want[:2])),
              f"quantize M{m} K{k} bit-equal")
        bnd = bound_ms(m * k * (x.element_size() + 1) + m * 4
                       + (k * 4 if cs else 0))[0]
        ev = burst_ms(lambda: ks.quantize_rows(x, colscale=c))
        dv = device_ms(torch, lambda: ks.quantize_rows(x, colscale=c),
                       KERNEL_SYMBOLS["quantize_rows"], reps=20)
        what = f"M{m} K{k} {str(dt)[6:]}{' colscale' if cs else ''}"
        log(f"quantize {what}: events {ev:.4f} ms, device {dv} ms, bytes "
            f"bound {bnd:.4f} ms")
        del x
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan, out = ks.nn_plan, []
    try:
        for m, o, kk, what, _ in NN_SHAPES:
            a = torch.randint(-127, 128, (m, o), device=dev, generator=g,
                              dtype=torch.int8)
            w = torch.randint(-127, 128, (o, kk), device=dev, generator=g,
                              dtype=torch.int8)
            xs = torch.rand(m, 1, device=dev, generator=g) * 1e-4
            want = ks.scaled_gemm_plain(a, w, torch.bfloat16, xs,
                                        b_layout="nn")
            times = {}
            for nb in (1, 2):
                tiles = -(-m // 128) * -(-kk // (128 * nb))
                for whole in sorted({tiles, tiles // sms * sms}):
                    for splits in range(1, (min(16, -(-o // 128)) + 1)
                                        if whole < tiles else 2):
                        ks.nn_plan = lambda *_, p=(nb, whole, splits): p
                        got = ks.scaled_gemm(a, w, torch.bfloat16, xs,
                                             b_layout="nn")
                        key = f"{nb}/{whole}/{splits}"
                        check(torch.equal(got, want),
                              f"nn plan {what} {key}: bit-equal")
                        times[key] = device_ms(
                            torch, lambda: ks.scaled_gemm(
                                a, w, torch.bfloat16, xs, b_layout="nn"),
                            KERNEL_SYMBOLS["scaled_gemm"], reps=10)
            ks.nn_plan = plan
            times = {k: v for k, v in times.items() if v is not None}
            chosen = "%d/%d/%d" % plan(m, kk, o, torch.int8, sms)
            best = min(times, key=times.get)
            log(f"nn plans M{m} K{o} N{kk} ({what}), nb/whole/splits, "
                f"device ms: model {chosen} {times.get(chosen)}, best "
                f"{best} {times[best]:.4f}")
            out.append(dict(shape=[m, o, kk], what=what, chosen=chosen,
                            best=best, ms=times))
            del a, w, want
    finally:
        ks.nn_plan = plan
    log("nn plans: " + json.dumps(out))


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

    def mark(what):  # where the run's time goes
        log(f"at {time.perf_counter() - t_start:.1f} s: {what} done")
    t0 = time.perf_counter()
    fault_procs = {}
    faults = "--no-faults" not in sys.argv[1:]
    try:
        b1_only = "--b1-probes" in sys.argv[1:]
        io_only = "--phase-4i" in sys.argv[1:]
        unet_only = "--phase-4u" in sys.argv[1:]
        mbo_only = "--phases-4m-4b-4o" in sys.argv[1:]
        nt_only = "--phases-4n-4t" in sys.argv[1:]
        long_only = "--phases-4l-4t" in sys.argv[1:]
        secs = _build.build(("quantize_rows", "scaled_mm") if b1_only
                            else IO_SOURCES if io_only
                            else UNET_SOURCES if unet_only
                            else MBO_SOURCES if mbo_only
                            else NT_SOURCES if nt_only
                            else LONG_SOURCES if long_only
                            else _build.SOURCES)
        log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
            + json.dumps({k: round(v, 1) for k, v in secs.items()}))
        if b1_only:
            b1_probes(torch, dev)
            return 1 if FAILURES else 0
        if io_only:
            log(json.dumps(io_phase(torch, dev)))
            return 1 if FAILURES else 0
        if unet_only:
            unet_phase(torch, dev)
            return 1 if FAILURES else 0
        if mbo_only:
            rows = kernel_phase(torch, dev, mbo_only=True)
            mark("phase 3 (phases 4m-4o's rows)")
            counts = mbo_phases(torch, dev, mark)[0]
            for row in rows:
                row["launches"] = (counts[row["path"]][row["count"]]
                                   if row["on_main_path"] else 0)
            return finish(torch, rows, t_start)
        if nt_only or long_only:
            rows = kernel_phase(torch, dev, nt_only=nt_only,
                                long_only=long_only)
            mark("phase 3 (the phases' rows)")
            counts = (nt_phases if nt_only else long_phases)(torch, dev,
                                                             mark)
            for row in rows:
                row["launches"] = (counts[row["path"]][row["count"]]
                                   if row["on_main_path"] else 0)
            return finish(torch, rows, t_start)
        # the crossover's timing decides a route: on a quiet host, before
        # the fault builds (after the real sources, which then have the
        # host's cores) start
        b7_b8_crossover(torch, dev)
        if faults:
            fault_procs = start_fault_builds()
        mark("build and crossover")
        rows = kernel_phase(torch, dev)
        mark("phase 3")

        counts, slices = {"bench": dict(BENCH_COUNTS)}, {}
        counts["ring"] = ring_phase(torch, dev)
        ring_slice_phase(torch, dev)
        mark("phase 4r")
        int8_required = ("quantize_rows", "scaled_gemm", "dequant_gemv",
                         "flash_attention")
        qparams = build_model(
            torch, dev,
            QuantConfig(weights_dtype="int8", use_quantized_matmul=True),
            "int8")
        int8_outs = []
        counts["int8"] = denoise_path(
            torch, dev, qparams, "int8", 2, 4, int8_required, int8_outs)
        slices["int8"] = cut(qparams)
        slice_phase(torch, dev, slices["int8"], "int8")
        profile_phase(torch, dev, qparams, "int8")
        counts["stacked"], counts["pipeline_pp"] = stacked_path(
            torch, dev, qparams, int8_outs[0], int8_required)
        del qparams, int8_outs
        torch.cuda.empty_cache()
        mark("FLUX int8, stacked, pipeline-parallel")

        qparams = build_model(
            torch, dev,
            QuantConfig(weights_dtype="uint4", use_svd=True, svd_rank=32),
            "uint4_wo", depth=FLUX_CUT_DEPTH)
        counts["uint4_wo"] = denoise_path(
            torch, dev, qparams, "uint4_wo", 2, 4,
            ("groupdot_mm", "decode_weight:halfsplit", "wgmma_mm:fold",
             "blockdiag_mm", "flash_attention"), depth=FLUX_CUT_DEPTH)
        qmm = with_quantized_matmul(qparams)
        counts["uint4_qmm"] = denoise_path(
            torch, dev, qmm, "uint4_qmm", 1, 2,
            ("groupdot_i8_mm", "decode_weight:halfsplit_i8",
             "wgmma_mm:fold_i8", "blockdiag_mm", "quantize_rows",
             "scaled_gemm", "flash_attention"), depth=FLUX_CUT_DEPTH)
        slices["uint4_wo"] = cut(qparams)
        slices["uint4_qmm"] = cut(qmm)
        slice_phase(torch, dev, slices["uint4_wo"], "uint4_wo")
        slice_phase(torch, dev, slices["uint4_qmm"], "uint4_qmm")
        profile_phase(torch, dev, qparams, "uint4_wo", FLUX_CUT_DEPTH)
        profile_phase(torch, dev, qmm, "uint4_qmm", FLUX_CUT_DEPTH)
        del qparams, qmm
        torch.cuda.empty_cache()
        mark("FLUX uint4")

        # SDNQ's dynamic per-layer format selection on weights with tails:
        # R1, SDNQ's default int8 recipe; R2, the uint4 + SVD r32 recipe
        for label, qc, requests, required in (
                ("dyn_r1", QuantConfig(weights_dtype="int8",
                                       use_dynamic_quantization=True), 2,
                 ("dequant_mm:grouped", "dequant_mm:bitplane",
                  "decode_weight:bitplane", "wgmma_mm:bias",
                  "dequant_gemv:bitplane", "flash_attention")),
                ("dyn_r2", QuantConfig(weights_dtype="uint4", use_svd=True,
                                       svd_rank=32,
                                       use_dynamic_quantization=True), 1,
                 ("groupdot_mm", "blockdiag_mm", "decode_weight:halfsplit",
                  "wgmma_mm:fold",
                  ("groupdot_mm:multiplane", "groupdot_mm:minifloat"),
                  ("blockdiag_mm:multiplane", "blockdiag_mm:minifloat"),
                  "flash_attention"))):
            qparams = build_dynamic_model(torch, dev, qc, label,
                                          FLUX_CUT_DEPTH)
            counts[label] = denoise_path(torch, dev, qparams, label,
                                         requests, 4, required,
                                         depth=FLUX_CUT_DEPTH)
            slices[label] = cut(qparams)
            slice_phase(torch, dev, slices[label], label)
            profile_phase(torch, dev, qparams, label, FLUX_CUT_DEPTH)
            del qparams
            torch.cuda.empty_cache()

        mark("phase 4g")
        params, lcfg = build_llm(torch, dev)
        counts["llm_int8kv"] = llm_path(
            torch, dev, params, lcfg, "llm_int8kv", "int8", 2,
            ("quantize_rows", "scaled_gemm", "dequant_gemv",
             "flash_attention:masked", "flash_attention:gqa",
             "flash_attention:int8_pv"))
        counts["llm_bf16kv"] = llm_path(
            torch, dev, params, lcfg, "llm_bf16kv", "bfloat16", 1,
            ("quantize_rows", "scaled_gemm", "dequant_gemv",
             "flash_attention:masked", "flash_attention:gqa"))
        counts["llm_causal"] = llm_causal_path(
            torch, dev, params, lcfg, "llm_causal",
            ("quantize_rows", "scaled_gemm", "flash_attention:causal",
             "flash_attention:gqa"))
        decode_attention_ms(torch, dev)
        llm_cut = cut_llm(params, lcfg)
        for label in LLM_LABELS:
            llm_slice_phase(torch, dev, llm_cut, label)
        llm_profile_phase(torch, dev, params, lcfg)
        del params
        torch.cuda.empty_cache()
        counts["qlinear_b8"] = b8_qlinear_check(torch, dev)[0]

        mark("phase 4d")
        tparams, tcfg = build_train_model(torch, dev)
        counts["train"], state = train_path(torch, dev, tparams, tcfg)
        del state
        torch.cuda.empty_cache()
        counts["muon"] = muon_phase(torch, dev, tparams, tcfg,
                                    TRAIN_MEAN_OPTIMIZER_MS.get("adamw"))
        train_cut = cut_train(tparams)
        del tparams
        torch.cuda.empty_cache()
        train_slice_phase(torch, dev, train_cut)
        muon_slice_phase(torch, dev, train_cut)
        tp_train_phase(torch, dev, train_cut)
        mark("phase 4n, the TP x DP step")
        counts["long"] = long_qlinear_path(torch, dev)
        counts["muon_long"] = long_muon_path(torch, dev)
        mark("phase 4l")

        mark("phase 4e")
        resident = torch.cuda.memory_allocated()
        models, pcfgs = build_pipeline(torch, dev)
        counts["pipeline"] = pipeline_path(torch, dev, models, pcfgs,
                                           resident)
        pipe_cut = cut_pipeline(models, pcfgs)
        pipeline_slice_phase(torch, dev, pipe_cut)
        pipeline_profile_phase(torch, dev, models, pcfgs)
        mark("phase 4f")
        counts.update(io_phase(torch, dev))
        mark("phase 4i")
        unet_counts, unet_cut = unet_phase(torch, dev)
        counts.update(unet_counts)
        mark("phase 4u")
        mbo_counts, mbo_cuts = mbo_phases(torch, dev, mark)
        counts.update(mbo_counts)
        # the virtual ranks' forwards are host-bound: after the fault
        # builds (which the fault phase waits for anyway), on phase 4's
        # int8 model built again (about a second)
        for proc, _ in fault_procs.values():
            proc.wait()
        qparams = build_model(
            torch, dev,
            QuantConfig(weights_dtype="int8", use_quantized_matmul=True),
            "int8")
        counts["tp"] = tp_phase(torch, dev, qparams)
        del qparams
        torch.cuda.empty_cache()
        tp_slice_phase(torch, dev, slices["int8"])
        mark("phase 4t's forwards")
        tp_train_cases(torch, dev, train_cut)
        tp_layer_phase(torch, dev)
        mark("phase 4t's training cases")

        for row in rows:
            row["launches"] = (counts[row["path"]][row["count"]]
                               if row["on_main_path"] else 0)
        checks = {label: (lambda lb=label: slice_phase(torch, dev,
                                                       slices[lb], lb))
                  for label in slices}
        checks.update({label: (lambda lb=label: llm_slice_phase(
            torch, dev, llm_cut, lb)) for label in LLM_LABELS})
        checks["e5m2"] = lambda: slice_phase(torch, dev, mbo_cuts["e5m2"],
                                             "e5m2")
        checks["moe"] = lambda: moe_slice_phase(torch, dev, mbo_cuts["moe"])
        checks["llm100_int8kv"] = lambda: llm_slice_phase(
            torch, dev, mbo_cuts["llm100"], "llm100_int8kv")
        checks["sd15_fp16"] = lambda: unet_fp16_slice_phase(
            torch, dev, mbo_cuts["sd15_fp16"])
        checks["qlinear_b8"] = lambda: {"max": b8_qlinear_check(torch,
                                                                dev)[1]}
        checks["train"] = lambda: train_slice_phase(torch, dev, train_cut)
        checks["muon"] = lambda: muon_slice_phase(torch, dev, train_cut)
        checks["tp"] = lambda: tp_slice_phase(torch, dev, slices["int8"])
        checks["tp_layers"] = lambda: tp_layer_phase(torch, dev)
        checks["ring"] = lambda: ring_slice_phase(torch, dev)
        checks["pipeline"] = lambda: pipeline_slice_phase(torch, dev,
                                                          pipe_cut)
        checks["unet"] = lambda: unet_slice_phase(torch, dev, unet_cut)
        if faults:
            fault_phase(torch, dev, checks, fault_procs)
        else:
            log("faults not built (--no-faults): phase 7 skipped")
    finally:  # no compiler outlives the script
        for proc, _ in fault_procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    return finish(torch, rows, t_start)


def mbo_phases(torch, dev, mark):
    """Phases 4m, 4b, 4o and 4u's fp16 recipe, in turn; returns (their
    counts by path label, their phase-7 slices)."""
    counts, cuts = {}, {}
    moe_counts, cuts["moe"] = moe_phase(torch, dev)
    counts.update(moe_counts)
    ep_phase(torch, dev, *cuts["moe"])
    mark("phase 4m, phase 4t's expert parallelism")
    counts["batch_e5m2"], cuts["e5m2"] = batch_phase(torch, dev)
    mark("phase 4b, phase 4t's batcher")
    llm100_counts, cuts["llm100"] = llm100_phase(torch, dev)
    counts.update(llm100_counts)
    mark("phase 4o")
    counts["sd15_fp16"], cuts["sd15_fp16"] = unet_fp16_phase(torch, dev)
    mark("phase 4u's fp16 recipe")
    return counts, cuts


def finish(torch, rows, t_start) -> int:
    """The off-path rows logged, the kernels line, then the last line (or
    the failures and exit code 1)."""
    path = [r for r in rows if r["on_main_path"]]
    for r in rows:
        if not r["on_main_path"]:
            log("off-path kernel mode: " + json.dumps(r))
    log(f"device_ms: {sum(r['device_ms'] is None for r in rows)} of "
        f"{len(rows)} phase-3 readings null")
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
