#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
(``CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch built for CUDA. It
builds the port's kernels from ``src/repro_torch/kernels/csrc`` into
``src/repro_torch/kernels/build`` and runs twenty phases, each of which
raises on failure:

1. device: the card's name and power limit, torch/CUDA versions, and the
   kernels' build time;
2. kernels: the launch planner (``kernels/plan.py``) against every built
   chunk instantiation, then every hand-written kernel (wNa16 GEMM at
   the dense models' matmul shapes, at the routed experts' of
   DeepSeek-V3 and Llama-4 Maverick (M 1, 8, 64) and at the SSM and
   hybrid layers' of Mamba-2 and Hymba (M 1, 8, 256; N = 6448 and 6482
   among them, whose rows are no multiple of 64 or, for 6482, of 16
   bytes) and at Whisper-small's decoder and InternVL2-1B's (M 1, 8, 256;
   (768, 768) also at M 6000, the cross-attention k / v of
   ``start_cache``), its main case at one M
   of each
   M bucket of its launch count, and held at odd M, with inv_act and a bias,
   float32 and float16 x and groups of 64 and 32; its bound at the mma
   passes of its launch plan; paged decode at G = 1, 4, 5, 6 and 12, at
   Hymba's heads (G = 5 of 64, windows of 1024 and 0) and at the engine's
   own decode shapes (8 slots, idle ones at length 0, table widths 8 to
   64; Llama-2-7B's heads and Hymba's), each with its launch plan's splits
   and CTAs; chunk
   prefill at G = 1, 4, 5, 6, 7 and 12 and head widths 64, 128 and 256, and
   the decode and chunk walks' quantized-KV lane over pools quantized by
   ``PagedKVPool.quantize_blocks``, int8 and int4) against its plain
   torch version at the main path's shapes, with the largest
   error against a stated tolerance and CUDA-event medians of the kernel,
   the plain version and one library call, beside the least time the
   card could take (the chunk walks: at their tensor-core passes, with
   the float32 CUDA-core bound of earlier runs logged beside it; the
   decode walk's quantized lane at the bytes its per-block skip reads, the
   earlier 5-byte yardstick logged once); a zeroed quantized-KV
   sidecar must give the no-quant kernel's output exactly;
   each engine phase below logs K1's launches by shape and M bucket and
   K2's and K2-q's by table width, with estimates of their device time
   from these timings (each K1 launch priced by its own shape);
3. engine: the quickstart path — LIS profile, int4 swap plan, the
   token-budgeted ``MorphServeEngine`` serving a bursty trace with real
   compute — on Llama-2-7B at full width (d 4096, 32 heads, d_ff 11008,
   vocab 32000) cut to 8 layers, bf16 weights from a seeded generator;
4. kv-quant engine: the same model and trace with the quantize-cold tier
   on (``KVQuantConfig(enabled=True)``, a budget of the weights + 16 KV
   blocks): every request served, cold blocks quantized, and the decode
   and chunk steps over quantized blocks run through the quantized lane;
   then the tier off at that same budget, a control for the tier's effect
   on the served report;
5. step parity: one decode step and one chunk step of that model through
   the kernels against the same steps with the plain versions, then the
   same two steps with about half of the live blocks quantized (int8);
6. DeepSeek-V3 engine: its three dense MLA layers and its first MoE layer
   at full width (``DEEPSEEK_V3_671B.replace(n_layers=4)``: d 7168, 128
   heads, q_lora 1536, kv_lora 512, rope 64, d_ff 18432, 256 routed
   experts of d_ff 2048, top-8, one shared expert, vocab 129280), bf16
   weights from a seeded generator, served through the same path and
   trace over the float32 latent pool, on a swap ladder whose first rung
   reaches the MoE layer's LIS position; chunks go through K3-mla (the
   chunk walk's latent mode, also in phase 2, where a latent width the
   kernel is not built for must raise on a CUDA tensor) and every expert
   of the swapped MoE layer through K1, whose expert launches, and the
   MoE dispatch's host copies, it counts apart;
7. DeepSeek-V3 step parity: a decode step and a chunk step of that model
   at its deepest swap level, kernels against plain versions;
8. Maverick: Llama-4 Maverick's first two layers at full width
   (``LLAMA4_MAVERICK_400B.replace(n_layers=2)``: a dense layer and an
   MoE layer of 128 routed experts of d_ff 8192, top-1, one shared
   expert; 40 / 8 heads of 128, vocab 202048), its int4 swap plan, and a
   decode step and a chunk step at the fp and at the all-int4 level,
   kernels (K1, and K2 / K3 at G = 5) against plain versions;
9. Hymba engine: Hymba 1.5B at full width and depth (32 ``hybrid``
   layers: d 1600, 25 / 5 heads of 64 beside a Mamba-2 mixer of 50 SSD
   heads, d_state 16; a window of 1024 but on layers 0, 15 and 31; d_ff
   5504, vocab 32001), bf16 weights from a seeded generator, served
   through the same path and trace under a budget of the weights + 8
   float32 KV blocks, with the per-slot SSM state (7.8 MB a slot, which
   the ledger does not book, as in the JAX engine); prefill is
   whole-prompt at the prompt's length, so K3 is not on this path;
10. Hymba step parity: a whole-prompt prefill and a decode step at the
   fp and the deepest level, kernels against plain versions (logits), and
   the SSM state after the step, layer by layer, against a float32
   witness (the plain versions on float32 copies of the weights);
11. Mamba-2 engine: Mamba-2 780M at full width (d 1536, 48 SSD heads of
   64, d_state 128, vocab 50280) cut to ``MAMBA_LAYERS`` of its 48
   ``mamba`` layers, the same trace at ``MAMBA_RPS`` requests a second
   (no KV blocks: only queue delay trips the controller), every swapped
   matmul through K1;
12. Mamba-2 step parity, as in 10, on all 48 layers;
13. Whisper-small through the model API at full width (12 encoder and 12
   decoder layers, d 768, 12 heads of 64, d_ff 3072, vocab 51865, 1500
   frames of 768), bf16 weights from a seeded generator: ``encode`` of 4
   frame batches, ``start_cache`` and 32 greedy ``decode_step`` calls at the
   bf16 decoder (held against ``decode_forward``'s teacher-forced logits)
   and at an all-int4 decoder, every matmul of which goes through K1
   (kernel route fed the plain route's tokens and held against it step by
   step);
14. InternVL2-1B through the model API at full width (24 layers, d 896,
   14 / 2 heads of 64, d_ff 4864, vocab 151655, 256 image tokens of 1024
   through the projector): the LIS profile with the image input (int4
   variants through K1), then ``lm.forward_unrolled`` and a prefill of the
   image + text prompt into ``lm.init_cache`` with 16 decode steps, at
   levels 0 and 24, kernels against plain versions;
15. the serving cluster (``repro_torch.distributed``) on this card: three
   real-compute replicas of phase 3's Llama-2-7B cut (one set of bf16
   weights, each replica its own swap plan and the engine phase's budget)
   serve the engine phase's trace at three times its rate under a fault
   plan that drains one replica, fences another for a lost heartbeat (it
   rejoins) and kills the third (it restarts), with KV migration between
   them: every request finishes exactly once, drain and fencing migrations
   and a recompute re-dispatch happen, a replica swaps, K1, K2 and K3
   launch, and each migrated request's imported blocks are bit-equal to the
   source's; each migration logs its measured device -> host, channel and
   host -> device walls beside the channel's modelled time;
16. migration parity at full width on single greedy requests: a request
   exported mid-decode through the channel finishes with the uninterrupted
   reference's stream (also with about half of its blocks quantized,
   crossing as codec payload and decoded through K2-q); the int8-compressed
   channel lands within the codec's error; a cached prefix migrated to a
   peer is read there by the chunk walk (K3) and gives a fresh engine's
   stream;
17. training at full width (plain torch: the TPU kernels serve, none is on
   the training path): Llama-2-7B cut to 8 layers, bf16 weights, B = 2 at
   train_4k's S = 4096 on the Markov data pipeline, through
   ``launch/steps.make_train_step`` (remat "full", AdamW): the first
   step's loss and gradients against a float32 witness (the same weights
   as float32 copies; per-leaf and per-layer cosines), ``compress_tree``
   of those gradients (error within half a scale step), 8 steps on the
   repeated batch (finite, every leaf changed at step 1, the loss falls;
   walls, tokens a second and ``max_memory_allocated`` beside the state's
   reckoning), remat "dots" against "full", and on a 2-layer cut at S =
   1024 a checkpoint resume (async save in 2 shards, verify, load) under
   deterministic algorithms that must end bit-equal to the uninterrupted
   run;
18. the dry run against the card: ``launch/dryrun.py`` on a (1, 1) mesh
   for phase 17's own cell; its predicted ``argument_size_in_bytes`` must
   equal the bytes phase 17 kept on the card for the parameters, the AdamW
   state and the batch, with no collective on one device; the predicted
   matmul FLOPs over phase 17's median step wall give the achieved TFLOP/s
   (logged with the card's name and power limit and phase 17's
   ``max_memory_allocated``, unbounded);
19. the serve_trace twin (``examples/serve_trace_torch.py``): (i) as
   written, its four sim engines with their bf16 pools on this card, whose
   lines must equal the JAX script's; (ii) its ``run_policies`` with real
   compute on Llama-2-7B at full width and depth (32 layers), bf16 weights
   from a seeded generator, the example's budget (an L4's 24 GiB), ladder
   (0, 2, 4, 8, 16), 48 slots, bf16 KV pool and azure trace (cut, by
   policy, to ``SERVE_DURATIONS``), under all four policies, each row
   logged beside the sim engine's on the same trace with the ledger's
   bytes of both:
   every request served, ``static_int4`` at level 32 with every matmul
   through K1, the morph runs swapping and resizing, K2 (priced by the
   kernel phase's 48-slot bf16-pool cases) and K3 launched on the bf16
   pool; then a decode step and a chunk step over a bf16 pool at levels 0,
   16 and 32, kernels against plain versions;
20. the morph_profile twin (``examples/morph_profile_torch.py``): (i) as
   written, 150 AdamW steps of its 4-layer model, the LIS profile and the
   Table-1 perplexities through K1, the order equal to the profile's on CPU
   copies of the trained params and every entry within ``PPL_RTOL_F32`` of
   ``forward_unrolled(..., plain=True)``; (ii) the same profile and table
   on Llama-2-7B at full width cut to ``PROFILE_LAYERS`` layers on the
   Markov data at vocab 32000, kernel route against plain route, and the
   table's tolerance against its two controls: bf16's own noise (a
   float32 witness of the plain route) must lie under it, and one int4
   layer whose K1 outputs are zero above it.

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
It exits non-zero, with no ``ok`` line, when there is no CUDA device, when
it does not sit in a checkout of the repository, or when any phase fails.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate, bf16
# tensor-core rate, float32 rate outside the tensor cores
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12
TF32_FLOP_S = 495e12      # the tensor-core rate the chunk walks run at

# kernel-vs-plain tolerance per output dtype, elementwise:
# |kernel - plain| <= RTOL * |plain| + ATOL * max|plain|. Both sides
# accumulate in float32 and round once to the output dtype, so they differ
# by float32 summation order (~1e-6 relative) plus at most one rounding
# step of the output type: one bf16 ulp is 2**-7 relative.
TOL = {"bfloat16": (1e-2, 1e-3), "float16": (2e-3, 1e-4),
       "float32": (1e-4, 1e-5)}
# full-step logits: bf16 activations through 8 layers, where a one-ulp
# rounding flip at any kernel output propagates through the residual stream
LOGIT_TOL = 5e-2          # relative to max|plain logits|
# an SSM state after a step, relative to max|plain state|: how much farther
# the kernel route's state may lie from the float32 witness than the bf16
# plain route's does. It is float32, but its inputs come out of the same
# bf16 layers as the logits, so the same one-ulp flips reach it, and they
# grow with depth in either bf16 route (ssm_parity_phase)
STATE_TOL = LOGIT_TOL

REPS = 15
# the DeepSeek-V3 engine phase's budget: the weights plus this many float32
# latent blocks (4 layers x 16 x 576 x 4 B = 147.5 KB each)
MLA_KV_BLOCKS = 8
SLEEP_CYCLES = 2_000_000      # ~1 ms at the H100's clock: covers the enqueue
# the Mamba-2 engine phase: its depth cut (48 -> 4 layers) and its request
# rate, the lowest integer base_rps of the trace at which a swap lands on
# the virtual clock at that depth (H100 cost profile; ``swap_rate.py``, on
# the CPU: 270 swaps nothing, 271 swaps). A deeper model swaps at a lower
# rate but costs more a step: 8 layers swap at 237 requests a second and
# the phase took 194 s on one H100, 48 layers at 107 and 694 s; 4 layers
# take about 120 s. The step parity phase runs all 48 layers.
MAMBA_LAYERS = 4
MAMBA_RPS = 271.0


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """CUDA-event medians of device time. Before each timed call the L2
    cache is flushed (the main path reads each layer's weights and each
    pool block cold) and the stream is held busy by a device-side sleep
    while the host enqueues the call, so the host's launch work (Python
    checks, ctypes, allocations) stays outside the event pair. A plain
    version that synchronizes inside itself would let host time in."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def check_close(name, got, want):
    """Elementwise tolerance check; returns the largest absolute error."""
    import torch
    rtol, atol = TOL[str(want.dtype).replace("torch.", "")]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    scale = float(w.abs().max())
    bad = err > rtol * w.abs() + atol * scale
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements off, max err "
            f"{float(err.max()):.3e} (max|ref| {scale:.3e}, rtol {rtol}, "
            f"atol {atol}*max|ref|)")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
# the (K, N) of every matmul of a swapped layer, with the weight width, the
# M at which it is held to its plain version (decode 1 / 8 slots, chunks and
# batched prefills up to 256 rows) and the M at which it is timed.
# Llama-2-7B: wq/wk/wv/wo, MLP up/gate, down; int4 and int8. DeepSeek-V3's
# dense MLA layers (the swap plan's int4): w_dq, w_uq, w_dkv (its last 64
# columns are the rope key), w_ukv (whole-prompt prefill's latent
# expansion), wo, MLP up/gate, down; the routed experts of both MoE models
# (``MOE_KN``). The main case, (4096, 11008) int4, is timed at one M of
# each M bucket of ``launches_by_shape`` (``K1_BUCKET_M``).
LLAMA_KN = ((4096, 4096), (4096, 11008), (11008, 4096))
DEEPSEEK_KN = ((7168, 1536), (1536, 24576), (7168, 576), (512, 32768),
               (16384, 7168), (7168, 18432), (18432, 7168))
# the expert GEMMs of a swapped MoE layer (gate / up, then down): DeepSeek-V3
# (d 7168, expert d_ff 2048) and Llama-4 Maverick (d 5120, expert d_ff
# 8192); an expert's M is the rows routed to it, 1 to 64 at the engine's
# decode and chunk steps
MOE_KN = ((7168, 2048), (2048, 7168), (5120, 8192), (8192, 5120))
MOE_M = (1, 8, 64)
# the matmuls of a swapped SSM or hybrid layer, (K, N, group): Mamba-2
# 780M's in_proj (1536 -> 2 x 3072 + 2 x 128 + 48 = 6448) and out_proj;
# Hymba 1.5B's in_proj (1600 -> 2 x 3200 + 2 x 16 + 50 = 6482: its packed
# and scale rows are not 16-byte multiples) and out_proj, its attention's
# wq / wo (1600, 1600) and wk / wv (1600, 320), its MLP up / gate and
# down. K = 1600 takes group 64 (the int4 variant halves 128 until it
# divides K)
SSM_KN = ((1536, 6448, 128), (3072, 1536, 128), (1600, 6482, 64),
          (3200, 1600, 128), (1600, 1600, 64), (1600, 320, 64),
          (1600, 5504, 64), (5504, 1600, 128))
SSM_M = (1, 8, 256)
SSM_WNA16_CASES = [(K, N, 4, SSM_M, SSM_M) for K, N, _ in SSM_KN]
# the matmuls of a swapped Whisper-small decoder layer (d 768, 12 heads of
# 64, d_ff 3072: wq / wk / wv / wo of self- and cross-attention, the
# cross-attention's k / v over the encoder states, MLP up, down) and of an
# InternVL2-1B layer (d 896, 14 / 2 heads of 64: wq / wo (896, 896), wk /
# wv (896, 128); MLP up / gate (896, 4864), down), int4 group 128; decode
# M is the batch (4 and 2 sequences) and prefill M up to 2 x 288 rows. The
# cross-attention's k / v of ``encdec.start_cache`` run at M = 4 x 1500
# frames: held, not timed
ENCDEC_VLM_KN = ((768, 768), (768, 3072), (3072, 768), (896, 896),
                 (896, 128), (896, 4864), (4864, 896))
CROSS_KV_M = 6000
ENCDEC_VLM_WNA16_CASES = [
    (K, N, 4, SSM_M + ((CROSS_KV_M,) if (K, N) == (768, 768) else ()),
     SSM_M) for K, N in ENCDEC_VLM_KN]
K1_BUCKET_M = {"1": 1, "2-8": 8, "9-16": 16, "17-64": 64, "65-256": 256,
               "257-512": 512, ">512": 1024}
K1_MAIN = (4096, 11008, 4)
WNA16_CASES = ([(K, N, bits, (1, 8, 256), (8, 256) if bits == 8 else (1, 8, 256))
                for K, N in LLAMA_KN for bits in (4, 8)
                if (K, N, bits) != K1_MAIN]
               + [(*K1_MAIN, tuple(K1_BUCKET_M.values()),
                   tuple(K1_BUCKET_M.values()))]
               + [(K, N, 4, (1, 8, 256), (8, 256)) for K, N in DEEPSEEK_KN]
               + [(K, N, 4, MOE_M, MOE_M) for K, N in MOE_KN])


def wna16_cases(torch, timer, results, cases=WNA16_CASES):
    """K1 against its plain version, elementwise, at each case's held M
    (bf16 x, group 128, no inv_act or bias: the main path's calls); timed at
    its timed M beside ``torch.matmul`` on the pre-dequantized bf16 weight.
    Each timed row carries the work its bound is computed from
    (``wna16_bounds``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wna16_gemm import wna16_gemm
    from repro_torch.quant import quantize_tensor
    gen = torch.Generator(device="cuda").manual_seed(11)
    for K, N, bits, held, timed in cases:
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        qt = quantize_tensor(w.to(torch.bfloat16), bits=bits, group=128)
        wd = qt.dequantize(torch.bfloat16)
        for M in held:
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            args = (x, qt.packed, qt.scales, qt.zeros)
            kw = dict(bits=bits, group=qt.group)
            want = ref.wna16_ref(*args, **kw)
            got = wna16_gemm(*args, **kw)
            torch.cuda.synchronize()
            name = f"wna16 M={M} K={K} N={N} int{bits}"
            err = check_close(name, got, want)
            row = dict(kernel="wna16_gemm", case=name, err=err)
            results.append(row)
            if M not in timed:
                log(f"  {name}: err {err:.2e}")
                continue
            t_k = timer.ms(lambda: wna16_gemm(*args, **kw))
            t_p = timer.ms(lambda: ref.wna16_ref(*args, **kw))
            t_l = timer.ms(lambda: torch.matmul(x, wd))
            nbytes = (x.numel() * 2 + qt.packed.numel()
                      + 2 * qt.scales.numel() * 4 + M * N * 2)
            row.update(ms=t_k, plain_ms=t_p, library_ms=t_l,
                       k1_work=dict(M=M, K=K, N=N, bits=bits, group=qt.group,
                                    nbytes=nbytes, flops=2 * M * K * N))
            log(f"  {name}: err {err:.2e} kernel {t_k:.4f} ms plain "
                f"{t_p:.4f} ms matmul(bf16 W) {t_l:.4f} ms")
        del w, qt, wd


def wna16_more_cases(torch, results):
    """K1 held, untimed, where the main path does not go: odd M (the 8- and
    16-row decode tiles and the 64-row tile, ragged), AWQ inv_act with a
    bias, float32 and float16 x (their split and fp16 passes), and groups
    of 64 and 32."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wna16_gemm import wna16_gemm
    from repro_torch.quant import quantize_tensor
    gen = torch.Generator(device="cuda").manual_seed(15)
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # (K, N, bits, group, x dtype, inv_act + bias, Ms)
    cases = ([(4096, 11008, 4, 128, bf, False, (3, 17, 100, 300, 1000))]
             + [(4096, 11008, bits, 128, bf, True, (3, 17, 300))
                for bits in (4, 8)]
             + [(4096, 11008, bits, 128, f32, inv, (3, 100))
                for bits in (4, 8) for inv in (False, True)]
             + [(4096, 11008, bits, 128, f16, inv, (17, 300))
                for bits in (4, 8) for inv in (False, True)]
             + [(4096, 4096, bits, 64, bf, False, (8, 256)) for bits in (4, 8)]
             + [(7168, 576, 4, 32, bf, True, (8, 100))])
    for K, N, bits, group, dt, inv, Ms in cases:
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        act = (torch.rand((K,), generator=gen, device="cuda") + 0.5
               if inv else None)
        qt = quantize_tensor(w, bits=bits, group=group, act_scale=act)
        bias = torch.randn((N,), generator=gen, device="cuda") if inv \
            else None
        errs = []
        for M in Ms:
            x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
            args = (x, qt.packed, qt.scales, qt.zeros, qt.inv_act, bias)
            want = ref.wna16_ref(*args, bits=bits, group=group)
            got = wna16_gemm(*args, bits=bits, group=group)
            torch.cuda.synchronize()
            name = (f"wna16 M={M} K={K} N={N} int{bits} group {group} "
                    f"{str(dt).replace('torch.', '')}"
                    + (" inv_act+bias" if inv else ""))
            err = check_close(name, got, want)
            errs.append(err)
            results.append(dict(kernel="wna16_gemm", case=name, err=err))
        log(f"  K={K} N={N} int{bits} group {group} "
            f"{str(dt).replace('torch.', '')}"
            + (" inv_act+bias" if inv else "")
            + f" at M {Ms}: errs " + ", ".join(f"{e:.2e}" for e in errs))
        del w, qt


def wna16_bounds(results):
    """Each timed K1 case's least time on this card, in ms, as its
    ``bound_ms``: the larger of its bytes over the HBM rate and its FLOPs
    times the mma passes its launch plan takes over the bf16 tensor-core
    rate. Returns {(K, N): {M: ms}} of the int4 cases, for the engine
    phases' estimates of K1's device time."""
    from repro_torch.kernels.wna16_gemm import plan
    by_shape = collections.defaultdict(dict)
    for r in results:
        w = r.get("k1_work")
        if w is None:
            continue
        p = plan(w["M"], w["K"], w["N"], bits=w["bits"], group=w["group"],
                 x_dtype="bfloat16", inv_act=False)
        t_bytes = w["nbytes"] / HBM_BYTES_S
        t_ops = w["flops"] * p.passes / BF16_FLOP_S
        r["bound_ms"] = max(t_bytes, t_ops) * 1e3
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"  {r['case']}: bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{p.passes} pass, tile {p.bm} rows, {p.splits} splits), kernel "
            f"{r['ms'] / r['bound_ms']:.1f}x it, matmul "
            f"{r['library_ms'] / r['bound_ms']:.1f}x")
        if w["bits"] == 4:
            by_shape[w["K"], w["N"]][w["M"]] = r["ms"]
    return by_shape


def _pool_case(torch, gen, B, lens, KVH, Dh, bs, extra_blocks=0, nb=None,
               dtype=None):
    """Pools (cap, bs, KVH, Dh) f32 (or ``dtype``) and block tables with
    globally distinct live ids (the engine's block-ownership contract);
    padding is scratch 0. The table is ``nb`` wide, by default the power of
    two at or above the longest sequence's blocks plus ``extra_blocks``."""
    need = [-(-int(n) // bs) for n in lens]
    if nb is None:
        nb = max(1, max(need) + extra_blocks)
        nb = 1 << (nb - 1).bit_length()
    cap = sum(need) + 1
    kp = torch.randn((cap, bs, KVH, Dh), generator=gen, device="cuda")
    vp = torch.randn((cap, bs, KVH, Dh), generator=gen, device="cuda")
    if dtype is not None:
        kp, vp = kp.to(dtype), vp.to(dtype)
    perm = torch.randperm(cap - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((B, nb), dtype=torch.int32, device="cuda")
    o = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[o:o + n].to(torch.int32)
        o += n
    return kp, vp, tables


def _sdpa_gathered(torch, q, kp, vp, tables, T, mask, G):
    """Library yardstick: scaled_dot_product_attention on pre-gathered,
    contiguous KV (B, H, T, Dh) in float32."""
    B, nb = tables.shape
    bs, KVH, Dh = kp.shape[1:]
    k = kp[tables.long()].reshape(B, nb * bs, KVH, Dh)[:, :T]
    v = vp[tables.long()].reshape(B, nb * bs, KVH, Dh)[:, :T]
    k = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    v = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    qf = q.float().contiguous()
    F = torch.nn.functional
    return lambda: F.scaled_dot_product_attention(qf, k, v, attn_mask=mask)


def _quantize(torch, kp, vp, qids, bits):
    """Quantize pool blocks ``qids`` through ``PagedKVPool.quantize_blocks``
    (a one-layer pool of the same shape): returns the fp pools with those
    slots zeroed and the layer's (qk, qv, k_scale, v_scale, k_zero, v_zero)
    bundle."""
    from repro_torch.configs import MORPH_LLAMA2_7B
    from repro_torch.engine.kv_cache import PagedKVPool
    cap, bs, KVH, Dh = kp.shape
    cfg = MORPH_LLAMA2_7B.replace(n_layers=1, n_kv_heads=KVH,
                                  n_heads=KVH, d_model=KVH * Dh)
    pool = PagedKVPool(cfg, cap, bs, dtype=kp.dtype, bucket_capacity=False,
                       device="cuda")
    pool.k[0].copy_(kp)
    pool.v[0].copy_(vp)
    assert pool.quantize_blocks(sorted(set(qids)), bits=bits)
    return pool.k[0], pool.v[0], tuple(a[0] for a in pool.kv_quant_bundle())


def _dequantized(torch, kp, vp, kvq):
    """The pools with every block dequantized by the lane's FMA, for the
    library yardstick (computed once, outside the timed call)."""
    qk, qv, ks, vs, kz, vz = kvq
    e = (slice(None), None, None, None)
    return (kp.float() + qk.float() * ks[e] + kz[e],
            vp.float() + qv.float() * vs[e] + vz[e])


def plan_check(torch):
    """The pure-Python launch planner against the built libraries: every
    chunk instantiation the wrappers admit must report the planner's
    dynamic shared bytes, key tile, passes, threads and row tile. Returns
    the built plans by (Dh, Dv, q dtype, pool dtype, kvq)."""
    from repro_torch.kernels import plan
    from repro_torch.kernels.paged_attention import built_chunk_plan
    combos = ([(Dh, Dh, qd, kd, kvq) for Dh in plan.HEAD_DIMS
               for qd in plan.DTYPES for kd in plan.DTYPES
               for kvq in (False, True)]
              + [(Dh, Dv, "float32", kd, False) for Dh, Dv in plan.LATENT_DIMS
                 for kd in plan.LATENT_POOL_DTYPES])
    most, built = 0, {}
    for Dh, Dv, qd, kd, kvq in combos:
        H, KVH = (128, 1) if Dv != Dh else (1, 1)
        p = plan.chunk_plan(B=1, C=1, H=H, KVH=KVH, Dh=Dh, Dv=Dv, q_dtype=qd,
                            kv_dtype=kd, kvq=kvq)
        want = (p.smem, p.key_tile, p.score_passes, p.value_passes,
                p.threads, p.row_tile)
        got = built_chunk_plan(getattr(torch, qd), getattr(torch, kd), Dh, Dv,
                               kvq)
        built[Dh, Dv, qd, kd, kvq] = got
        if got != want:
            raise AssertionError(f"plan of ({Dh}, {Dv}, q {qd}, pool {kd}, "
                                 f"kvq {kvq}): built {got}, planned {want}")
        most = max(most, p.smem)
    log(f"launch planner: {len(combos)} chunk instantiations report the "
        f"planned bytes, key tile, passes, threads and row tile (largest "
        f"{most} bytes of {plan.SMEM_LIMIT})")
    return built


def tensor_core_bounds(results, built):
    """Each chunk case's least time on this card, in ms, as its
    ``bound_ms``: the largest of its bytes over the HBM rate, its Q K^T and
    P V FLOPs times the mma passes its built instantiation takes over the
    TF32 rate, and its CUDA-core FLOPs (the quantized lane's dequant) over
    the float32 rate."""
    for r in results:
        w = r.get("work")
        if w is None:
            continue
        _, _, score, value = built[w["plan"]][:4]
        t_bytes = w["nbytes"] / HBM_BYTES_S
        t_ops = max((w["score_flops"] * score + w["value_flops"] * value)
                    / TF32_FLOP_S, w["cuda_flops"] / F32_FLOP_S)
        r["bound_ms"] = max(t_bytes, t_ops) * 1e3
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"  {r['case']}: tensor-core bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; passes {score}/{value}), kernel "
            f"{r['ms'] / r['bound_ms']:.1f}x it (float32 bound "
            f"{r['f32_bound_ms']:.4f} ms)")


# (B, ctx, H, KVH, window, softcap, fused). G = H / KVH: 1, 4, 5 (40 / 8:
# Llama-4 Maverick's), 6 (48 / 8: Nemotron-4-15B's) and 12 (96 / 8:
# Command R+'s)
WIDE_G = [(8, 2048, H, 8, 0, 0.0, fused) for H in (48, 96)
          for fused in (True, False)]
DECODE_CASES = ([(B, ctx, 32, 32, 0, 0.0, fused) for B in (1, 8)
                 for ctx in (17, 256, 2048) for fused in (True, False)]
                + [(8, 256, 32, 8, 0, 0.0, True),
                   (8, 2048, 40, 8, 0, 0.0, True),
                   (8, 2048, 32, 32, 64, 30.0, True),
                   (8, 2048, 32, 8, 64, 30.0, False)] + WIDE_G)
DECODE_Q_CASES = [(8, 2048, 32, 32, 0, 0.0, True),
                  (8, 2048, 32, 8, 64, 30.0, True),
                  (8, 2048, 32, 32, 0, 0.0, False)] + WIDE_G
# The engine's own decode launches (Llama-2-7B, 32 / 32 heads, fused): all
# 8 slots, idle ones at length 0 with an all-scratch row, the table as wide
# as the power of two at or above the longest row's blocks, the new token's
# included (the engine's bucketing), ragged lengths up to its 512-token
# prompts plus 48 generated.
# (table width, lens); K2-q at the two widest, every full block but each
# sequence's tail quantized.
ENGINE_DECODE_CASES = [(8, (118, 97, 77, 0, 53, 31, 0, 12)),
                       (16, (240, 201, 150, 0, 99, 60, 0, 17)),
                       (32, (511, 431, 300, 0, 207, 160, 0, 33)),
                       (64, (559, 529, 411, 0, 250, 130, 0, 48))]
ENGINE_DECODE_Q_CASES = ENGINE_DECODE_CASES[2:]
# serve_trace's decode launches (phase 19): 48 slots over a bf16 pool,
# prompts up to 1024 tokens and generations up to 448, so tables 32 to 128
# blocks wide; every eighth slot idle
SERVE_DECODE_CASES = [
    (nb, tuple(0 if i % 8 == 7 else nb * 16 - 1 - (i * 53) % (nb * 8)
               for i in range(48))) for nb in (32, 64, 128)]
# Hymba 1.5B's decode walk: 25 query heads over 5 kv heads (G = 5) of 64,
# a sliding window of 1024 on 29 of its 32 layers (it bites past 1024
# tokens: the context here reaches 2048) and full attention on the rest;
# then at the engine's own shapes (the Llama cases' slots, lengths and
# table widths), the window too wide to bite at the phase's lengths
HYMBA_HEADS = (25, 5, 64)
HYMBA_DECODE_CASES = [(8, 2048, 25, 5, 1024, 0.0, True),
                      (8, 2048, 25, 5, 1024, 0.0, False),
                      (8, 2048, 25, 5, 0, 0.0, True)]


def _decode_plan_note(B, H, KVH, Dh, bs, nb_t, window, kv_dtype="float32"):
    """The launch planner's splits, CTAs and ring for a K2 case (none when
    the port under test has no decode planner)."""
    from repro_torch.kernels import plan
    if not hasattr(plan, "decode_plan"):
        return "", None
    p = plan.decode_plan(B=B, H=H, KVH=KVH, Dh=Dh, bs=bs, nb_t=nb_t,
                         q_dtype="bfloat16", kv_dtype=kv_dtype,
                         window=window)
    return (f"; plan {p.splits} splits, {p.splits * KVH * B} CTAs, "
            f"{p.stages} stages", dict(splits=p.splits,
                                       ctas=p.splits * KVH * B,
                                       stages=p.stages))


def _decode_case(torch, gen, timer, results, name, B, lens, nb, H, KVH,
                 window, softcap, fused, bits, Dh=128, kv_dtype=None):
    """One K2 (``bits=None``) or K2-q case: B sequences of ``lens`` over a
    table ``nb`` wide (None: the power of two above the longest plus one),
    heads of ``Dh``, a float32 pool (or ``kv_dtype``);
    with ``bits`` the pools are quantized through the pool's codec, every
    block except each sequence's tail, after a zeroed sidecar is shown to
    give the plain lane's output exactly. Held to the plain version, timed
    beside it and SDPA, with its bound: each input read once, the pools at
    the bytes the lane reads (K2-q: 1 byte an element of a quantized block,
    the pool's width of an fp one, and the block's 16 bytes of scale and
    zero)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode
    bs = 16
    G = H // KVH
    kernel = "paged_decode" if bits is None else "paged_decode_q"
    lens = torch.tensor(list(lens), dtype=torch.int32, device="cuda")
    kp, vp, tables = _pool_case(torch, gen, B, lens.tolist(), KVH, Dh, bs,
                                extra_blocks=1, nb=nb, dtype=kv_dtype)
    q = torch.randn((B, H, Dh), generator=gen, device="cuda").to(
        torch.bfloat16)
    kn = torch.randn((B, KVH, Dh), generator=gen, device="cuda").to(kp.dtype)
    vn = torch.randn((B, KVH, Dh), generator=gen, device="cuda").to(kp.dtype)
    item = kp.element_size()
    kw = dict(scale=Dh ** -0.5, window=window, softcap=softcap,
              fused_new=fused)
    noop = None
    if bits is not None:
        # a zeroed sidecar must give the no-quant kernel's output exactly
        zero = (torch.zeros(kp.shape, dtype=torch.int8, device="cuda"),) \
            * 2 + (torch.zeros(kp.shape[0], device="cuda"),) * 4
        a0 = (q, kn if fused else None, vn if fused else None, kp, vp,
              tables, lens)
        d0 = paged_decode(*a0, **kw)
        d1 = paged_decode(*a0, kv_quant=zero, **kw)
        torch.cuda.synchronize()
        noop = float((d0.float() - d1.float()).abs().max())
        if noop != 0.0:
            raise AssertionError(f"decode-q no-op bundle differs: {noop}")
        qids = [int(tables[b, j]) for b in range(B)
                for j in range((int(lens[b]) - 1) // bs)]
        kp, vp, kvq = _quantize(torch, kp, vp, qids, bits)
        kw["kv_quant"] = kvq
    a = (q, kn if fused else None, vn if fused else None, kp, vp, tables,
         lens)
    want = ref.paged_decode_ref(*a, **kw)
    got = paged_decode(*a, **kw)
    torch.cuda.synchronize()
    err = check_close(name, got, want)
    t_k = timer.ms(lambda: paged_decode(*a, **kw))
    t_p = timer.ms(lambda: ref.paged_decode_ref(*a, **kw))
    # visited work: each sequence's visible pool tokens (+ the new one)
    qpos = lens + (1 if fused else 0) - 1
    lens_h = lens.tolist()
    first = [max(0, int(qp) - window + 1) if window else 0
             for qp in qpos.tolist()]
    vis_tot = sum(n - f for n, f in zip(lens_h, first)) + (B if fused else 0)
    nbytes = (q.numel() * 2 * 2 + (B * KVH * Dh * item * 2 if fused else 0)
              + tables.numel() * 4 + B * 4)
    flops = 4 * G * Dh * KVH * vis_tot
    elems = KVH * Dh * 2          # K and V elements of one token
    old_bytes = nbytes
    if bits is None:
        nbytes += sum(n - f for n, f in zip(lens_h, first)) * elems * item
    else:
        scale_row = kvq[2].tolist()
        tab = tables.tolist()
        for b in range(B):
            for j in range(first[b] // bs, -(-lens_h[b] // bs)):
                n_tok = min(lens_h[b], (j + 1) * bs) - max(first[b], j * bs)
                quant = scale_row[tab[b][j]] != 0.0
                nbytes += n_tok * elems * (1 if quant else 4) + 16
                old_bytes += n_tok * elems * 5 + 16
                if quant:
                    flops += 3 * elems * n_tok
    bound = max(nbytes / HBM_BYTES_S, flops / F32_FLOP_S) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_S >= flops / F32_FLOP_S \
        else "operations"
    # library: SDPA over the gathered (pre-dequantized) visible span
    T = int(lens.max()) + (1 if fused else 0)
    kpos = torch.arange(T, device="cuda")
    mask = kpos[None, :] < (lens[:, None] + (1 if fused else 0))
    if window:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    kp2, vp2 = (kp, vp) if bits is None else _dequantized(torch, kp, vp,
                                                          kvq)
    rows = tables.shape[1] * bs
    dense = []
    for pool, new in ((kp2, kn), (vp2, vn)):
        x = pool[tables.long()].reshape(B, rows, KVH, Dh).float()
        if T > rows:
            x = torch.cat([x, x.new_zeros((B, T - rows, KVH, Dh))], dim=1)
        x = x[:, :T].clone()
        if fused:      # the new token at position lens[b]
            x[torch.arange(B, device="cuda"), lens.long()] = new.float()
        dense.append(x.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
                     .contiguous())
    qf = q[:, :, None].float().contiguous()
    F = torch.nn.functional
    t_l = timer.ms(lambda: F.scaled_dot_product_attention(
        qf, dense[0], dense[1], attn_mask=mask[:, None, None, :]))
    del dense
    note, planned = _decode_plan_note(B, H, KVH, Dh, bs, tables.shape[1],
                                      window, str(kp.dtype)[6:])
    row = dict(kernel=kernel, case=name, err=err, ms=t_k, plain_ms=t_p,
               library_ms=t_l, bound_ms=bound, bound_by=by, noop_err=noop,
               nb_t=tables.shape[1], plan=planned)
    if bits is not None:
        row["bound_ms_5b"] = max(old_bytes / HBM_BYTES_S,
                                 flops / F32_FLOP_S) * 1e3
    results.append(row)
    log(f"  {name}: err {err:.2e} kernel {t_k:.4f} ms plain {t_p:.4f} ms "
        f"sdpa {t_l:.4f} ms bound {bound:.4f} ms ({by})"
        + ("" if noop is None else f"; no-op bundle diff {noop}") + note)


def decode_cases(torch, timer, results, cases=DECODE_CASES, bits=None,
                 Dh=128):
    """K2 (``bits=None``) or, with ``bits``, K2-q (``_decode_case``) at
    ``cases``, ragged lengths from each case's context, heads of ``Dh``."""
    gen = torch.Generator(device="cuda").manual_seed(12 if bits is None
                                                     else 40 + bits)
    for B, ctx, H, KVH, window, softcap, fused in cases:
        lens = [ctx - (b * 5) % max(ctx // 2, 1) for b in range(B)]
        name = (f"decode B={B} ctx={ctx} H={H} KVH={KVH}"
                + ("" if Dh == 128 else f" Dh={Dh}")
                + f" w={window} cap={softcap} fused={fused}"
                + ("" if bits is None else f" int{bits}"))
        _decode_case(torch, gen, timer, results, name, B, lens, None, H, KVH,
                     window, softcap, fused, bits, Dh=Dh)


def engine_decode_cases(torch, timer, results, cases=ENGINE_DECODE_CASES,
                        bits=None, heads=(32, 32, 128),
                        prefix="decode engine", kv_dtype=None):
    """K2 or K2-q at the engine's own decode shapes (``ENGINE_DECODE_CASES``:
    8 slots, idle ones at length 0, the engine's table widths), at
    ``heads`` (H, KVH, Dh; Llama-2-7B's by default), named from
    ``prefix``, on a float32 pool (or ``kv_dtype``). The first K2-q case also logs its bound at the earlier
    yardstick of 5 bytes an element (the fp slot and the int8 mirror of
    every visited element), which the lane no longer reads."""
    gen = torch.Generator(device="cuda").manual_seed(16 if bits is None
                                                     else 60 + bits)
    H, KVH, Dh = heads
    for nb, lens in cases:
        name = (f"{prefix} nb={nb} lens={'/'.join(map(str, lens))}"
                + ("" if bits is None else f" int{bits}"))
        _decode_case(torch, gen, timer, results, name, len(lens), lens, nb,
                     H, KVH, 0, 0.0, True, bits, Dh=Dh, kv_dtype=kv_dtype)
    if bits is not None and cases:
        first = next(x for x in results if x["kernel"] == "paged_decode_q"
                     and x["case"].startswith("decode engine"))
        log(f"  K2-q bound at the earlier 5-byte yardstick, "
            f"{first['case']}: {first['bound_ms_5b']:.4f} ms (now "
            f"{first['bound_ms']:.4f} ms at the bytes the skip reads)")


def k2_table(results, prefix="decode engine"):
    """{(kernel, table width): (ms, bound ms)} of the engine-shaped K2 and
    K2-q cases named from ``prefix``, for the engine phases' estimate of
    their device time."""
    return {(r["kernel"], r["nb_t"]): (r["ms"], r["bound_ms"])
            for r in results if r["case"].startswith(prefix + " ")}


def k2_estimate(by_nb, kernel, table):
    """Estimated device time and time lost against the bound, in ms, of the
    launches ``by_nb`` ({nb bucket: launches}): each bucket's launches x the
    engine-shaped case at the nearest timed table width at or above it (the
    widest where none is)."""
    widths = sorted(w for k, w in table if k == kernel)
    est = lost = 0.0
    for bucket, n in by_nb.items():
        top = 10 ** 9 if bucket.startswith(">") else int(bucket)
        w = next((x for x in widths if x >= top), widths[-1])
        ms, bound = table[kernel, w]
        est += n * ms
        lost += n * (ms - bound)
    return est, lost


# (Cp, pos0, H, KVH, Dh, window, softcap, fused): Llama-2-7B's 32 / 32
# heads of 128, GQA at G = 4, 5 (Llama-4 Maverick), 6 (Nemotron-4-15B) and
# 12 (Command R+), and
# the other widths the tiling serves: Dh 64 at 14 / 2 heads (InternVL2-1B's
# language model, G = 7) and Dh 256 at 16 / 16 (Gemma-7B's attention)
CHUNK_CASES = ([(Cp, pos0, 32, 32, 128, 0, 0.0, fused) for Cp in (16, 256)
                for pos0 in (0, 200) for fused in (True, False)]
               + [(256, 200, 32, 8, 128, 0, 0.0, True),
                  (256, 200, 40, 8, 128, 0, 0.0, True),
                  (256, 200, 32, 32, 128, 64, 30.0, True),
                  (16, 200, 32, 8, 128, 64, 30.0, False)]
               + [(256, 200, H, 8, 128, 0, 0.0, fused) for H in (48, 96)
                  for fused in (True, False)]
               + [(256, 200, 14, 2, 64, 0, 0.0, True),
                  (256, 200, 16, 16, 256, 0, 0.0, True)])
CHUNK_Q_CASES = ([(Cp, 200, 32, 32, 128, 0, 0.0, fused) for Cp in (16, 256)
                  for fused in (True, False)]
                 + [(256, 200, H, 8, 128, 0, 0.0, True) for H in (48, 96)])


def chunk_cases(torch, timer, results, cases=CHUNK_CASES, bits=None):
    """K3 (``bits=None``) or, with ``bits``, K3-q: the context blocks wholly
    below the chunk are quantized through the pool's codec (the chunk's own
    blocks are the sequence's tail). Each row carries the work its
    tensor-core bound is computed from (``tensor_core_bounds``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_chunk
    gen = torch.Generator(device="cuda").manual_seed(13 if bits is None
                                                     else 50 + bits)
    bs = 16
    kernel = "paged_chunk" if bits is None else "paged_chunk_q"
    for Cp, pos0, H, KVH, Dh, window, softcap, fused in cases:
        G = H // KVH
        kp, vp, tables = _pool_case(torch, gen, 1, [pos0 + Cp], KVH, Dh, bs)
        q = torch.randn((1, Cp, H, Dh), generator=gen, device="cuda").to(
            torch.bfloat16)
        kn = torch.randn((1, Cp, KVH, Dh), generator=gen, device="cuda")
        vn = torch.randn((1, Cp, KVH, Dh), generator=gen, device="cuda")
        if not fused:      # the pool-read mode reads the chunk's own KV
            pos = pos0 + torch.arange(Cp, device="cuda")
            blk = tables[0].long()[pos // bs]
            kp[blk, pos % bs] = kn[0]
            vp[blk, pos % bs] = vn[0]
        kw = dict(scale=Dh ** -0.5, window=window, softcap=softcap,
                  fused_new=fused)
        noop = None
        if bits is not None:
            zero = (torch.zeros(kp.shape, dtype=torch.int8, device="cuda"),) \
                * 2 + (torch.zeros(kp.shape[0], device="cuda"),) * 4
            a0 = (q, kn if fused else None, vn if fused else None, kp, vp,
                  tables, pos0)
            c0 = paged_chunk(*a0, **kw)
            c1 = paged_chunk(*a0, kv_quant=zero, **kw)
            torch.cuda.synchronize()
            noop = float((c0.float() - c1.float()).abs().max())
            if noop != 0.0:
                raise AssertionError(f"chunk-q no-op bundle differs: {noop}")
            qids = [int(b) for b in tables[0, :pos0 // bs]]
            kp, vp, kvq = _quantize(torch, kp, vp, qids, bits)
            kw["kv_quant"] = kvq
        a = (q, kn if fused else None, vn if fused else None, kp, vp, tables,
             pos0)
        want = ref.paged_chunk_ref(*a, **kw)
        got = paged_chunk(*a, **kw)
        torch.cuda.synchronize()
        name = (f"chunk Cp={Cp} pos0={pos0} H={H} KVH={KVH}"
                + ("" if Dh == 128 else f" Dh={Dh}")
                + f" w={window} cap={softcap} fused={fused}"
                + ("" if bits is None else f" int{bits}"))
        err = check_close(name, got, want)
        t_k = timer.ms(lambda: paged_chunk(*a, **kw))
        t_p = timer.ms(lambda: ref.paged_chunk_ref(*a, **kw))
        n_vis = [min(pos0 + i + 1, window) if window else pos0 + i + 1
                 for i in range(Cp)]
        ctx_read = min(pos0, window - 1) if window else pos0
        # pool tokens read: the context, plus the chunk's own in pool-read
        # mode; the quantized lane reads their int8 mirror too
        pool_tok = ctx_read + (0 if fused else Cp)
        per_tok = KVH * Dh * (4 if bits is None else 5) * 2
        nbytes = (q.numel() * 2 * 2 + pool_tok * per_tok
                  + (Cp * KVH * Dh * 4 * 2 if fused else 0)
                  + tables.numel() * 4)
        flops = 4 * Dh * H * sum(n_vis)
        dequant = 0 if bits is None else 6 * KVH * Dh * pool_tok
        if bits is not None:
            nbytes += 4 * 4 * (-(-pool_tok // bs) + 1)
        bound = max(nbytes / HBM_BYTES_S,
                    (flops + dequant) / F32_FLOP_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_S >= (flops + dequant) \
            / F32_FLOP_S else "operations"
        work = dict(plan=(Dh, Dh, "bfloat16", "float32", bits is not None),
                    nbytes=nbytes, score_flops=flops // 2,
                    value_flops=flops // 2, cuda_flops=dequant)
        kp2, vp2 = (kp, vp) if bits is None else _dequantized(torch, kp, vp,
                                                              kvq)
        if fused:
            kp2, vp2 = kp2.clone(), vp2.clone()
            pos = pos0 + torch.arange(Cp, device="cuda")
            blk = tables[0].long()[pos // bs]
            kp2[blk, pos % bs] = kn[0]
            vp2[blk, pos % bs] = vn[0]
        T = pos0 + Cp
        qi = pos0 + torch.arange(Cp, device="cuda")[:, None]
        kpos = torch.arange(T, device="cuda")[None, :]
        mask = kpos <= qi
        if window:
            mask &= kpos > qi - window
        lib = _sdpa_gathered(torch, q.permute(0, 2, 1, 3), kp2, vp2, tables,
                             T, mask[None, None], G)
        t_l = timer.ms(lib)
        results.append(dict(kernel=kernel, case=name, err=err, ms=t_k,
                            plain_ms=t_p, library_ms=t_l, f32_bound_ms=bound,
                            f32_bound_by=by, work=work, noop_err=noop))
        log(f"  {name}: err {err:.2e} kernel {t_k:.4f} ms plain {t_p:.4f} ms "
            f"sdpa {t_l:.4f} ms float32 bound {bound:.4f} ms ({by})"
            + ("" if noop is None else f"; no-op bundle diff {noop}"))


MLA_CHUNK_CASES = ([(Cp, pos0, fused, "float32") for Cp in (16, 256)
                    for pos0 in (0, 200) for fused in (True, False)]
                   + [(64, 100, fused, "bfloat16") for fused in (True, False)])


def mla_chunk_cases(torch, timer, results):
    """K3-mla at DeepSeek-V3's shapes: 128 query heads over one latent
    pool of width 576 (values: its first 512 lanes), float32 q, bs 16,
    scale 192 ** -0.5, ragged tables; the float32 pool the engine phases
    allocate, and the bf16 pool of ``EngineConfig(dtype="bfloat16")``.
    Both sides read the same pool values and accumulate in float32, so
    either pool is held to the float32 output's tolerance. Then a latent
    width the kernel is not built for must raise on a CUDA tensor, at the
    wrapper and through the latent route, without launching."""
    from repro_torch.kernels import AttentionSpec, ops, ref
    from repro_torch.kernels.paged_attention import paged_chunk_mla
    gen = torch.Generator(device="cuda").manual_seed(14)
    bs, H, W, dv, scale = 16, 128, 576, 512, 192 ** -0.5
    F = torch.nn.functional
    for Cp, pos0, fused, pdt in MLA_CHUNK_CASES:
        pool, _, tables = _pool_case(torch, gen, 1, [pos0 + Cp], 1, W, bs,
                                     extra_blocks=1)
        pool = pool.to(getattr(torch, pdt))
        q = torch.randn((1, Cp, H, W), generator=gen, device="cuda")
        new = torch.randn((1, Cp, 1, W), generator=gen,
                          device="cuda").to(pool.dtype)
        if not fused:      # the pool-read mode reads the chunk's own rows
            pos = pos0 + torch.arange(Cp, device="cuda")
            pool[tables[0].long()[pos // bs], pos % bs] = new[0]
        kw = dict(scale=scale, fused_new=fused)
        ln = new if fused else None
        want = ref.paged_chunk_ref(q, ln, ln, pool, pool, tables, pos0,
                                   dv=dv, **kw)
        got = paged_chunk_mla(q, ln, pool, tables, pos0, dv=dv, **kw)
        torch.cuda.synchronize()
        name = f"mla chunk Cp={Cp} pos0={pos0} H={H} W={W} dv={dv} " \
            f"fused={fused}" + ("" if pdt == "float32" else f" pool={pdt}")
        err = check_close(name, got, want)
        t_k = timer.ms(lambda: paged_chunk_mla(q, ln, pool, tables, pos0,
                                               dv=dv, **kw))
        t_p = timer.ms(lambda: ref.paged_chunk_ref(q, ln, ln, pool, pool,
                                                   tables, pos0, dv=dv, **kw))
        # each input once: q, the visible context rows (plus the chunk's
        # own, from the pool or as operands), the table; the output once
        t_vis = sum(pos0 + i + 1 for i in range(Cp))
        nbytes = (q.numel() * 4 + (pos0 + Cp) * W * pool.element_size()
                  + tables.numel() * 4 + Cp * H * dv * 4)
        flops = 2 * H * t_vis * (W + dv)
        bound = max(nbytes / HBM_BYTES_S, flops / F32_FLOP_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_S >= flops / F32_FLOP_S \
            else "operations"
        work = dict(plan=(W, dv, "float32", pdt, False), nbytes=nbytes,
                    score_flops=2 * H * t_vis * W,
                    value_flops=2 * H * t_vis * dv, cuda_flops=0)
        # library: SDPA over the pre-gathered latent, keys expanded over
        # the heads, values = keys[..., :dv]
        T = pos0 + Cp
        lat = pool.clone()
        if fused:
            pos = pos0 + torch.arange(Cp, device="cuda")
            lat[tables[0].long()[pos // bs], pos % bs] = new[0]
        lat = lat[tables[0].long()].reshape(-1, W)[:T].float()
        k = lat[None, None].expand(1, H, T, W).contiguous()
        v = k[..., :dv].contiguous()
        qh = q.permute(0, 2, 1, 3).contiguous()
        mask = (torch.arange(T, device="cuda")[None, :]
                <= pos0 + torch.arange(Cp, device="cuda")[:, None])
        t_l = timer.ms(lambda: F.scaled_dot_product_attention(
            qh, k, v, attn_mask=mask[None, None], scale=scale))
        del k, v, qh
        results.append(dict(kernel="paged_chunk_mla", case=name, err=err,
                            ms=t_k, plain_ms=t_p, library_ms=t_l,
                            f32_bound_ms=bound, f32_bound_by=by, work=work))
        log(f"  {name}: err {err:.2e} kernel {t_k:.4f} ms plain {t_p:.4f} ms "
            f"sdpa {t_l:.4f} ms float32 bound {bound:.4f} ms ({by})")

    # a latent width the kernel lacks: CUDA tensors raise, never go plain
    n0 = paged_chunk_mla.launches
    q = torch.randn((1, 8, 4, 48), device="cuda")
    pool = torch.randn((4, 8, 1, 48), device="cuda")
    tables = torch.tensor([[1, 2, 0, 0]], dtype=torch.int32, device="cuda")
    spec = AttentionSpec(scale=0.2, kv_heads=1, latent_dv=32)
    for what, call in (
            ("wrapper", lambda: paged_chunk_mla(q, None, pool, tables, 5,
                                                dv=32, scale=0.2,
                                                fused_new=False)),
            ("route", lambda: ops.paged_latent_chunk_attention(
                q, pool, tables, 5, spec))):
        try:
            call()
        except ValueError as e:
            log(f"  latent width 48 / 32 on the card ({what}) raises: {e}")
        else:
            raise AssertionError(f"latent width 48 ran on the card ({what})")
    if paged_chunk_mla.launches != n0:
        raise AssertionError("a refused latent width launched the kernel")


# ---------------------------------------------------------------------------
# phases 3 and 4: the quickstart path at full width, with the tier off / on
# ---------------------------------------------------------------------------
def build_model(torch, cfg, profile=True):
    """``cfg`` (a full-width config cut in depth) with bf16 weights from a
    seeded generator, and its LIS swap order (front to back without
    ``profile``)."""
    from repro_torch.core import profile_swap_sequence
    from repro_torch.models import lm

    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    calib = torch.randint(0, cfg.vocab, (2, 32), device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(1))
    order = list(range(cfg.n_layers))
    if profile:
        order = profile_swap_sequence(cfg, params, calib, bits=4).order
    torch.cuda.synchronize()
    heads = (f"KVH={cfg.n_kv_heads}" if cfg.mla is None else
             f"MLA q_lora={cfg.mla.q_lora_rank} kv_lora="
             f"{cfg.mla.kv_lora_rank} rope={cfg.mla.qk_rope_head_dim}")
    m = cfg.moe
    experts = "" if m is None else (
        f" experts {m.n_routed_experts} routed (d_ff {m.d_ff_expert}, top-"
        f"{m.top_k}) + {m.n_shared_experts} shared")
    log(f"model: {cfg.name} x{cfg.n_layers} layers {lm.layer_kinds(cfg)} "
        f"d={cfg.d_model} H={cfg.n_heads} {heads} d_ff={cfg.d_ff}{experts} "
        f"vocab={cfg.vocab} {cfg.dtype}; "
        f"{'LIS' if profile else 'front-to-back'} swap order {order} "
        f"({time.perf_counter() - t0:.1f} s incl. init); params "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    return cfg, params, order


def _k1_estimate(by_shape, k1_shapes):
    """Estimated device time, in ms, of the K1 launches ``by_shape``
    ({(K, N, M bucket): launches}): each launch x the kernel phase's time
    of its own shape at the smallest timed M at or above its bucket's top
    (the largest timed M below that). Returns (ms, {(K, N): launches} of
    the shapes the kernel phase did not time)."""
    est, untimed = 0.0, collections.Counter()
    for (K, N, bucket), n in by_shape.items():
        times = k1_shapes.get((K, N))
        if not times:
            untimed[K, N] += n
            continue
        top = 10 ** 9 if bucket.startswith(">") else int(bucket.split("-")[-1])
        m = min((x for x in times if x >= top), default=max(times))
        est += n * times[m]
    return est, dict(untimed)


def _by_bucket(by_shape):
    """{M bucket: launches} of a {(K, N, M bucket): launches} count, in
    bucket order."""
    out = collections.Counter()
    for (_, _, b), n in by_shape.items():
        out[b] += n
    return {b: out[b] for b in K1_BUCKET_M if out[b]}


def engine_phase(torch, model, counters, *, kv_blocks, kv_quant, k1_shapes,
                 k2, need=("wna16_gemm", "paged_decode", "paged_chunk"),
                 ladder=(0, 1, 2, 4), rps=2.0):
    """Serve the quickstart trace (at ``rps`` requests a second) through
    ``MorphServeEngine`` with real compute under a budget of the weights
    plus ``kv_blocks`` float32 KV blocks, with the quantize-cold tier off
    or on, over the swap levels ``ladder``. ``counters`` maps each
    kernel's name to its (wrapper, counter attribute); the counts, K1's
    launches by shape and M bucket and K2's and K2-q's by table width are
    set to 0 just before the run and read just after. ``k1_shapes``
    ({(K, N): {M: ms}}, ``wna16_bounds``) prices each K1 launch by its own
    shape for an estimate of the run's K1 device time; ``k2``
    (``k2_table``) does the same for K2 and K2-q by table width. With the
    tier off, the kernels in ``need`` must have launched, a layer must
    have swapped and, where the family chunks, a prompt must have been
    chunked. A model with MoE layers also counts the K1 launches of its
    expert GEMMs apart and the MoE dispatch's host copies, and fails
    unless a swap quantized an MoE layer and its experts launched K1. An
    SSM or hybrid model logs its per-slot state bytes and its whole-prompt
    prefills, those whose SSD scan chunk fell below 16 apart, with their
    synchronized wall time."""
    from repro_torch.configs import ServingConfig
    from repro_torch.core import tree_bytes
    from repro_torch.engine import (EngineConfig, KVQuantConfig,
                                    MorphServeEngine, NVIDIA_H100_SXM,
                                    azure_like)
    from repro_torch.engine.kv_cache import kv_block_bytes
    from repro_torch.kernels.paged_attention import NB_BUCKETS, paged_decode
    from repro_torch.kernels.wna16_gemm import wna16_gemm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.mamba import ssd_chunk_len

    cfg, params, order = model
    wb = tree_bytes(params)
    bb = kv_block_bytes(cfg, 16, 4)
    # two blocks' slack (two bytes for an SSM model, whose block is 0 bytes:
    # the ledger books one block, of one byte)
    sc = ServingConfig(hbm_budget_bytes=int((wb + kv_blocks * bb) / 0.95)
                       + 2 * max(bb, 1),
                       kv_block_size=16, max_batch_slots=8, max_seq_len=1024,
                       swap_levels=ladder, mode="performance",
                       kv_resize_step_frac=0.25)
    ecfg = EngineConfig(policy="morph", compute="real", use_quant_kernel=True,
                        hw=NVIDIA_H100_SXM,
                        kv_quant=KVQuantConfig(enabled=kv_quant))
    t0 = time.perf_counter()
    eng = MorphServeEngine(cfg, params, sc, ecfg, swap_order=order,
                           device="cuda")
    torch.cuda.synchronize()
    log(f"engine built ({time.perf_counter() - t0:.1f} s): weights "
        f"{wb / 1e9:.3f} GB, KV block {bb / 1e6:.3f} MB, budget "
        f"{sc.hbm_budget_bytes / 1e9:.3f} GB (weights + {kv_blocks} "
        f"blocks), start pool {eng.pool.num_blocks - 1} blocks, "
        f"kv-quant tier {'on' if kv_quant else 'off'}")

    bad_logits = []

    calls = collections.Counter()

    def checked(fn, what):
        def run(*a, **kw):
            calls[what] += 1
            out = fn(*a, **kw)
            if not bool(torch.isfinite(out).all()):
                bad_logits.append(what)
            return out
        return run

    for what in ("decode", "prefill", "prefill_batch", "prefill_chunk"):
        setattr(eng.exec, what, checked(getattr(eng.exec, what), what))
    prefills = []                   # (prompt length, scan chunk, wall s)
    if eng.state_pool is not None:
        prefill_real = eng._prefill_real

        def timed_prefill(r):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = prefill_real(r)
            torch.cuda.synchronize()
            prefills.append((r.prompt_len, ssd_chunk_len(cfg, r.prompt_len),
                             time.perf_counter() - t))
            return out
        eng._prefill_real = timed_prefill

    trace = azure_like(duration_s=4.0, base_rps=rps, seed=3, prompt_mean=160,
                       gen_mean=24, prompt_max=512, gen_max=48)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    wna16_gemm.launches_by_shape.clear()
    paged_decode.launches_by_nb.clear()
    paged_decode.quant_launches_by_nb.clear()
    moe_layers = [i for i, k in enumerate(eng.kinds) if k.endswith("moe")]
    expert_by = collections.Counter()     # (K, N, M bucket) -> K1 launches
    matmul = moe_mod._expert_matmul

    def expert_matmul(xs, w, rows, plain=False):
        before = dict(wna16_gemm.launches_by_shape)
        out = matmul(xs, w, rows, plain)
        for key, n in wna16_gemm.launches_by_shape.items():
            if n != before.get(key, 0):
                expert_by[key] += n - before.get(key, 0)
        return out

    moe_mod._expert_matmul = expert_matmul
    moe_mod.moe_apply.host_syncs = 0
    gc.collect()      # engines of earlier phases no one holds (their wrapped
    #                   exec methods form reference cycles) leave the peak
    torch.cuda.reset_peak_memory_stats()
    cap0 = eng.pool.capacity
    t0 = time.perf_counter()
    try:
        report = eng.run_trace(trace)
        torch.cuda.synchronize()
    finally:
        moe_mod._expert_matmul = matmul
    wall = time.perf_counter() - t0
    host_syncs = moe_mod.moe_apply.host_syncs
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}
    k1_by = dict(wna16_gemm.launches_by_shape)
    k2_by_nb = {"paged_decode": dict(paged_decode.launches_by_nb),
                "paged_decode_q": dict(paged_decode.quant_launches_by_nb)}
    peak_alloc = torch.cuda.max_memory_allocated()

    hist = eng.monitor.history
    levels = sorted({t.swap_level for t in hist})
    blocks = [t.kv_total_blocks for t in hist]
    # the device bytes of the pool and its sidecar at the largest capacity
    # the run reached (every pool and sidecar tensor is capacity-wide)
    p = eng.pool
    peak_cap = max([cap0] + [p._cap_bucket(n + 1) for n in blocks] +
                   [p._cap_bucket(n + 1) for _, n in eng.resize_log])
    per_block = sum(t.numel() * t.element_size() for t in
                    (p.k, p.v, p.qk, p.qv, p.k_scale, p.v_scale, p.k_zero,
                     p.v_zero) if t is not None and t.ndim > 1) / p.capacity
    chunks = sum(r.prefill_chunks for r in eng.all_requests)
    tokens = sum(len(r.generated) for r in eng.all_requests)
    events = collections.Counter()
    for _, kind, n in eng.kv_quant_events:
        events[kind] += n
    log(f"served {report.n_finished}/{report.n_requests} requests; "
        f"{report.row()} (virtual clock, H100 cost model)")
    log(f"swap levels used {levels}; KV pool {blocks[0]} -> peak "
        f"{max(blocks)} -> end {blocks[-1]} blocks; swaps "
        f"{len(eng.actuator.swap_log)}, resizes {len(eng.resize_log)}, "
        f"chunk prefills {chunks}, steps {len(hist)}; first swap at "
        f"{eng.actuator.swap_log[0][0] if eng.actuator.swap_log else '-'} "
        f"s (virtual)")
    log(f"kv-quant events {len(eng.kv_quant_events)} (blocks: "
        f"{dict(events)}), peak quantized blocks "
        f"{max(t.kv_quant_blocks for t in hist)}, watchdog trips "
        f"{dict(collections.Counter(k for _, k, _ in eng.watchdog_trips))}")
    log(f"device bytes: pool + sidecar at the peak capacity of {peak_cap} "
        f"blocks {peak_cap * per_block / 1e6:.1f} MB (sidecar "
        f"{'allocated' if p.qk is not None else 'never allocated'}); "
        f"torch.cuda.max_memory_allocated over the run "
        f"{peak_alloc / 1e9:.3f} GB against the ledger's budget "
        f"{sc.hbm_budget_bytes / 1e9:.3f} GB")
    if eng.state_pool is not None:
        per_slot = eng.state_pool.state_bytes_per_slot()
        short = [x for x in prefills if x[1] < 16]
        log(f"SSM state: {per_slot / 1e6:.1f} MB a slot over "
            f"{len(eng.state_pool.layers)} layers, "
            f"{per_slot * eng.slots / 1e6:.1f} MB over {eng.slots} slots "
            f"(float32; not booked by the ledger, as in the JAX engine)")
        k3 = ": K3 is not on this path" if "hybrid" in eng.kinds else ""
        log(f"whole-prompt prefills {len(prefills)} (no chunking for this "
            f"family{k3}), {sum(x[2] for x in prefills):.2f} s wall "
            f"(synchronized); "
            f"{len(short)} of them scanned in chunks below 16 (lengths "
            f"past the 128-token chunk that 16 does not divide), "
            f"{sum(x[2] for x in short):.2f} s of that wall")
    log(f"engine wall time {wall:.2f} s for {tokens} generated tokens "
        f"(host clock, synchronized); real-compute calls {dict(calls)}; "
        f"launches {launches}")
    k1_est, untimed = _k1_estimate(k1_by, k1_shapes)
    shapes = collections.Counter()
    for (K, N, _), n in k1_by.items():
        shapes[f"{K}x{N}"] += n
    log(f"K1 launches by M {_by_bucket(k1_by)}, by shape {dict(shapes)}; "
        f"estimated K1 device time {k1_est:.1f} ms (an estimate: each "
        f"launch x the kernel phase's time of its own shape at the nearest "
        f"timed M at or above its bucket)"
        + (f"; shapes the kernel phase did not time {untimed}"
           if untimed else ""))
    n_expert = sum(expert_by.values())
    if moe_layers:
        other = collections.Counter(k1_by)
        other.subtract(expert_by)
        eshapes = collections.Counter()
        for (K, N, _), n in expert_by.items():
            eshapes[f"{K}x{N}"] += n
        log(f"MoE layers {moe_layers} (swap order positions "
            f"{[order.index(i) for i in moe_layers]}): expert K1 launches "
            f"{n_expert} of {launches['wna16_gemm']}, by M "
            f"{_by_bucket(expert_by)}, by shape {dict(eshapes)}; estimated "
            f"expert K1 device time "
            f"{_k1_estimate(expert_by, k1_shapes)[0]:.1f} ms; the other K1 "
            f"launches by M {_by_bucket(+other)}, estimated "
            f"{_k1_estimate(+other, k1_shapes)[0]:.1f} ms; MoE dispatch "
            f"host copies {host_syncs} (one an MoE layer a step)")
    widths = [str(w) for w in NB_BUCKETS] + [f">{NB_BUCKETS[-1]}"]
    for name, by_nb in k2_by_nb.items():
        if not by_nb:
            continue
        est, lost = k2_estimate(by_nb, name, k2)
        log(f"{name} launches by table width "
            f"{ {b: by_nb[b] for b in widths if b in by_nb} }; estimated "
            f"device time {est:.1f} ms, {lost:.1f} ms of it above the bound "
            f"(an estimate: each bucket's launches x the engine-shaped case "
            f"at that width or the next wider one)")
    fails = []
    for name, by_nb in k2_by_nb.items():
        if sum(by_nb.values()) != launches[name]:
            fails.append(f"{name} launches by table width {by_nb} do not add "
                         f"up to {launches[name]}")
    if sum(k1_by.values()) != launches["wna16_gemm"]:
        fails.append(f"K1 launches by shape {k1_by} do not add up to "
                     f"{launches['wna16_gemm']}")
    if report.n_finished != report.n_requests or report.n_requests == 0:
        fails.append("not every request was served")
    if kv_quant:
        if events["quantize"] <= 0:
            fails.append("the quantize-cold tier never quantized a block")
        if any(kind == "quant_ledger" for _, kind, _ in eng.watchdog_trips):
            fails.append("the watchdog corrected the quantized-block ledger")
        need = ("paged_decode_q", "paged_chunk_q")
    else:
        if max(levels) <= 0:
            fails.append("no swap level > 0 was reached")
        if eng._can_chunk() and chunks <= 0:
            fails.append("no chunked prefill happened")
        if not eng._can_chunk() and chunks:
            fails.append(f"{chunks} chunked prefills in a whole-prompt family")
        if moe_layers and max(levels) <= min(order.index(i)
                                             for i in moe_layers):
            fails.append("no swap quantized an MoE layer")
        if moe_layers and n_expert <= 0:
            fails.append("no expert GEMM launched K1")
    for name in need:
        if launches[name] <= 0:
            fails.append(f"kernel {name} was not launched on the main path")
    if bad_logits:
        fails.append(f"non-finite logits in {sorted(set(bad_logits))}")
    if fails:
        raise AssertionError("engine phase: " + "; ".join(fails))
    return eng, launches


# ---------------------------------------------------------------------------
# phase 5: decode and chunk steps, kernels vs plain
# ---------------------------------------------------------------------------
def parity_phase(torch, cfg, eng, quantized=True, fp_level=False,
                 pool_dtype=None, mid_levels=()):
    """One decode step (8 live sequences of ragged length) and one chunk
    step of the full-width model at the deepest swap level (every layer
    int4, so every matmul of the layers, each routed expert's included,
    goes through K1), through the kernels and through the plain versions,
    each from the same pool state; with ``fp_level`` the same two steps at
    level 0 first (bf16 weights: only the attention kernels differ); then,
    with ``quantized``, the deepest level's two steps with about half of
    the live blocks quantized (int8), through K2-q and K3-q (``eng`` is
    then the tier-on engine, whose attention specs take a bundle). The pool
    is float32, or ``pool_dtype``; ``mid_levels``: swap levels whose two
    steps run between level 0's and the deepest's. ``eng``
    is an engine or anything with its ``plan`` and ``exec``. For an MLA
    model the chunk step goes through K3-mla and the decode step's
    attention is plain torch on both sides. An MoE layer's routing is a
    discrete choice (the top K of up to 256 close scores), so a rounding
    difference upstream can flip a token's expert and move its logits by
    far more than the kernels differ: the plain step takes each MoE
    layer's routing from the kernel step (``models/moe.route``, call by
    call), and the tokens whose own choice would differ are counted and
    logged."""
    from repro_torch.engine.kv_cache import PagedKVPool
    from repro_torch.models import moe as moe_mod
    level = max(eng.plan.levels)
    ex = eng.exec
    bs, slots, nb_t, Sp = 16, 8, 16, 112
    lens = torch.tensor([100 - 7 * i for i in range(slots)],
                        dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)
    pool = PagedKVPool(cfg, slots * nb_t + 1, bs,
                       dtype=pool_dtype or torch.float32, device="cuda")
    tables = torch.arange(1, 1 + slots * nb_t, dtype=torch.int32,
                          device="cuda").reshape(slots, nb_t)
    prompts = torch.randint(0, cfg.vocab, (slots, Sp), generator=gen,
                            device="cuda")
    plain_run = False
    ex.prefill_batch(eng.plan.layer_list(level), prompts, pool.k, pool.v,
                     tables[:, :Sp // bs], lens)

    route, routes, flips = moe_mod.route, [], [0, 0]

    def pinned(p, cfg_, xf):
        mine = route(p, cfg_, xf)
        if plain_run:
            rec = routes.pop(0)
            a, b = (torch.sort(r[0], dim=-1).values for r in (mine, rec))
            flips[0] += int((a != b).any(-1).sum())
            flips[1] += a.shape[0]
            return rec
        routes.append(mine)
        return mine

    def compare(what, run):
        nonlocal plain_run
        kvq = pool.kv_quant_bundle()
        flips[:] = [0, 0]
        moe_mod.route = pinned
        try:
            plain_run = False
            a = run(pool.k.clone(), pool.v.clone(), kvq, False)
            plain_run = True
            b = run(pool.k.clone(), pool.v.clone(), kvq, True)
        finally:
            moe_mod.route = route
        torch.cuda.synchronize()
        if flips[1]:
            log(f"  MoE routing of the plain step pinned to the kernel "
                f"step's: {flips[0]} of {flips[1]} tokens x MoE layers "
                f"would have chosen other experts")
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        same = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        log(f"  {what}: max|logit diff| {err:.4e} vs tol "
            f"{LOGIT_TOL * scale:.4e} (max|logit| {scale:.3f}); argmax "
            f"agreement {same:.3f} (bf16 logits tie often)")
        if not (err <= LOGIT_TOL * scale) or not bool(
                torch.isfinite(a).all()):
            raise AssertionError(f"step parity failed for {what}")

    tokens = torch.randint(0, cfg.vocab, (slots, 1), generator=gen,
                           device="cuda")
    pos0 = int(lens[0])
    chunk = torch.randint(0, cfg.vocab, (1, 64), generator=gen, device="cuda")

    def steps(tag, lv=level):
        layers = eng.plan.layer_list(lv)
        what = ("bf16 weights" if lv == 0 else "all layers int4"
                if lv == level else f"{lv} of {cfg.n_layers} layers int4")
        compare(f"decode step ({slots} live slots, level {lv}: {what}{tag})",
                lambda k, v, kvq, plain: ex.decode(
                    layers, tokens, lens, k, v, tables, kvq=kvq,
                    plain=plain))
        compare(f"chunk step (Cp=64 at pos0={pos0}, level {lv}{tag})",
                lambda k, v, kvq, plain: ex.prefill_chunk(
                    layers, chunk, pos0, k, v, tables[0], kvq, plain=plain))

    if fp_level:
        steps("", 0)
    for lv in mid_levels:
        steps("", lv)
    steps("")
    if not quantized:
        return
    # quantize the first half of each sequence's full blocks (never the
    # tail the decode step appends to, nor the chunk's blocks)
    qids = [int(tables[i, j]) for i in range(slots)
            for j in range((int(lens[i]) // bs + 1) // 2)]
    pool.quantize_blocks(qids, bits=8)
    live = sum(-(-int(n) // bs) for n in lens)
    steps(f"; {len(qids)} of {live} live blocks int8")


def _as_f32(torch, tree):
    """A params tree with its bf16 tensors cast to float32 (QTensors as
    they are: the plain route dequantizes them in the activations' dtype)."""
    if isinstance(tree, dict):
        return {k: _as_f32(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_f32(torch, v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
        return tree.float()
    return tree


def _pct(xs):
    return " ".join(f"{100 * x:.2f}" for x in xs)


def ssm_parity_phase(torch, cfg, params, plan):
    """Whole-prompt prefill and one decode step of a full-width SSM or
    hybrid model, from the same pool and SSM state, through three routes:
    the kernels, their plain versions (both bf16), and the plain versions
    on float32 copies of the same weights (the witness: no bf16 rounding
    between layers), at level 0 and at the deepest level of ``plan``
    (every layer int4: its in_proj and out_proj, and Hymba's attention and
    MLP, through K1; Hymba's decode attention through K2 at every level).

    Holds the logits of the kernel route within ``LOGIT_TOL`` x max|plain
    logits| of the plain route. Holds the SSM state after the step against
    the witness: the kernel route's distance from it may pass the bf16
    plain route's own distance by at most ``STATE_TOL`` x max|state| (a
    float32 state fed by bf16 layers drifts with depth in either route,
    ROADMAP §3). Logs each layer's state gap, kernel vs plain, kernel vs
    witness and plain vs witness, in % of max|state|. Prefill: one prompt
    of 161 tokens (odd, so its scan runs a token a chunk) into slot 3;
    decode: 8 live slots whose state (and, for Hymba, KV) comes from
    prefills of 100 - 7 i tokens at the deepest level."""
    from repro_torch.engine.kv_cache import PagedKVPool, StatePool
    from repro_torch.engine.model_exec import ModelExec
    from repro_torch.models import lm
    kinds = lm.layer_kinds(cfg)
    misc = {k: v for k, v in params.items() if k != "segments"}
    ex, ex32 = ModelExec(cfg, misc, kinds), ModelExec(cfg, _as_f32(torch,
                                                                  misc), kinds)
    bs, slots, nb_t, S = 16, 8, 16, 161
    hybrid = "hybrid" in kinds
    gen = torch.Generator(device="cuda").manual_seed(23)
    pool = PagedKVPool(cfg, slots * nb_t + 12, bs, dtype=torch.float32,
                       device="cuda")
    sp = StatePool(cfg, slots, device="cuda")
    tables = torch.arange(1, 1 + slots * nb_t, dtype=torch.int32,
                          device="cuda").reshape(slots, nb_t)
    lens = torch.tensor([100 - 7 * i for i in range(slots)],
                        dtype=torch.int32, device="cuda")
    deepest = max(plan.levels)

    def blocks(ids):
        return ids if hybrid else ids[:0]

    for i in range(slots):
        n = int(lens[i])
        prompt = torch.randint(0, cfg.vocab, (1, n), generator=gen,
                               device="cuda")
        ex.prefill(plan.layer_list(deepest), prompt, pool.k, pool.v,
                   blocks(tables[i, :-(-n // bs)]), sp.conv, sp.ssm, i)
    prompt = torch.randint(0, cfg.vocab, (1, S), generator=gen, device="cuda")
    ids = blocks(torch.arange(1 + slots * nb_t, 1 + slots * nb_t + 11,
                              dtype=torch.int32, device="cuda"))
    tokens = torch.randint(0, cfg.vocab, (slots, 1), generator=gen,
                           device="cuda")

    def gaps(x, y, scale):
        """Each layer's max|x - y| over its state, over ``scale``."""
        d = (x - y).abs().flatten(1).amax(1) / scale
        return d.tolist()

    def compare(what, run):
        out = []
        for route in ("kernel", "plain", "f32"):
            k, v = pool.k.clone(), pool.v.clone()
            conv, ssm = sp.conv.clone(), sp.ssm.clone()
            out.append((run(route, k, v, conv, ssm).float(), conv, ssm))
        torch.cuda.synchronize()
        (a, ca, sa), (b, cb, sb), (w, cw, sw) = out
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        ok = err <= LOGIT_TOL * scale and bool(torch.isfinite(a).all())
        log(f"  {what}: max|logit diff| {err:.4e} vs tol "
            f"{LOGIT_TOL * scale:.4e} (max|logit| {scale:.3f}); from the "
            f"float32 witness: kernel {float((a - w).abs().max()):.4e}, "
            f"plain {float((b - w).abs().max()):.4e}")
        for name, x, y, z in (("conv", ca, cb, cw), ("ssm", sa, sb, sw)):
            st_scale = float(y.abs().max())
            kp, kw, pw = (gaps(x, y, st_scale), gaps(x, z, st_scale),
                          gaps(y, z, st_scale))
            ok &= max(kw) <= max(pw) + STATE_TOL
            ratios = [x / y for x, y in zip(kw, pw) if y > 0]
            log(f"    {name} state, % of max|state| {st_scale:.4e}: kernel "
                f"vs plain {100 * max(kp):.2f}, kernel vs witness "
                f"{100 * max(kw):.2f}, plain vs witness {100 * max(pw):.2f} "
                f"(tol: {100 * max(pw):.2f} + {100 * STATE_TOL:.2f}); the "
                f"kernel route is the farther from the witness on "
                f"{sum(x > y for x, y in zip(kw, pw))} of {len(kw)} layers, "
                f"median ratio of the two gaps "
                f"{statistics.median(ratios) if ratios else 1.0:.2f}")
            log(f"      by layer, kernel vs plain: {_pct(kp)}")
            log(f"      by layer, kernel vs witness: {_pct(kw)}")
            log(f"      by layer, plain vs witness: {_pct(pw)}")
        if not ok:
            raise AssertionError(f"step parity failed for {what}")

    for lv in (0, deepest):
        layers = plan.layer_list(lv)
        layers32 = [(kind, _as_f32(torch, p)) for kind, p in layers]

        def route(r):
            return ((ex32, layers32, True) if r == "f32" else
                    (ex, layers, r == "plain"))

        def prefill(r, k, v, conv, ssm):
            e, lay, plain = route(r)
            return e.prefill(lay, prompt, k, v, ids, conv, ssm, 3,
                             plain=plain)

        def decode(r, k, v, conv, ssm):
            e, lay, plain = route(r)
            return e.decode(lay, tokens, lens, k, v, tables, conv, ssm,
                            plain=plain)

        compare(f"prefill ({S} tokens into slot 3, level {lv})", prefill)
        compare(f"decode step ({slots} live slots, level {lv})", decode)
        del layers32


def maverick_phase(torch, counters):
    """Llama-4 Maverick's first two layers at full width (dense, then MoE:
    128 routed experts of d_ff 8192, top-1, one shared expert; 40 / 8
    heads), bf16 weights from a seeded generator, its int4 swap plan and a
    ModelExec (no engine run): ``parity_phase`` at level 0 and at level 2
    (both layers int4). Returns its kernel launches, which must include K1,
    K2 and K3."""
    from repro_torch.configs.archs import LLAMA4_MAVERICK_400B
    from repro_torch.core import build_swap_plan
    from repro_torch.engine.model_exec import ModelExec
    from repro_torch.models import moe as moe_mod
    cfg, params, order = build_model(
        torch, LLAMA4_MAVERICK_400B.replace(n_layers=2), profile=False)
    plan = build_swap_plan(cfg, params, order, bits=4, use_kernel=True)
    kinds = [k for k, _ in plan.fp_layers]
    eng = types.SimpleNamespace(plan=plan,
                                exec=ModelExec(cfg, params, kinds))
    log(f"Maverick swap plan: levels {plan.levels}, fp bytes "
        f"{[round(b / 1e9, 3) for b in plan.fp_bytes]} GB, int4 bytes "
        f"{[round(b / 1e9, 3) for b in plan.q_bytes]} GB; step parity "
        f"(kernels vs plain, tolerance {LOGIT_TOL} x max|logit|)")
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    moe_mod.moe_apply.host_syncs = 0
    parity_phase(torch, cfg, eng, quantized=False, fp_level=True)
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}
    launches["moe host copies"] = moe_mod.moe_apply.host_syncs
    missing = [k for k in ("wna16_gemm", "paged_decode", "paged_chunk")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"Maverick phase: {missing} never launched")
    return launches


# ---------------------------------------------------------------------------
# phases 13 and 14: the model API's encoder-decoder and VLM paths
# ---------------------------------------------------------------------------
def _k1_reset():
    from repro_torch.kernels.wna16_gemm import wna16_gemm
    wna16_gemm.launches = 0
    wna16_gemm.launches_by_shape.clear()


def _k1_none(what):
    """Fail unless K1 launched no time since ``_k1_reset``: a plain route
    that launched the kernel would hold the kernel against itself."""
    from repro_torch.kernels.wna16_gemm import wna16_gemm
    if wna16_gemm.launches:
        raise AssertionError(f"{what}: the plain route launched K1 "
                             f"{wna16_gemm.launches} times")


def _k1_log(what, k1_shapes):
    """Log K1's launches since ``_k1_reset`` by shape and M bucket, with
    their estimated device time; returns the launch count."""
    from repro_torch.kernels.wna16_gemm import wna16_gemm
    by = dict(wna16_gemm.launches_by_shape)
    shapes = collections.Counter()
    for (K, N, _), n in by.items():
        shapes[f"{K}x{N}"] += n
    est, untimed = _k1_estimate(by, k1_shapes)
    log(f"  {what}: K1 launches {wna16_gemm.launches}, by M {_by_bucket(by)}"
        f", by shape {dict(shapes)}, by (K, N, M bucket) "
        f"{ {f'{k[0]}x{k[1]} {k[2]}': n for k, n in sorted(by.items())} }; "
        f"estimated K1 device time {est:.2f} ms"
        + (f"; shapes the kernel phase did not time {untimed}"
           if untimed else ""))
    return wna16_gemm.launches


def _logits_close(torch, what, got, want):
    """Hold ``got`` within ``LOGIT_TOL`` x max|want| of ``want``; returns
    the largest gap over that scale."""
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    if not (err <= LOGIT_TOL * scale) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"{what}: max|logit diff| {err:.4e} past "
                             f"{LOGIT_TOL} x max|logit| {scale:.3f}")
    return err / scale


WHISPER_B, WHISPER_STEPS = 4, 32


def whisper_phase(torch, k1_shapes):
    """Whisper-small at full width (12 encoder and 12 decoder layers, d
    768, 12 heads of 64, d_ff 3072, vocab 51865, 1500 frames of 768), bf16
    weights from a seeded generator: ``encode`` of 4 seeded frame batches,
    then ``init_cache`` + ``start_cache`` + 32 greedy ``decode_step``
    calls, at the bf16 decoder and at an all-int4 one (each decoder
    layer's tree quantized with the kernel flag, as ``build_swap_plan``
    quantizes a layer, then restacked). At bf16 the steps are held against
    ``decode_forward``'s teacher-forced logits; at int4 the kernel route
    (K1 on every decoder matmul, the cross-attention k / v at M = 6000
    included) is fed the plain route's tokens and held against it step by
    step. Fails unless K1 launched in the int4 run. Returns its K1
    launches."""
    from repro_torch.configs.archs import WHISPER_SMALL as cfg
    from repro_torch.models import encdec, get_model
    from repro_torch.models import param_bytes as nbytes
    from repro_torch.models.lm import _index, _stack
    from repro_torch.quant import quantize_tree
    api = get_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init_params(cfg, gen)
    frames = torch.randn((WHISPER_B, cfg.encoder_seq, cfg.frontend_dim),
                         generator=gen, device="cuda").to(torch.bfloat16)
    first = torch.randint(0, cfg.vocab, (WHISPER_B, 1), generator=gen,
                          device="cuda")
    dec = params["dec_blocks"]
    q_dec = _stack([quantize_tree(_index(dec, i), bits=4, use_kernel=True)
                    for i in range(cfg.n_layers)])
    params_q = dict(params, dec_blocks=q_dec)
    torch.cuda.synchronize()
    log(f"model: {cfg.name} enc x{cfg.n_encoder_layers} dec x{cfg.n_layers} "
        f"d={cfg.d_model} H={cfg.n_heads} d_ff={cfg.d_ff} vocab={cfg.vocab} "
        f"frames {cfg.encoder_seq}x{cfg.frontend_dim} {cfg.dtype}; params "
        f"{nbytes(params) / 1e9:.3f} GB, the int4 decoder "
        f"{nbytes(q_dec) / 1e9:.3f} GB against {nbytes(dec) / 1e9:.3f} GB "
        f"({time.perf_counter() - t0:.1f} s incl. init and quantization)")

    def run(p, tokens=None, plain=False):
        """encode + start_cache + 32 steps into a fresh cache; greedy
        unless ``tokens`` (B, steps) are given; ``plain``: every K1 call
        takes its plain version. Returns (logits (B, steps, V), fed
        tokens, encoder states)."""
        enc = encdec.encode(cfg, p, frames, plain=plain)
        cache = api.start_cache(cfg, p, enc, api.init_cache(
            cfg, WHISPER_B, WHISPER_STEPS + 8, device="cuda"), plain=plain)
        tok, fed, out = first, [], []
        for t in range(WHISPER_STEPS):
            if tokens is not None:
                tok = tokens[:, t:t + 1]
            fed.append(tok)
            lg, cache = api.decode_step(cfg, p, cache, tok, plain=plain)
            out.append(lg)
            tok = lg.argmax(-1)
        return torch.cat(out, 1), torch.cat(fed, 1), enc

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lg, fed, enc = run(params)
        teacher = encdec.decode_forward(cfg, params, fed, enc)
        torch.cuda.synchronize()
        gap = _logits_close(torch, "whisper bf16: steps vs teacher-forced",
                            lg, teacher)
        log(f"  bf16 decoder: {WHISPER_STEPS} steps of {WHISPER_B} "
            f"sequences {time.perf_counter() - t0:.2f} s wall (incl. encode "
            f"and start_cache); steps vs decode_forward's teacher-forced "
            f"logits: max gap {gap:.4e} of max|logit| (tol {LOGIT_TOL})")
        _k1_reset()
        t0 = time.perf_counter()
        want, fed, _ = run(params_q, plain=True)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        _k1_none("whisper int4 decoder")
        t0 = time.perf_counter()
        got, _, _ = run(params_q, fed)
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        n = _k1_log("int4 decoder, kernel route", k1_shapes)
        gaps = [_logits_close(torch, f"whisper int4 step {t}", got[:, t],
                              want[:, t]) for t in range(WHISPER_STEPS)]
        same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"  int4 decoder: kernel route {t_kernel:.2f} s, plain route "
        f"{t_plain:.2f} s wall (each incl. encode and start_cache); per-step "
        f"max gap of max|logit|: largest {max(gaps):.4e}, median "
        f"{statistics.median(gaps):.4e} (tol {LOGIT_TOL}); argmax agreement "
        f"{same:.3f}; torch.cuda.max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if n <= 0:
        raise AssertionError("Whisper phase: K1 never launched at the int4 "
                             "decoder")
    return n


VLM_CALIB_TEXT, VLM_DECODE_STEPS = 32, 16


def internvl_phase(torch, k1_shapes):
    """InternVL2-1B at full width (24 layers, d 896, 14 / 2 heads of 64,
    d_ff 4864, vocab 151655, 256 image tokens of 1024 through the
    projector), bf16 weights from a seeded generator: the LIS profile with
    the frontend on a calibration batch of 2 x (256 image + 32 text)
    tokens, its layer variants int4 through K1; ``build_swap_plan`` on that
    order; ``lm.forward_unrolled`` with the frontend at levels 0 and 24,
    and ``prefill_collect`` of that prompt into ``lm.init_cache`` then 16
    text-token decode steps at both levels (``lm.decode_step`` at level 0,
    ``decode_step_unrolled`` over the per-layer caches at 24), the kernel
    route held against the plain route (fed the plain route's tokens).
    Fails unless K1 launched at level 24. Returns its K1 launches."""
    from repro_torch.configs.archs import INTERNVL2_1B as cfg
    from repro_torch.core import build_swap_plan, profile_swap_sequence
    from repro_torch.models import dummy_inputs, lm, param_bytes
    from repro_torch.models.lm import _index
    from repro_torch.quant import quantize_tree
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_params(cfg, gen)
    inputs = dummy_inputs(cfg, 2, cfg.n_image_tokens + VLM_CALIB_TEXT,
                          gen=gen, device="cuda")
    tokens, fe = inputs["tokens"], inputs["frontend"]
    layers = lm.params_to_layer_list(cfg, params)
    bank = [quantize_tree(lp, bits=4, use_kernel=True) for _, lp in layers]
    torch.cuda.synchronize()
    log(f"model: {cfg.name} x{cfg.n_layers} d={cfg.d_model} H={cfg.n_heads} "
        f"KVH={cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab} image "
        f"tokens {cfg.n_image_tokens}x{cfg.frontend_dim} {cfg.dtype}; "
        f"params {param_bytes(params) / 1e9:.3f} GB "
        f"({time.perf_counter() - t0:.1f} s incl. init and the int4 "
        f"variants)")
    _k1_reset()
    t0 = time.perf_counter()
    prof = profile_swap_sequence(cfg, params, tokens, bits=4, frontend=fe,
                                 quant_bank=bank)
    torch.cuda.synchronize()
    log(f"  LIS profile with the frontend (calibration 2 x ({cfg.n_image_tokens}"
        f" image + {VLM_CALIB_TEXT} text) tokens): {time.perf_counter() - t0:.2f}"
        f" s wall; order {prof.order}")
    n = _k1_log("LIS profile", k1_shapes)
    plan = build_swap_plan(cfg, params, prof.order, levels=(0, cfg.n_layers),
                           use_kernel=True)
    deepest = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()

    def decode(lv, tok0, feed=None, plain=False):
        """The image + text prompt's k/v in a fresh ``lm.init_cache``, then
        16 steps (greedy unless ``feed``): level 0 through the stacked
        API, the deepest level over per-layer caches; ``plain``: every K1
        call takes its plain version. Returns (logits, fed)."""
        layer_list = plan.layer_list(lv)
        _, pay = lm.prefill_collect(cfg, params, layer_list, tokens,
                                    frontend=fe, plain=plain)
        P = tokens.shape[1] + cfg.n_image_tokens
        cache = lm.init_cache(cfg, 2, P + VLM_DECODE_STEPS, device="cuda")
        (seg,) = cache["segments"]            # one run of 24 dense layers
        seg[0]["k"][:, :, :P] = torch.stack([x["k"] for x in pay])
        seg[0]["v"][:, :, :P] = torch.stack([x["v"] for x in pay])
        cache["pos"][:] = P
        caches = [_index(seg[0], i) for i in range(cfg.n_layers)]
        pos = cache["pos"]
        tok, fed, out = tok0, [], []
        for t in range(VLM_DECODE_STEPS):
            if feed is not None:
                tok = feed[:, t:t + 1]
            fed.append(tok)
            if lv == 0:
                lg, cache = lm.decode_step(cfg, params, cache, tok,
                                           plain=plain)
            else:
                lg, caches = lm.decode_step_unrolled(cfg, params, layer_list,
                                                     caches, pos, tok,
                                                     plain=plain)
                pos = pos + 1
            out.append(lg)
            tok = lg.argmax(-1)
        return torch.cat(out, 1), torch.cat(fed, 1)

    tok0 = tokens[:, -1:]
    with torch.no_grad():
        for lv in (0, deepest):
            layer_list = plan.layer_list(lv)
            _k1_reset()
            want = lm.forward_unrolled(cfg, params, layer_list, tokens,
                                       frontend=fe, plain=True)
            t0 = time.perf_counter()
            want_d, fed = decode(lv, tok0, plain=True)
            torch.cuda.synchronize()
            t_plain = time.perf_counter() - t0
            _k1_none(f"internvl level {lv}")
            _k1_reset()
            got = lm.forward_unrolled(cfg, params, layer_list, tokens,
                                      frontend=fe)
            t0 = time.perf_counter()
            got_d, _ = decode(lv, tok0, fed)
            torch.cuda.synchronize()
            t_kernel = time.perf_counter() - t0
            k1 = _k1_log(f"level {lv}, kernel route (forward, prefill, "
                         f"decode)", k1_shapes)
            n += k1
            g_fwd = _logits_close(torch, f"internvl forward level {lv}", got,
                                  want)
            gaps = [_logits_close(torch, f"internvl decode level {lv} step "
                                  f"{t}", got_d[:, t], want_d[:, t])
                    for t in range(VLM_DECODE_STEPS)]
            log(f"  level {lv}: forward with the frontend ({tuple(got.shape)}"
                f" logits) max gap {g_fwd:.4e} of max|logit|; prefill + "
                f"{VLM_DECODE_STEPS} decode steps: kernel route "
                f"{t_kernel:.2f} s, plain route {t_plain:.2f} s wall, "
                f"largest per-step gap {max(gaps):.4e} (tol {LOGIT_TOL})")
            if lv == deepest and k1 <= 0:
                raise AssertionError("InternVL2 phase: K1 never launched at "
                                     "the all-int4 level")
    log(f"  torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f}"
        f" GB")
    return n


# ---------------------------------------------------------------------------
# phases 15 and 16: the serving cluster on one card, and migration parity
# ---------------------------------------------------------------------------
CLUSTER_REPLICAS = 3
CLUSTER_RPS = 6.0          # three times the engine phase's 2.0
# Every replica's steps take CLUSTER_SLOW times their cost-model time on the
# virtual clock (a "slow" fault on each replica: equal factors keep the
# straggler detector quiet), so that requests hold KV across the 0.25 s
# dispatch rounds when the other faults land, as the reference's own
# migration tests stretch theirs. The fault times come from a rehearsal on
# the virtual clock in sim compute with the real plan's per-layer bytes
# (``swap_rate.real_bytes``): at 20x, the drain at 0.5 s finds slot-holders
# on replica 0, replica 1's heartbeat loss at 1.5 s (fenced at 2.0 s,
# rejoining 2 s later) finds live work to move, and the kill of replica 2
# at 2.5 s (rejoining 1 s later) leaves work to recompute.
CLUSTER_SLOW = 20.0


def _cluster_faults(FaultSpec):
    return tuple(FaultSpec("slow", 0.0, replica=i, factor=CLUSTER_SLOW)
                 for i in range(CLUSTER_REPLICAS)) + (
        FaultSpec("drain", 0.5, replica=0),
        FaultSpec("heal", 1.0, replica=0),
        FaultSpec("heartbeat_loss", 1.5, replica=1, duration_s=1.0),
        FaultSpec("kill", 2.5, replica=2, restart_delay_s=1.0))


def _finite_exec(torch, eng, bad):
    """Wrap ``eng``'s real-compute calls to note non-finite logits."""
    for what in ("decode", "prefill", "prefill_batch", "prefill_chunk"):
        fn = getattr(eng.exec, what)

        def run(*a, _fn=fn, _what=what, **kw):
            out = _fn(*a, **kw)
            if not bool(torch.isfinite(out).all()):
                bad.append(_what)
            return out
        setattr(eng.exec, what, run)
    return eng


def _synced(torch, fn, walls, key):
    """``fn`` with its synchronized wall time appended to ``walls[key]``."""
    def run(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        walls[key].append(time.perf_counter() - t)
        return out
    return run


def cluster_phase(torch, model, counters):
    """Serve the engine phase's trace at ``CLUSTER_RPS`` through a
    ``ServingCluster`` of ``CLUSTER_REPLICAS`` real-compute replicas on
    this card, all on the shared ``params``, each under the engine phase's
    budget (weights + 8 float32 KV blocks, ladder (0, 1, 2, 4)), with
    KV migration on (``MigrationConfig()``, 0.5 s heartbeat timeout) and
    the fault plan ``_cluster_faults``. Migrations are counted by cause
    (drain, heartbeat fencing) and re-dispatches by cause (drain, fencing,
    kill); each migration logs its blocks, host bytes and the synchronized
    device -> host, channel and host -> device walls beside the channel's
    modelled time; each migrated request's imported blocks are held
    bit-equal to the source's blocks, copied on the device before export.
    Fails unless every logical request ends with exactly one FINISHED
    record and none hangs, a drain and a fencing migration and a
    re-dispatch happened, a replica swapped, and K1, K2 and K3 launched in
    the run."""
    from repro_torch.configs import ServingConfig
    from repro_torch.core import tree_bytes
    from repro_torch.distributed import (FaultPlan, FaultSpec,
                                         MigrationChannel, MigrationConfig,
                                         ServingCluster)
    from repro_torch.engine import (EngineConfig, NVIDIA_H100_SXM,
                                    azure_like)
    from repro_torch.engine.kv_cache import PagedKVPool, kv_block_bytes

    cfg, params, _ = model
    wb = tree_bytes(params)
    bb = kv_block_bytes(cfg, 16, 4)
    sc = ServingConfig(hbm_budget_bytes=int((wb + 8 * bb) / 0.95) + 2 * bb,
                       kv_block_size=16, max_batch_slots=8, max_seq_len=1024,
                       swap_levels=(0, 1, 2, 4), mode="performance",
                       kv_resize_step_frac=0.25)
    ecfg = EngineConfig(policy="morph", compute="real", use_quant_kernel=True,
                        hw=NVIDIA_H100_SXM)
    mcfg = MigrationConfig()
    bad = []
    t0 = time.perf_counter()
    cl = ServingCluster(cfg, params, sc, ecfg, n_replicas=CLUSTER_REPLICAS,
                        heartbeat_timeout_s=0.5, restart_delay_s=2.0,
                        migration=mcfg, device="cuda")
    torch.cuda.synchronize()
    log(f"cluster built ({time.perf_counter() - t0:.1f} s): "
        f"{CLUSTER_REPLICAS} replicas on {cl.device}, each its own swap plan "
        f"over the shared weights ({wb / 1e9:.3f} GB); budget "
        f"{sc.hbm_budget_bytes / 1e9:.3f} GB a replica (weights + 8 blocks "
        f"of {bb / 1e6:.3f} MB); {mcfg}")
    for r in cl.replicas:
        _finite_exec(torch, r.engine, bad)

    # per-replica books, kept across fencing and restarts
    books = collections.defaultdict(lambda: collections.Counter())
    made = cl._make_engine

    def make_engine(i):
        books[i]["engines"] += 1
        return _finite_exec(torch, made(i), bad)
    cl._make_engine = make_engine
    for i in range(CLUSTER_REPLICAS):
        books[i]["engines"] += 1

    def book(i, e):
        books[i]["swaps"] += len(e.actuator.swap_log)
        books[i]["resizes"] += len(e.resize_log)
        books[i]["served"] += sum(q.state.name == "FINISHED"
                                  for q in e.all_requests)

    # cause attribution: the drain and fencing paths set it while they run
    cause = ["dispatch"]
    redispatch = collections.Counter()

    def attributed(fn, label):
        def run(i, *a, **kw):
            cause[0] = label(i)
            r0 = cl.redispatched
            try:
                return fn(i, *a, **kw)
            finally:
                redispatch[cause[0]] += cl.redispatched - r0
                cause[0] = "dispatch"
        return run

    harvest = cl._harvest_and_discard

    def harvest_and_book(i):
        e = cl.replicas[i].engine
        harvest(i)
        book(i, e)
    cl._drain = attributed(cl._drain, lambda i: "drain")
    cl._harvest_and_discard = attributed(
        harvest_and_book,
        lambda i: "fence" if cl.replicas[i].alive else "kill")

    walls = collections.defaultdict(list)
    sent = []                          # host bytes of each gather
    patched = [(PagedKVPool, "gather_blocks"), (PagedKVPool, "scatter_blocks"),
               (MigrationChannel, "transfer")]
    saved = [getattr(c, n) for c, n in patched]

    def gather(self, ids):
        k, v = saved[0](self, ids)
        sent.append(k.nbytes + (v.nbytes if v is not None else 0))
        return k, v
    results = []

    def transfer(self, *a, **kw):
        out = saved[2](self, *a, **kw)
        results.append(out[0])
        return out
    PagedKVPool.gather_blocks = _synced(torch, gather, walls, "d2h")
    PagedKVPool.scatter_blocks = _synced(torch, saved[1], walls, "h2d")
    MigrationChannel.transfer = _synced(torch, transfer, walls, "channel")

    migrations = []
    try_migrate = cl._try_migrate

    def migrate(q, src):
        e_src = cl.replicas[src].engine
        ids = list(q.block_ids) if e_src is not None else []
        before = None
        if ids:
            idx = torch.tensor(ids, device="cuda")
            before = (e_src.pool.k[:, idx].clone(),
                      e_src.pool.v[:, idx].clone())
        n0 = {k: len(v) for k, v in walls.items()}
        r0 = len(results)
        ok = try_migrate(q, src)
        rec = {"cause": cause[0], "cid": q.cluster_id, "src": src, "ok": ok,
               "blocks": len(ids), "tokens": q.context_len}
        for key in ("d2h", "channel", "h2d"):
            rec[key] = sum(walls[key][n0.get(key, 0):])
        if len(results) > r0:
            res = results[-1]
            rec.update(reason=res.reason, modelled_s=res.time_s,
                       wire_bytes=res.bytes, host_bytes=sent[-1])
        if ok:
            dst = [(j, x) for j, r in enumerate(cl.replicas)
                   if j != src and r.engine is not None
                   for x in r.engine.running if x.cluster_id == q.cluster_id]
            assert len(dst) == 1, f"migrated cid {q.cluster_id} found {dst}"
            j, x = dst[0]
            pool = cl.replicas[j].engine.pool
            idx = torch.tensor(x.block_ids, device="cuda")
            rec["dst"] = j
            rec["bit_equal"] = (before is not None
                                and torch.equal(pool.k[:, idx], before[0])
                                and torch.equal(pool.v[:, idx], before[1]))
        migrations.append(rec)
        return ok
    cl._try_migrate = migrate

    trace = azure_like(duration_s=4.0, base_rps=CLUSTER_RPS, seed=3,
                       prompt_mean=160, gen_mean=24, prompt_max=512,
                       gen_max=48)
    plan = FaultPlan(specs=_cluster_faults(FaultSpec), seed=0)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        report = cl.run(trace, plan)
        torch.cuda.synchronize()
    finally:
        for (c, n), fn in zip(patched, saved):
            setattr(c, n, fn)
    wall = time.perf_counter() - t0
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for i, r in enumerate(cl.replicas):
        if r.engine is not None:
            book(i, r.engine)

    finished = collections.Counter()
    other = []
    for q in cl.collect_requests():
        if q.state.name == "FINISHED":
            finished[q.cluster_id] += 1
        else:
            other.append((q.cluster_id, q.state.name))
    by_cause = collections.Counter((m["cause"], m["ok"]) for m in migrations)
    log(f"served {report.n_finished}/{report.n_requests} requests, hung "
        f"{report.n_hung}, redispatched {report.n_redispatched}, migrated "
        f"{report.n_migrated}; {report.row()} (virtual clock, H100 cost "
        f"model, steps x {CLUSTER_SLOW:g})")
    shown = [(f.kind, f.start_s, f.replica) for f in plan.specs
             if f.kind != "slow"]
    log(f"faults: {shown}; "
        f"detected failures {cl.detected_failures}, drains {cl.drains}; "
        f"migrations by (cause, ok) {dict(by_cause)}; re-dispatches by cause "
        f"{dict(redispatch)}")
    log(f"migration_stats() {cl.migration_stats()}")
    unsent = collections.Counter(m["cause"] for m in migrations
                                 if "reason" not in m)
    log(f"  attempts with no transfer (no slot-holder to export, or no "
        f"peer to take it) by cause: {dict(unsent)}")
    for m in migrations:
        if "reason" not in m:
            continue
        outcome = ("migrated" if m["ok"] else
                   f"channel {m['reason']}" if m["reason"] != "ok" else
                   "refused at the destination (capacity, or killed)")
        log(f"  migration cid {m['cid']} ({m['cause']}) {m['src']} -> "
            f"{m.get('dst', '-')}: {outcome}, {m['blocks']} blocks "
            f"({m['tokens']} tokens), host {m['host_bytes'] / 1e6:.2f} MB "
            f"(float32), wire {m['wire_bytes'] / 1e6:.2f} MB modelled; device"
            f"->host {m['d2h'] * 1e3:.2f} ms, channel (CRC, host) "
            f"{m['channel'] * 1e3:.2f} ms, host->device {m['h2d'] * 1e3:.2f} "
            f"ms (synchronized walls) against modelled "
            f"{m['modelled_s'] * 1e3:.3f} ms at {mcfg.link_gbps:g} GB/s"
            + (f"; imported blocks bit-equal: {m['bit_equal']}"
               if m["ok"] else ""))
    for i in sorted(books):
        log(f"  replica {i}: engines {books[i]['engines']} (restarts "
            f"{books[i]['engines'] - 1}), swaps {books[i]['swaps']}, resizes "
            f"{books[i]['resizes']}, served {books[i]['served']}")
    hist = cl.collect_history()
    log(f"cluster wall time {wall:.2f} s (host clock, synchronized); "
        f"engine steps {len(hist)} ({sum(t.decode_tokens > 0 for t in hist)}"
        f" with a decode); "
        f"launches {launches}; torch.cuda.max_memory_allocated "
        f"{peak / 1e9:.3f} GB against the replicas' budgets summed "
        f"{len(cl.replicas) * sc.hbm_budget_bytes / 1e9:.3f} GB (the "
        f"weights, {wb / 1e9:.3f} GB, are held once)")

    fails = []
    if report.n_hung or other or set(finished) != set(range(len(trace))) \
            or any(n != 1 for n in finished.values()):
        fails.append(f"not every request finished exactly once (hung "
                     f"{report.n_hung}, other records {other[:8]}, finished "
                     f"{len(finished)} of {len(trace)}, twice "
                     f"{[c for c, n in finished.items() if n != 1]})")
    for what in ("drain", "fence"):
        if by_cause[what, True] < 1:
            fails.append(f"no {what} migration succeeded")
    if cl.redispatched < 1 or redispatch["kill"] < 1:
        fails.append(f"no re-dispatch after the kill ({dict(redispatch)})")
    checked = [m["bit_equal"] for m in migrations if m["ok"]]
    if not checked or not all(checked):
        fails.append(f"imported blocks not bit-equal to the source's "
                     f"({checked})")
    if sum(b["swaps"] for b in books.values()) < 1:
        fails.append("no replica swapped a layer")
    for name in ("wna16_gemm", "paged_decode", "paged_chunk"):
        if launches[name] <= 0:
            fails.append(f"kernel {name} was not launched in the cluster run")
    if bad:
        fails.append(f"non-finite logits in {sorted(set(bad))}")
    if fails:
        raise AssertionError("cluster phase: " + "; ".join(fails))
    return launches


MIG_PROMPT, MIG_GEN, MIG_STOP = 300, 24, 8
MIG_SHARED = 256           # the two prefix-migration prompts share this


def _track(torch, eng, bad):
    """Wrap ``eng`` (one request at a time) to keep the logits row of each
    token it produces, by token index, and each argmax's top-2 gap."""
    _finite_exec(torch, eng, bad)
    rows = {}
    last = {}
    for what in ("decode", "prefill_chunk"):
        fn = getattr(eng.exec, what)

        def run(*a, _fn=fn, _what=what, **kw):
            last[_what] = _fn(*a, **kw)
            return last[_what]
        setattr(eng.exec, what, run)
    dec, chunk = eng._decode_real, eng._prefill_chunk_real

    def decode_real(run):
        n = [(r, len(r.generated)) for r in run]
        dec(run)
        for r, i in n:
            rows[i] = last["decode"][r.slot].float().clone()

    def prefill_chunk(r, clen):
        first = chunk(r, clen)
        if first is not None:
            rows[len(r.generated)] = last["prefill_chunk"][clen - 1] \
                .float().clone()
        return first
    eng._decode_real, eng._prefill_chunk_real = decode_real, prefill_chunk
    return rows


def _gap(torch, rows):
    """The smallest top-2 gap over the logits ``rows``."""
    return min(float(torch.topk(x, 2).values.diff().abs()[0]) for x in rows)


def _submit(eng, prompt, gen):
    from repro_torch.engine import TraceRequest
    return eng.submit(TraceRequest(0.0, len(prompt), gen, tuple(prompt)))


def _serve(eng, r, stop=None, at=None, hook=None):
    """Step ``eng`` until its request ``r`` finishes or has ``stop``
    tokens; ``hook(eng, r)`` runs once when it holds ``at`` tokens."""
    for _ in range(10 * (r.prompt_len + r.max_new_tokens)):
        if hook is not None and len(r.generated) == at:
            hook(eng, r)
            hook = None
        if r.state.name == "FINISHED" or \
                (stop is not None and len(r.generated) >= stop):
            return r
        eng.step()
    raise AssertionError(f"request not done: {r.state.name}, "
                         f"{len(r.generated)} tokens")


def _parts(a, b):
    """(equal, first index where the streams part)."""
    n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    return list(a) == list(b), n


def migration_parity_phase(torch, model, counters):
    """Migration at full width, single greedy requests on engines pinned at
    the fp level (``static_fp16``, one swap plan shared), budget weights +
    64 float32 KV blocks, chunk budget 256: (a) a 300-token prompt's
    request exported after 8 of its 24 tokens, through
    ``MigrationChannel.transfer`` into a third engine, must finish with the
    uninterrupted reference's stream (its first post-import logits held to
    the reference's at ``TOL['bfloat16']``); (b) the same export through
    the int8-compressing channel lands within the codec's error (the stream
    is logged, not required); (c) with about half of the request's blocks
    quantized (int8) on the source and, at the same step, on the
    reference, the quantized blocks cross as codec payload and the
    destination decodes through K2-q, with the reference's stream; (d) a
    prompt sharing a 256-token prefix with one served on engine A is served
    on engine B after A's cached prefix migrated there (``
    export_prefix_payload`` -> channel -> ``import_prefix_chain``): its
    chunked prefill (K3) reads the adopted blocks, and its stream must equal
    the prompt's on a fresh engine."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import ServingConfig
    from repro_torch.core import build_swap_plan, tree_bytes
    from repro_torch.distributed import MigrationChannel, MigrationConfig
    from repro_torch.engine import (EngineConfig, KVQuantConfig,
                                    MorphServeEngine, NVIDIA_H100_SXM)
    from repro_torch.engine.kv_cache import kv_block_bytes

    cfg, params, order = model
    wb = tree_bytes(params)
    bb = kv_block_bytes(cfg, 16, 4)
    sc = ServingConfig(hbm_budget_bytes=int((wb + 64 * bb) / 0.95) + 2 * bb,
                       kv_block_size=16, max_batch_slots=8, max_seq_len=1024,
                       swap_levels=(0, 1, 2, 4), mode="performance")
    plan = build_swap_plan(cfg, params, order, serving=sc, bits=4,
                           use_kernel=True)
    bad = []

    def engine(**kw):
        ec = EngineConfig(policy="static_fp16", compute="real",
                          use_quant_kernel=True, hw=NVIDIA_H100_SXM,
                          max_tokens_per_step=256, **kw)
        return MorphServeEngine(cfg, params, sc, ec, device="cuda",
                                plan=plan)

    def reset():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}

    def channel(src, **kw):
        return MigrationChannel(MigrationConfig(**kw), src.cost,
                                dtype_bytes=src.cost.dtype_bytes)

    def blocks(eng, ids, names=("k", "v")):
        idx = torch.tensor(list(ids), device="cuda")
        return [getattr(eng.pool, n)[:, idx].clone() for n in names]

    walls = collections.defaultdict(list)
    gen = torch.Generator().manual_seed(23)
    prompt = torch.randint(1, cfg.vocab, (MIG_PROMPT,), generator=gen).tolist()
    fails = []

    # (a) plain migration, and (b) the same export through int8 compression
    ref = engine()
    ref_rows = _track(torch, ref, bad)
    want = _serve(ref, _submit(ref, prompt, MIG_GEN)).generated
    src = engine()
    _track(torch, src, bad)
    r = _serve(src, _submit(src, prompt, MIG_GEN), stop=MIG_STOP)
    before = blocks(src, r.block_ids)
    st = _synced(torch, src.export_request_state, walls, "d2h")(r)
    res, k, v = _synced(torch, channel(src).transfer, walls, "channel")(
        st.n_blocks, st.k, st.v)
    res_c, kc, vc = channel(src, compress_int8=True).transfer(
        st.n_blocks, st.k, st.v)
    src.detach_request(r)
    del src
    host = st.k.nbytes + st.v.nbytes
    out = {}
    for name, (kk, vv, rr) in (("plain", (k, v, res)),
                               ("int8", (kc, vc, res_c))):
        if not rr.ok:
            raise AssertionError(f"migration parity: {name} transfer "
                                 f"{rr.reason}")
        dst = engine()
        rows = _track(torch, dst, bad)
        reset()
        imp = _synced(torch, dst.import_request_state, walls, "h2d")
        r2 = imp(dataclasses.replace(st, k=kk, v=vv))
        got = blocks(dst, r2.block_ids)
        r2 = _serve(dst, r2)
        out[name] = (r2.generated, rows, got, read(), rr)
        del dst
    stream, rows, got, launched, _ = out["plain"]
    same, part = _parts(stream, want)
    first = MIG_STOP
    g, w = rows[first], ref_rows[first]
    rtol, atol = TOL["bfloat16"]
    err = (g - w).abs()
    scale = float(w.abs().max())
    gap = _gap(torch, ref_rows.values())
    bit = all(torch.equal(a, b) for a, b in zip(got, before))
    log(f"(a) plain: {st.n_blocks} blocks ({len(st.prompt) + MIG_STOP} "
        f"tokens) exported after {MIG_STOP} of {MIG_GEN} tokens; host "
        f"{host / 1e6:.2f} MB (float32), wire {res.bytes / 1e6:.2f} MB "
        f"modelled; device->host {walls['d2h'][0] * 1e3:.2f} ms, channel "
        f"{walls['channel'][0] * 1e3:.2f} ms, host->device "
        f"{walls['h2d'][0] * 1e3:.2f} ms (synchronized) against modelled "
        f"{res.time_s * 1e3:.3f} ms at {MigrationConfig().link_gbps:g} GB/s; "
        f"imported "
        f"blocks bit-equal {bit}; stream equal {same} (parts at {part}); "
        f"first post-import logits max|diff| {float(err.max()):.3e} (max|ref|"
        f" {scale:.3f}); reference's smallest top-2 gap {gap:.4e}; "
        f"destination launches {launched}")
    if not same:
        fails.append(f"(a) stream parts from the reference at token {part} "
                     f"(reference's top-2 gap there "
                     f"{_gap(torch, [ref_rows[part]]):.4e})")
    if not bool((err <= rtol * w.abs() + atol * scale).all()):
        fails.append(f"(a) first post-import logits off the reference's by "
                     f"{float(err.max()):.3e} (TOL {TOL['bfloat16']})")
    if not bit:
        fails.append("(a) imported blocks differ from the source's")
    if launched["paged_decode"] <= 0:
        fails.append("(a) K2 did not launch on the destination")
    stream_c, _, got_c, _, _ = out["int8"]
    codec_ok, worst = True, 0.0
    cb = MigrationConfig().chunk_blocks
    for x, y in ((st.k, kc), (st.v, vc)):
        for a in range(0, st.n_blocks, cb):
            xs, ys = x[:, a:a + cb], y[:, a:a + cb]
            # half the chunk's step, plus a float32 ulp at its largest
            # value for the rounding of x / scale and of q x scale
            amax = float(np.abs(xs).max())
            bound = 0.5 * amax / 127.0 + amax * 2.0 ** -22
            e = float(np.abs(xs - ys).max())
            worst = max(worst, e / bound if bound else 0.0)
            codec_ok &= e <= bound
    landed = all(torch.equal(t, torch.as_tensor(y).to(t.device))
                 for t, y in zip(got_c, (kc, vc)))
    same_c, part_c = _parts(stream_c, want)
    log(f"(b) int8 compression: wire {res_c.bytes / 1e6:.2f} MB modelled; "
        f"received within the codec's half step of each chunk's scale "
        f"({worst:.4f} of that bound at worst); landed as received "
        f"{landed}; stream equal {same_c} (parts at {part_c} of {MIG_GEN}; "
        f"logged, not required)")
    if not (codec_ok and landed):
        fails.append("(b) int8-compressed blocks off the codec's error")
    del ref, out, got, got_c, before

    # (c) quantized blocks travel as codec payload; decode through K2-q
    def quantize_half(eng, r):
        ids = r.block_ids[:len(r.block_ids) // 2]
        done = eng.pool.quantize_blocks(ids, bits=8)
        eng.ledger.quantize_kv(len(done))
    tier = dict(kv_quant=KVQuantConfig(enabled=True))
    ref = engine(**tier)
    _track(torch, ref, bad)
    want_q = _serve(ref, _submit(ref, prompt, MIG_GEN), at=MIG_STOP,
                    hook=quantize_half).generated
    src = engine(**tier)
    _track(torch, src, bad)
    r = _serve(src, _submit(src, prompt, MIG_GEN), stop=MIG_STOP)
    quantize_half(src, r)
    qids = [b for b in r.block_ids if b in src.pool.qbits]
    qbefore = blocks(src, qids, src.pool._SIDECAR)
    st = src.export_request_state(r)
    res, k, v = channel(src).transfer(
        st.n_blocks, st.k, st.v, quant=st.quant_payload,
        quant_bits=st.quant_bits, quant_blocks=len(st.quant_idx))
    src.detach_request(r)
    del src
    dst = engine(**tier)
    _track(torch, dst, bad)
    reset()
    r2 = dst.import_request_state(dataclasses.replace(
        st, k=k, v=v, quant_payload=res.quant))
    qgot = blocks(dst, [r2.block_ids[i] for i in st.quant_idx],
                  dst.pool._SIDECAR)
    r2 = _serve(dst, r2)
    launched = read()
    same, part = _parts(r2.generated, want_q)
    qbit = all(torch.equal(a, b) for a, b in zip(qgot, qbefore))
    log(f"(c) quantized KV: {len(st.quant_idx)} of {st.n_blocks} blocks "
        f"int8 on the source (and on the reference at token {MIG_STOP}), "
        f"crossing as codec payload ({res.chunks} chunks, wire "
        f"{res.bytes / 1e6:.2f} MB modelled); payload and sidecar landed "
        f"bit-equal {qbit}; stream equal {same} (parts at {part}); "
        f"destination launches {launched}")
    if not same:
        fails.append(f"(c) stream parts from the reference at token {part}")
    if not qbit:
        fails.append("(c) quantized payload changed in transit")
    if launched["paged_decode_q"] <= 0:
        fails.append("(c) K2-q did not launch on the destination")
    del ref, dst, qgot, qbefore

    # (d) a cached prefix migrates; the chunk walk reads the adopted blocks
    shared = prompt[:MIG_SHARED]
    tails = torch.randint(1, cfg.vocab, (2, MIG_PROMPT - MIG_SHARED),
                          generator=gen).tolist()
    p1, p2 = shared + tails[0], shared + tails[1]
    pre = dict(prefix_caching=True)
    a_eng = engine(**pre)
    _track(torch, a_eng, bad)
    _serve(a_eng, _submit(a_eng, p1, MIG_STOP))
    bs = a_eng.prefix_cache.block_size
    entries = a_eng.prefix_cache.peek(p2, len(p2) // bs)
    kx, vx, qidx, qbits, qpay = a_eng.export_prefix_payload(entries)
    res, kx, vx = channel(a_eng).transfer(
        len(entries), kx, vx, quant=qpay, quant_bits=qbits,
        quant_blocks=len(qidx))
    b_eng = engine(**pre)
    _track(torch, b_eng, bad)
    adopted = b_eng.import_prefix_chain(
        p2, [e.level for e in entries], len(entries), kx, vx,
        quant_idx=qidx, quant_bits=qbits,
        quant=res.quant if qpay is not None else None,
        tols=[e.tol for e in entries])
    mine = b_eng.prefix_cache.peek(p2, len(p2) // bs)
    pbit = all(torch.equal(a, b) for a, b in zip(
        blocks(b_eng, [e.block_id for e in mine]),
        blocks(a_eng, [e.block_id for e in entries])))
    del a_eng
    reset()
    got_d = _serve(b_eng, _submit(b_eng, p2, MIG_GEN)).generated
    launched = read()
    c_eng = engine(**pre)
    c_rows = _track(torch, c_eng, bad)
    want_d = _serve(c_eng, _submit(c_eng, p2, MIG_GEN)).generated
    same, part = _parts(got_d, want_d)
    log(f"(d) prefix: {len(entries)} cached blocks of A's prefix "
        f"({MIG_SHARED} shared tokens) migrated to B ({res.reason}, "
        f"{res.bytes / 1e6:.2f} MB modelled), {adopted} adopted, bit-equal "
        f"{pbit}; B's prefix hits {b_eng.prefix_hit_requests}, prefill "
        f"tokens saved {b_eng.prefill_tokens_saved}; stream equal to a "
        f"fresh engine's {same} (parts at {part}; the fresh engine's "
        f"smallest top-2 gap {_gap(torch, c_rows.values()):.4e}); B's "
        f"launches {launched}")
    if adopted != MIG_SHARED // bs or not pbit or \
            b_eng.prefill_tokens_saved != MIG_SHARED:
        fails.append(f"(d) prefix not adopted whole ({adopted} blocks, "
                     f"bit-equal {pbit}, saved {b_eng.prefill_tokens_saved})")
    if not same:
        fails.append(f"(d) stream parts from the fresh engine's at token "
                     f"{part}")
    if launched["paged_chunk"] <= 0:
        fails.append("(d) K3 did not launch on B")
    if bad:
        fails.append(f"non-finite logits in {sorted(set(bad))}")
    if fails:
        raise AssertionError("migration parity phase: " + "; ".join(fails))


# ---------------------------------------------------------------------------
# phase 17: training at full width
# ---------------------------------------------------------------------------
# Llama-2-7B at full width cut to TRAIN_LAYERS, bf16 weights; train_4k's
# sequence length, its global batch of 256 cut to what one card holds
TRAIN_LAYERS = 8
TRAIN_B, TRAIN_S = 2, 4096
TRAIN_STEPS = 8
# AdamW writes the new weight back in the weight's dtype, as in JAX, so a
# step must be large enough to move a bf16 weight of 1.0 (a norm's scale,
# whose bf16 neighbours lie 2**-8 below and 2**-7 above) for every leaf to
# change at step 1: lr 3e-3 without warmup, cosine over the 8 steps
TRAIN_OPT = dict(lr=3e-3, warmup_steps=0, total_steps=TRAIN_STEPS)
# the checkpoint's cut: 2 layers at S = 1024 (6.7 GB of state on disk),
# saved in 2 host shards
CKPT_LAYERS, CKPT_S, CKPT_SHARDS = 2, 1024, 2
# the float32 witness (the same weights as float32 copies, the same batch):
# the bf16 route rounds every weight, activation and gradient to 2**-9
# relative; over 8 layers and the backward pass that stays a few percent
WITNESS_LOSS_RTOL = 1e-2      # loss, relative
WITNESS_NORM_RTOL = 5e-2      # global gradient norm, relative
WITNESS_COS = 0.99            # each leaf gradient's cosine (each layer's)
# remat "dots" against "full": the same forward ops, and under
# deterministic algorithms the same backward values
REMAT_RTOL = 1e-6             # loss and gradient norm, relative
# int8 compression's error feedback: half a scale step, plus the float32
# rounding of a product of up to 127 steps
HALF_STEP = 0.5 + 127 * 2.0 ** -22


def _sync_wall(torch, fn, *a):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*a)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _train_batch(torch, cfg, B, S):
    """(tokens, labels) int32 on the card: step 0 of the Markov stream."""
    from repro_torch.data import DataConfig, batch_at
    x, y = batch_at(DataConfig(vocab=cfg.vocab, seq_len=S, batch_size=B,
                               seed=0), 0, 0)
    return (torch.from_numpy(x).to("cuda"), torch.from_numpy(y).to("cuda"))


class _Deterministic:
    """Deterministic algorithms inside the block (cuBLAS at a fixed
    workspace; an accumulating index is no longer an atomic add), no
    fill of uninitialized memory."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        import os
        import torch.utils.deterministic as det
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        self.was = (self.torch.are_deterministic_algorithms_enabled(),
                    det.fill_uninitialized_memory)
        self.torch.use_deterministic_algorithms(True)
        det.fill_uninitialized_memory = False

    def __exit__(self, *exc):
        import torch.utils.deterministic as det
        self.torch.use_deterministic_algorithms(self.was[0])
        det.fill_uninitialized_memory = self.was[1]


def _cosines(torch, a, b, stacked):
    """Cosine of two gradient leaves in float64: of the whole leaf and of
    each layer of a stacked one."""
    dots, na, nb = [], [], []
    for x, y in zip(a.unbind(0) if stacked else [a],
                    b.unbind(0) if stacked else [b]):
        x, y = x.double().flatten(), y.double().flatten()
        dots.append(float(x @ y))
        na.append(float(x @ x))
        nb.append(float(y @ y))
    per = [d / max((p * q) ** 0.5, 1e-300) for d, p, q in zip(dots, na, nb)]
    whole = sum(dots) / max((sum(na) * sum(nb)) ** 0.5, 1e-300)
    return whole, per


def _witness(torch, cfg, params, grads, loss, lg, x, y):
    """(b): the first step's loss and gradients on float32 copies of the
    weights, against the bf16 route's. Logs each layer's worst cosine and
    relative gap; raises past the stated tolerances."""
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten_with_path
    from repro_torch.distributed.sharding import path_str
    p32 = _as_f32(torch, params)
    (loss32, g32), wall = _sync_wall(torch, lg, p32, x, y)
    del p32
    n16, n32 = float(adamw.global_norm(grads)), float(adamw.global_norm(g32))
    loss, loss32 = float(loss), float(loss32)
    log(f"  (b) float32 witness: loss bf16 {loss:.6f} f32 {loss32:.6f} "
        f"(rel {abs(loss - loss32) / abs(loss32):.2e}, tol "
        f"{WITNESS_LOSS_RTOL}); grad norm bf16 {n16:.6f} f32 {n32:.6f} "
        f"(rel {abs(n16 - n32) / n32:.2e}, tol {WITNESS_NORM_RTOL}); "
        f"witness step {wall:.2f} s")
    g32 = dict(flatten_with_path(g32))
    worst, by_layer, misses = (None, 1.0), collections.defaultdict(list), []
    for path, g in flatten_with_path(grads):
        name = path_str(path)
        stacked = name.startswith("segments/") and g.dim() >= 1 \
            and g.shape[0] == cfg.n_layers
        gap = float((g.float() - g32[path]).norm() / g32[path].norm())
        whole, per = _cosines(torch, g, g32[path], stacked)
        for li, c in enumerate(per if stacked else []):
            by_layer[li].append((c, name))
        if whole < worst[1]:
            worst = (name, whole)
        if min(per) < WITNESS_COS:
            misses.append(f"{name} {min(per):.5f}")
        log(f"    {name}: cos {whole:.6f} (layers "
            f"{min(per):.6f}-{max(per):.6f}), rel L2 gap {gap:.3e}")
    for li, cs in sorted(by_layer.items()):
        c, name = min(cs)
        log(f"    layer {li}: worst cos {c:.6f} ({name})")
    log(f"  (b) worst leaf cos {worst[1]:.6f} ({worst[0]}); tolerance "
        f"{WITNESS_COS}")
    if abs(loss - loss32) > WITNESS_LOSS_RTOL * abs(loss32) or \
            abs(n16 - n32) > WITNESS_NORM_RTOL * n32 or misses:
        raise AssertionError(f"float32 witness missed: {misses}")


def _compress_check(torch, grads):
    """(e): ``compress_tree`` of the first step's gradients on the card;
    the error feedback within half a scale step on every leaf."""
    from repro_torch.optim import compression
    from repro_torch.tree import leaves
    (qs, scales, errs), wall = _sync_wall(
        torch, compression.compress_tree, grads, None)
    worst = 0.0
    for q, s, e in zip(leaves(qs), leaves(scales), leaves(errs)):
        ratio = float(e.abs().max() / s)
        worst = max(worst, ratio)
        if ratio > HALF_STEP or int(q.abs().max()) > 127:
            raise AssertionError(f"compression: error {ratio:.6f} scale "
                                 "steps")
    qb = sum(q.numel() for q in leaves(qs))
    gb = sum(g.numel() * g.element_size() for g in leaves(grads))
    log(f"  (e) compress_tree: {len(leaves(qs))} leaves, int8 payload "
        f"{qb / 1e9:.3f} GB of {gb / 1e9:.3f} GB bf16 gradients, largest "
        f"error {worst:.6f} of a scale step (<= {HALF_STEP:.6f}), "
        f"{wall * 1e3:.1f} ms")


def _ckpt_check(torch, cfg):
    """(d): on a CKPT_LAYERS cut at CKPT_S, 4 steps uninterrupted against 2
    steps, an async save in CKPT_SHARDS shards, verify, load, 2 more steps;
    under deterministic algorithms, so both must end bit-equal."""
    import shutil
    import tempfile
    from repro_torch import checkpoint as ckpt
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves
    c2 = cfg.replace(n_layers=CKPT_LAYERS)
    dcfg = DataConfig(vocab=c2.vocab, seq_len=CKPT_S, batch_size=TRAIN_B,
                      seed=0)
    step = steps.make_train_step(c2, adamw.OptConfig(**TRAIN_OPT))

    def run(p, o, s0, n):
        for s in range(s0, s0 + n):
            x, y = (torch.from_numpy(a).to("cuda")
                    for a in batch_at(dcfg, 0, s))
            p, o, _ = step(p, o, x, y)
        return p, o

    with _Deterministic(torch):
        p0 = lm.init_params(c2, torch.Generator(device="cuda").manual_seed(0))
        pa = run(p0, adamw.init(p0), 0, 4)[0]
        pb, ob = run(p0, adamw.init(p0), 0, 2)
        del p0
        state = {"p": pb, "o": ob}
        nbytes = sum(t.numel() * t.element_size() for t in leaves(state))
        with tempfile.TemporaryDirectory() as d:
            log(f"  (d) checkpoint of {nbytes / 1e9:.3f} GB into a temporary "
                f"directory ({shutil.disk_usage(d).free / 1e9:.1f} GB free)")
            t = time.perf_counter()
            th = ckpt.save(d, 2, state, shards=CKPT_SHARDS, async_write=True)
            snap = time.perf_counter() - t
            th.join()
            wrote = time.perf_counter() - t
            on_disk = sum(f.stat().st_size
                          for f in Path(d, "step_00000002").iterdir())
            t = time.perf_counter()
            latest = ckpt.latest_step(d)           # verifies the checksums
            ver = time.perf_counter() - t
            if latest != 2:
                raise AssertionError("checkpoint: step 2 did not verify")
            (restored, _), load_wall = _sync_wall(
                torch, ckpt.load, d, state, latest)
        if not all(torch.equal(a, b) for a, b in zip(leaves(state),
                                                     leaves(restored))):
            raise AssertionError("checkpoint: restored state differs")
        del state, pb, ob
        pc = run(restored["p"], restored["o"], 2, 2)[0]
        del restored
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(leaves(pa), leaves(pc)))
    log(f"  (d) {on_disk / 1e9:.3f} GB on disk in {CKPT_SHARDS} shards: "
        f"host snapshot {snap:.2f} s, written (async, md5 included) "
        f"{wrote:.2f} s, verify (md5) {ver:.2f} s, load to the card "
        f"{load_wall:.2f} s; restored state bit-equal; resumed params vs "
        f"uninterrupted: max |diff| {diff:.3e} (deterministic algorithms: "
        "must be 0)")
    if diff != 0.0:
        raise AssertionError("checkpoint: the resumed run parted")


def train_phase(torch, cfg):
    """Phase 17: training at full width (``launch/steps.make_train_step``,
    remat, AdamW, int8 gradient compression, the data pipeline and the
    checkpoint) on ``cfg`` with bf16 weights from a seeded generator, at
    B = TRAIN_B, S = TRAIN_S: (b) the float32 witness of the first step's
    gradients, (e) their compression, (a) TRAIN_STEPS steps on one
    repeated batch, (c) remat "dots" against "full", (d) the checkpoint
    resume. Raises on any failure. Returns what phase 18 holds the dry run
    against: the bytes (a) kept on the card for the parameters, the AdamW
    state and the batch, its median step wall and its
    ``max_memory_allocated``."""
    from repro_torch.launch import knobs, steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n = sum(p.numel() for p in leaves(params))
    state = 2 * n * 2 + 2 * n * 4
    tokens = TRAIN_B * TRAIN_S
    flops = 4 * 2 * n * tokens    # forward, its recompute, backward (2x)
    log(f"  {cfg.name} x{cfg.n_layers}: {n / 1e9:.3f} B params; reckoning: "
        f"weights {2 * n / 1e9:.2f} GB + gradients {2 * n / 1e9:.2f} GB + "
        f"m, v {8 * n / 1e9:.2f} GB = {state / 1e9:.2f} GB of state; "
        f"~{flops:.2e} bf16 matmul FLOPs a step; memory held before: "
        f"{base / 1e9:.3f} GB")
    x, y = _train_batch(torch, cfg, TRAIN_B, TRAIN_S)
    lg = steps.make_loss_and_grad(cfg)

    torch.cuda.reset_peak_memory_stats()
    (loss_b, grads), wall = _sync_wall(torch, lg, params, x, y)
    log(f"  loss and gradients (bf16, remat full): {wall:.2f} s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f}"
        " GB")
    _witness(torch, cfg, params, grads, loss_b, lg, x, y)
    gc.collect()
    _compress_check(torch, grads)
    with_grad = [g is not None for g in leaves(grads)]
    del grads
    gc.collect()
    torch.cuda.empty_cache()

    # (a) TRAIN_STEPS steps on one repeated batch
    step = steps.make_train_step(cfg, adamw.OptConfig(**TRAIN_OPT))
    opt = adamw.init(params)
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(TRAIN_STEPS):
        (new, opt, st), wall = _sync_wall(torch, step, params, opt, x, y)
        loss, gn, lr = float(st["loss"]), float(st["grad_norm"]), \
            float(st["lr"])
        if i == 0:
            same = [torch.equal(a, b) for a, b in zip(leaves(params),
                                                      leaves(new))]
            if any(s and w for s, w in zip(same, with_grad)):
                raise AssertionError("a leaf with a gradient did not change "
                                     "at step 1")
            if abs(loss - float(loss_b)) > 1e-6 * abs(loss):
                raise AssertionError("step 1's loss differs from (b)'s")
        params = new
        losses.append(loss)
        walls.append(wall)
        log(f"  (a) step {i + 1}: loss {loss:.6f} grad norm {gn:.6f} lr "
            f"{lr:.3e} wall {wall:.3f} s ({tokens / wall:.0f} tokens/s)")
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise AssertionError("non-finite loss or gradient norm")
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(walls[1:])
    held = {"params": sum(t.nbytes for t in leaves(params)),
            "adamw": sum(t.nbytes for t in leaves(opt)),
            "batch": x.nbytes + y.nbytes}
    log(f"  (a) {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; median step {steady:.3f} s, {tokens / steady:.0f}"
        f" tokens/s, {flops / steady / 1e12:.1f} TFLOP/s of matmul FLOPs; "
        f"every leaf changed at step 1; max_memory_allocated "
        f"{peak / 1e9:.3f} GB (state {state / 1e9:.2f} GB + activations)")
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall")
    del opt
    gc.collect()
    torch.cuda.empty_cache()

    # (c) remat "dots" against "full", one loss-and-gradient step each
    out = {}
    with _Deterministic(torch):
        try:
            for policy in ("full", "dots"):
                knobs.set_knobs(remat_policy=policy)
                torch.cuda.reset_peak_memory_stats()
                (loss, g), wall = _sync_wall(torch, lg, params, x, y)
                out[policy] = (float(loss), float(adamw.global_norm(g)),
                               wall, torch.cuda.max_memory_allocated())
                del g
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            knobs.reset()
    for policy, (loss, gn, wall, pk) in out.items():
        log(f"  (c) remat {policy}: loss {loss:.6f} grad norm {gn:.6f} "
            f"wall {wall:.3f} s max_memory_allocated {pk / 1e9:.3f} GB")
    (lf, nf, _, _), (ld, nd, _, _) = out["full"], out["dots"]
    if abs(lf - ld) > REMAT_RTOL * abs(lf) or abs(nf - nd) > REMAT_RTOL * nf:
        raise AssertionError("remat dots and full differ")
    del params, x, y
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the checkpoint on a 2-layer cut
    _ckpt_check(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    return {"held": held, "step_s": steady, "peak": peak}


def dryrun_phase(torch, cfg, train, card):
    """Phase 18: the port's dry run (``launch/dryrun.py``) on a (1, 1) mesh
    of a fake one-rank process group for phase 17's own cell (``cfg`` at
    B = TRAIN_B, S = TRAIN_S, train). Its predicted
    ``argument_size_in_bytes`` must equal the bytes phase 17 kept on the
    card for the parameters, the AdamW state and the batch; on one device
    it books no collective and its per-device matmul FLOPs are the
    unsharded ones. Logs the predicted FLOPs over phase 17's median step
    wall (achieved TFLOP/s) and phase 17's ``max_memory_allocated``, with
    no bound on either."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    shape = ShapeSpec("train_phase", TRAIN_S, TRAIN_B, "train")
    t0 = time.perf_counter()
    with M.fake_world(1):
        mesh = M.make_mesh((1, 1), ("data", "model"))
        rec = dryrun.analyze_cell(dryrun.build_cell(cfg, shape, mesh))
    took = time.perf_counter() - t0
    held = train["held"]
    pred = rec["argument_size_in_bytes"]
    log(f"  analysis {took:.1f} s on meta tensors; predicted "
        f"argument_size_in_bytes {pred:,} vs {sum(held.values()):,} held by "
        f"phase 17 (params {held['params']:,} + AdamW state "
        f"{held['adamw']:,} + batch {held['batch']:,}); phase 17's "
        f"max_memory_allocated {train['peak']:,}")
    if pred != sum(held.values()):
        raise AssertionError("the dry run's argument bytes are not the "
                             "bytes the train step keeps on the card")
    colls = {k: v for k, v in rec["collectives"].items() if v}
    if colls or rec["hlo_dot_flops"] != rec["global_dot_flops"]:
        raise AssertionError(f"one device: collectives {colls}, FLOPs "
                             f"{rec['hlo_dot_flops']} vs global "
                             f"{rec['global_dot_flops']}")
    flops = rec["hlo_dot_flops"]
    log(f"  predicted hlo_dot_flops {flops:.6e} a step (forward, backward, "
        f"remat recompute); phase 17's median step {train['step_s']:.4f} s: "
        f"{flops / train['step_s'] / 1e12:.1f} TFLOP/s achieved on {card}; "
        f"hlo_dot_bytes {rec['hlo_dot_bytes']:.6e}; unmodelled ops "
        f"{rec['unmodelled_ops']}")


# ---------------------------------------------------------------------------
# phases 19 and 20: the serve_trace and morph_profile twins
# ---------------------------------------------------------------------------
# ``examples/serve_trace.py``'s azure lines, as the JAX package's sim
# engines printed them (tests/test_torch_serve_trace.py holds both traces)
SERVE_TRACE_LINES = ROOT / "tests" / "data" / "serve_trace_jax" / "azure.txt"
# the real-compute runs serve the example's azure trace over the first
# this many of its 72 seconds, by policy (its width, depth, budget, ladder
# and pool unchanged): the shortest cuts at which each morph run both
# swaps and resizes with a margin (sim compute, the same engines: the
# accuracy mode resizes at 36 s and at no shorter whole second; the
# performance mode swaps 18 times and resizes 11 at 26 s), and 2 s (7
# requests, 15 chunked prefills) for the static policies, which neither
# swap nor resize. The whole trace takes 1,488 / 3,632 / 1,472 / 1,479
# sim steps, at 63-113 ms a step on one H100 80GB HBM3 at 700.00 W, where
# the whole script's walls varied 796-1237 s between calls with these
# runs at 36 s and 12 s: it would not fit the script's time limit
SERVE_DURATIONS = {"static_fp16": 2.0, "static_int4": 2.0,
                   "morph-accuracy": 36.0, "morph-performance": 26.0}
# K1 at serve_trace's decode rows: held at the 48 slots, timed at 64, the
# top of their M bucket (the engine phases price a launch there)
SERVE_WNA16_CASES = [(4096, 4096, 4, (48, 64), (64,)),
                     (4096, 11008, 4, (48,), ()),
                     (11008, 4096, 4, (48, 64), (64,))]


def _example(name):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _captured(fn, *a):
    """``fn(*a)`` with its standard output captured; (result, output)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a)
    return out, buf.getvalue()


def serve_trace_sim_phase(torch):
    """Phase 19 (i): ``examples/serve_trace_torch.py`` as written, on this
    card (its four sim engines' bf16 pools here, one at a time): its lines
    must equal the JAX script's."""
    st = _example("serve_trace_torch")
    t0 = time.perf_counter()
    _, out = _captured(st.main, ["--device", "cuda"])
    torch.cuda.synchronize()
    for line in out.splitlines():
        log(f"  {line}")
    log(f"  {time.perf_counter() - t0:.1f} s wall; "
        f"torch.cuda.max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if out != SERVE_TRACE_LINES.read_text():
        raise AssertionError("serve_trace_torch's lines differ from the JAX "
                             "script's")


def _ledger_note(eng):
    """The bytes the engine's ledger books: weights at level 0 and at the
    deepest level, the reserve (5% of the budget + what never swaps), the
    block, and the blocks it starts with."""
    led, plan = eng.ledger, eng.plan
    return (f"weights {plan.weight_bytes(0) / 1e9:.3f} GB (level "
            f"{plan.n_layers}: {plan.weight_bytes(plan.n_layers) / 1e9:.3f}),"
            f" reserve {led.activation_reserve / 1e9:.3f} GB, block "
            f"{led.kv_block_bytes / 1e6:.3f} MB, start "
            f"{eng.pool.num_blocks - 1} blocks")


def serve_trace_phase(torch, counters, k1_shapes, k2):
    """Phase 19 (ii): ``run_policies`` of ``examples/serve_trace_torch.py``
    with real compute: Llama-2-7B at full width and depth (32 layers), bf16
    weights from a seeded generator, swapping front to back, the example's
    budget (an L4's 24 GiB), ladder (0, 2, 4, 8, 16), 48 slots, bf16 pool
    and azure trace (cut, by policy, to ``SERVE_DURATIONS``), the L4
    virtual clock; every
    swapped layer's matmul through K1 (``use_quant_kernel``). Each policy's
    counts are set to 0 just before its run and read just after; its row is
    logged beside the sim engine's on the same trace, with the ledger's
    bytes of both. Every request must be served, ``static_int4`` hold level
    32 and launch K1, ``static_fp16`` launch none, the morph runs swap and
    resize, and K2 and K3 launch in every run. Then decode and chunk step
    parity over a bf16 pool at levels 0, 16 and 32. Returns the launches
    summed over the four runs."""
    import dataclasses
    from repro_torch.configs.archs import MORPH_LLAMA2_7B
    from repro_torch.core import build_swap_plan
    from repro_torch.engine import NVIDIA_L4
    from repro_torch.engine.model_exec import ModelExec
    from repro_torch.kernels.paged_attention import NB_BUCKETS, paged_decode
    from repro_torch.kernels.wna16_gemm import wna16_gemm
    st = _example("serve_trace_torch")
    cfg, params, order = build_model(torch, MORPH_LLAMA2_7B, profile=False)
    serving = dataclasses.replace(st.SERVING, use_quant_kernel=True)
    runs = [(SERVE_DURATIONS[st.policy_name(*p)], p) for p in st.POLICIES]
    traces = {}
    for duration, _ in runs:
        if duration in traces:
            continue
        traces[duration] = trace = st.make_trace("azure",
                                                 duration_s=duration)
        log(f"  trace for "
            f"{[st.policy_name(*p) for d, p in runs if d == duration]}: "
            f"{len(trace)} requests over {duration:g} s of the example's "
            f"72 s; prompts {sum(r.prompt_len for r in trace)} tokens, "
            f"generations up to {sum(r.max_new_tokens for r in trace)}")

    sim, notes = {}, {}

    @contextlib.contextmanager
    def sim_watch(name, eng):
        yield
        notes[name] = _ledger_note(eng)

    t0 = time.perf_counter()
    for duration, policy in runs:
        for name, rep, blocks, swaps, resizes in st.run_policies(
                cfg, None, traces[duration], serving, compute="sim",
                hw=NVIDIA_L4, device="meta", watch=sim_watch,
                policies=[policy]):
            sim[name] = (rep, blocks, swaps, resizes)
    log(f"  sim engines on the same traces (meta pools): "
        f"{time.perf_counter() - t0:.1f} s")

    stats = {}

    @contextlib.contextmanager
    def watch(name, eng):
        calls, bad = collections.Counter(), []

        def checked(fn, what):
            def run(*a, **kw):
                calls[what] += 1
                out = fn(*a, **kw)
                if not bool(torch.isfinite(out).all()):
                    bad.append(what)
                return out
            return run

        for what in ("decode", "prefill", "prefill_batch", "prefill_chunk"):
            setattr(eng.exec, what, checked(getattr(eng.exec, what), what))
        log(f"  {name}: engine built, {_ledger_note(eng)}; pool "
            f"{eng.pool.k.dtype}, capacity {eng.pool.capacity} blocks "
            f"({2 * eng.pool.k.numel() * eng.pool.k.element_size() / 1e9:.3f}"
            f" GB); torch.cuda.memory_allocated "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        wna16_gemm.launches_by_shape.clear()
        paged_decode.launches_by_nb.clear()
        paged_decode.quant_launches_by_nb.clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        yield
        torch.cuda.synchronize()
        hist = eng.monitor.history
        stats[name] = dict(
            wall=time.perf_counter() - t,
            launches={k: getattr(fn, attr)
                      for k, (fn, attr) in counters.items()},
            k1_by=dict(wna16_gemm.launches_by_shape),
            k2_by=dict(paged_decode.launches_by_nb),
            peak=torch.cuda.max_memory_allocated(),
            budget=eng.sc.hbm_budget_bytes, steps=len(hist),
            levels=sorted({h.swap_level for h in hist}), calls=dict(calls),
            chunks=sum(r.prefill_chunks for r in eng.all_requests),
            tokens=sum(len(r.generated) for r in eng.all_requests),
            bad=sorted(set(bad)), pool=eng.pool.k.dtype,
            deepest=eng.plan.n_layers, now=eng.now)

    fails, total = [], collections.Counter()
    widths = [str(w) for w in NB_BUCKETS] + [f">{NB_BUCKETS[-1]}"]
    served = ((d, out) for d, policy in runs for out in st.run_policies(
        cfg, params, traces[d], serving, compute="real", hw=NVIDIA_L4,
        device="cuda", swap_order=order, watch=watch, policies=[policy]))
    for duration, (name, rep, blocks, swaps, resizes) in served:
        s = stats[name]
        srep, sblocks, sswaps, sresizes = sim[name]
        total.update(s["launches"])
        log(f"  {name} real: served {rep.n_finished}/{rep.n_requests}; "
            f"{rep.row()}  kv_blocks {blocks[0]}->{max(blocks)}")
        log(f"  {name} sim:  served {srep.n_finished}/{srep.n_requests}; "
            f"{srep.row()}  kv_blocks {sblocks[0]}->{max(sblocks)}; sim "
            f"ledger {notes[name]}")
        log(f"  {name}: steps {s['steps']} (sim {len(sblocks)}), "
            f"real-compute calls {s['calls']}; swaps {len(swaps)} (sim "
            f"{len(sswaps)}), resizes {len(resizes)} (sim {len(sresizes)}),"
            f" chunk prefills {s['chunks']}; levels held {s['levels']}; "
            f"{s['tokens']} tokens generated in {s['wall']:.2f} s wall (host"
            f" clock, synchronized) against {s['now']:.2f} s on the "
            f"virtual clock; torch.cuda.max_memory_allocated "
            f"{s['peak'] / 1e9:.3f} GB against the ledger's budget "
            f"{s['budget'] / 1e9:.3f} GB; launches {s['launches']}")
        k1_est, untimed = _k1_estimate(s["k1_by"], k1_shapes)
        log(f"  {name}: K1 launches by (K, N, M bucket) "
            f"{ {f'{k[0]}x{k[1]} {k[2]}': n for k, n in sorted(s['k1_by'].items())} }"
            f"; estimated K1 device time {k1_est:.1f} ms"
            + (f"; shapes the kernel phase did not time {untimed}"
               if untimed else ""))
        if s["k2_by"]:
            est, lost = k2_estimate(s["k2_by"], "paged_decode", k2)
            log(f"  {name}: K2 launches by table width "
                f"{ {b: s['k2_by'][b] for b in widths if b in s['k2_by']} }"
                f"; estimated device time {est:.1f} ms, {lost:.1f} ms of it "
                f"above the bound (each bucket's launches x the 48-slot "
                f"bf16-pool case at that width or the next wider one)")
        n = len(traces[duration])
        if rep.n_finished != rep.n_requests or rep.n_requests != n:
            fails.append(f"{name}: served {rep.n_finished}/{n}")
        if s["pool"] != torch.bfloat16:
            fails.append(f"{name}: the pool is {s['pool']}, not bf16")
        if s["bad"]:
            fails.append(f"{name}: non-finite logits in {s['bad']}")
        if sum(s["k1_by"].values()) != s["launches"]["wna16_gemm"]:
            fails.append(f"{name}: K1 launches by shape do not add up")
        for k in ("paged_decode", "paged_chunk"):
            if s["launches"][k] <= 0:
                fails.append(f"{name}: {k} never launched")
        if name == "static_int4" and (s["levels"] != [s["deepest"]] or
                                      s["launches"]["wna16_gemm"] <= 0):
            fails.append(f"static_int4: levels {s['levels']}, K1 launches "
                         f"{s['launches']['wna16_gemm']}")
        if name == "static_fp16" and (s["levels"] != [0] or
                                      s["launches"]["wna16_gemm"]):
            fails.append(f"static_fp16: levels {s['levels']}, K1 launches "
                         f"{s['launches']['wna16_gemm']}")
        if name.startswith("morph") and not (swaps and resizes and
                                             s["launches"]["wna16_gemm"]):
            fails.append(f"{name}: swaps {len(swaps)}, resizes "
                         f"{len(resizes)}, K1 launches "
                         f"{s['launches']['wna16_gemm']}")
    if fails:
        raise AssertionError("serve_trace phase: " + "; ".join(fails))

    plan = build_swap_plan(cfg, params, order, serving=serving, bits=4,
                           use_kernel=True)
    eng = types.SimpleNamespace(plan=plan, exec=ModelExec(
        cfg, params, [k for k, _ in plan.fp_layers]))
    log(f"  step parity over a bf16 pool at levels 0, 16 and "
        f"{cfg.n_layers} (kernels vs plain, tolerance {LOGIT_TOL} x "
        f"max|logit|)")
    parity_phase(torch, cfg, eng, quantized=False, fp_level=True,
                 pool_dtype=torch.bfloat16, mid_levels=(16,))
    return dict(total)


# the morph_profile phase's tolerances on the kernel route against the
# plain route: float32 activations (the 4-layer model; K1 takes its exact
# split passes, so the two differ by float32 summation order), relative on
# perplexity; bf16 activations (the full-width model), relative on
# perplexity and absolute on the profile's cosines. The table's is set
# from its readings on one H100 80GB HBM3 at 700.00 W: kernel against
# plain 5.5e-4, the plain route's float32 witness against its bf16 run
# 5.2e-4 (bf16's own noise), one int4 layer whose K1 outputs are zero
# 6.2e-3; the phase logs all three and fails unless the first two lie
# under it and the third above
PPL_RTOL_F32 = 1e-4
PPL_RTOL_BF16 = 2e-3
COS_ATOL_BF16 = 1e-3
PROFILE_LAYERS = 8


@contextlib.contextmanager
def _plain_k1():
    """Every K1 call takes its plain version (``ops.wna16_matmul`` called
    with ``plain=True``), for a route with no ``plain`` argument."""
    from repro_torch.kernels import ops
    fn = ops.wna16_matmul
    ops.wna16_matmul = lambda *a, **kw: fn(*a, **{**kw, "plain": True})
    try:
        yield
    finally:
        ops.wna16_matmul = fn


def _table_close(what, got, want, rtol):
    """Hold each table entry within ``rtol`` of the plain route's; returns
    the largest relative gap."""
    gap = max(abs(g - w) / abs(w) for name in want
              for g, w in zip(got[name], want[name]))
    if list(got) != list(want) or not gap <= rtol:
        raise AssertionError(f"{what}: kernel table {got} vs plain {want}, "
                             f"largest relative gap {gap:.3e} > {rtol}")
    return gap


def morph_profile_phase(torch, k1_shapes):
    """Phase 20: (i) ``examples/morph_profile_torch.py`` as written, on this
    card: 150 AdamW steps of its 4-layer model (plain torch), the LIS
    profile and the Table-1 perplexities through K1 (float32 x); the
    order must equal the profile's on CPU copies of the trained params (the
    plain versions), and every table entry lie within ``PPL_RTOL_F32`` of
    the plain route's (``forward_unrolled(..., plain=True)``). (ii) The
    same profile and table on Llama-2-7B at full width cut to
    ``PROFILE_LAYERS`` layers, bf16 weights from a seeded generator, the
    Markov data at its vocab of 32000: LTS and LRS within
    ``COS_ATOL_BF16`` of the plain route's, the table within
    ``PPL_RTOL_BF16``, which must lie above the plain route's distance from
    its float32 witness and below what a layer whose K1 outputs are zero
    reads. Returns the twin's K1 launches."""
    from repro_torch.configs.archs import MORPH_LLAMA2_7B
    from repro_torch.data import DataConfig
    from repro_torch.quant.qlinear import QTensor
    from repro_torch.tree import tree_map
    mp = _example("morph_profile_torch")
    _k1_reset()
    t0 = time.perf_counter()
    (cfg, params, dcfg, prof, table), out = _captured(
        mp.main, ["--device", "cuda"])
    torch.cuda.synchronize()
    for line in out.splitlines():
        log(f"  {line}")
    log(f"  morph_profile_torch on cuda: {time.perf_counter() - t0:.2f} s "
        f"wall (150 train steps, LIS profile, 16 table entries)")
    n = _k1_log("morph_profile_torch (its int4 layers, float32 x)",
                k1_shapes)
    if n <= 0:
        raise AssertionError("morph_profile_torch never launched K1")
    cpu = tree_map(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    cprof = mp.profile_swap_sequence(cfg, cpu, mp.calibration(dcfg, "cpu"),
                                     bits=4, quant_bank=mp.int4_bank(cfg,
                                                                     cpu))
    log(f"  the profile on CPU copies of the trained params (plain "
        f"versions): order {cprof.order}, LIS {[round(x, 6) for x in cprof.lis]}"
        f" ({time.perf_counter() - t0:.2f} s); on the card LIS "
        f"{[round(x, 6) for x in prof.lis]}")
    if cprof.order != prof.order:
        raise AssertionError(f"LIS order on the card {prof.order} vs the "
                             f"plain versions' {cprof.order}")
    _k1_reset()
    plain = mp.ppl_table(cfg, params, dcfg, mp.int4_bank(cfg, params),
                         prof.order, plain=True)
    _k1_none("morph_profile plain table")
    gap = _table_close("morph_profile table", table, plain, PPL_RTOL_F32)
    log(f"  table kernel vs plain: largest relative gap {gap:.3e} (tol "
        f"{PPL_RTOL_F32})")
    del params, cpu

    # (ii) full width
    cfg, params, _ = build_model(
        torch, MORPH_LLAMA2_7B.replace(n_layers=PROFILE_LAYERS),
        profile=False)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, batch_size=8, seed=0)
    calib = mp.calibration(dcfg, "cuda")
    qbank = mp.int4_bank(cfg, params)
    walls, profs = {}, {}
    for route in ("kernel", "plain"):
        _k1_reset()
        t0 = time.perf_counter()
        with _plain_k1() if route == "plain" else contextlib.nullcontext():
            profs[route] = mp.profile_swap_sequence(cfg, params, calib,
                                                    bits=4, quant_bank=qbank)
        torch.cuda.synchronize()
        walls[route] = time.perf_counter() - t0
        if route == "kernel":
            _k1_log(f"LIS profile at full width ({PROFILE_LAYERS} layers)",
                    k1_shapes)
        else:
            _k1_none("LIS profile, plain route")
    kp, pp = profs["kernel"], profs["plain"]
    gap = max(abs(a - b) for key in ("lts", "lrs")
              for a, b in zip(getattr(kp, key), getattr(pp, key)))
    log(f"  LIS profile (calibration 2 x 48 tokens): kernel {walls['kernel']:.2f}"
        f" s, plain {walls['plain']:.2f} s wall; order {kp.order} (plain "
        f"route {pp.order}); LIS {[round(x, 5) for x in kp.lis]} (plain "
        f"{[round(x, 5) for x in pp.lis]}); LTS / LRS largest gap "
        f"{gap:.3e} (tol {COS_ATOL_BF16})")
    if not gap <= COS_ATOL_BF16:
        raise AssertionError("full-width LIS profile: kernel vs plain "
                             f"LTS / LRS gap {gap:.3e}")
    tables = {}
    for route in ("kernel", "plain"):
        _k1_reset()
        t0 = time.perf_counter()
        tables[route] = mp.ppl_table(cfg, params, dcfg, qbank, kp.order,
                                     plain=route == "plain")
        torch.cuda.synchronize()
        walls[route] = time.perf_counter() - t0
        if route == "kernel":
            _k1_log("table at full width", k1_shapes)
        else:
            _k1_none("table at full width, plain route")
    gap = _table_close("full-width table", tables["kernel"],
                       tables["plain"], PPL_RTOL_BF16)
    for name, vals in tables["kernel"].items():
        log(f"  {name:15s}" + "".join(f" {v:<11.4f}" for v in vals)
            + "  plain" + "".join(f" {v:.4f}" for v in tables["plain"][name]))
    log(f"  table (4 x 4, the LIS row in the kernel route's order): kernel "
        f"{walls['kernel']:.2f} s, plain {walls['plain']:.2f} s wall; "
        f"largest relative gap {gap:.3e} (tol {PPL_RTOL_BF16}; random "
        f"weights: the values mean nothing)")

    # the tolerance's two controls: bf16's own noise (the plain route's
    # float32 witness), which must lie under it, and a fault it must see
    # (the first swapped layer's K1 outputs zeroed: its scales set to 0)
    def zero_out(tree):
        if isinstance(tree, dict):
            return {k: zero_out(v) for k, v in tree.items()}
        if isinstance(tree, QTensor):
            return QTensor(tree.packed, torch.zeros_like(tree.scales),
                           tree.zeros, bits=tree.bits, group=tree.group,
                           K=tree.K, N=tree.N, out_dtype=tree.out_dtype,
                           inv_act=tree.inv_act, use_kernel=tree.use_kernel)
        return tree

    witness = mp.ppl_table(cfg.replace(dtype="float32"),
                           _as_f32(torch, params), dcfg,
                           [_as_f32(torch, q) for q in qbank], kp.order,
                           plain=True)
    noise = max(abs(w - p) / p for name in witness
                for w, p in zip(witness[name], tables["plain"][name]))
    bad = kp.order[0]
    broken = mp.ppl_table(cfg, params, dcfg,
                          [zero_out(q) if i == bad else q
                           for i, q in enumerate(qbank)], kp.order)
    seen = max(abs(b - p) / p for name in broken
               for b, p in zip(broken[name], tables["plain"][name]))
    log(f"  the tolerance's controls: the plain route's float32 witness "
        f"against its bf16 run {noise:.3e} (must lie under {PPL_RTOL_BF16})"
        f"; layer {bad}'s K1 outputs zeroed, kernel route against plain "
        f"{seen:.3e} (must lie above)")
    if not (noise < PPL_RTOL_BF16 < seen):
        raise AssertionError(f"full-width table: bf16 noise {noise:.3e}, a "
                             f"zeroed layer {seen:.3e}, tolerance "
                             f"{PPL_RTOL_BF16}")
    return n


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run me from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.archs import (DEEPSEEK_V3_671B, HYMBA_1P5B,
                                           MAMBA2_780M, MORPH_LLAMA2_7B)
    from repro_torch.core import build_swap_plan
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import (paged_chunk,
                                                     paged_chunk_mla,
                                                     paged_decode)
    from repro_torch.kernels.wna16_gemm import wna16_gemm

    # 1. device + build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    took = build.build_all()
    log(f"kernel build {time.perf_counter() - t0:.1f} s (parallel nvcc: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()) + ")")

    # 2. kernels vs plain versions at the main path's shapes
    timer = Timer(torch)
    results = []
    built = plan_check(torch)
    log("kernel phase (bf16 activations, float32 pool; tolerance "
        f"|k-p| <= rtol*|p| + atol*max|p|, {TOL})")
    t0 = time.perf_counter()
    wna16_cases(torch, timer, results)
    log("K1 at odd M, with inv_act and a bias, float32 and float16 x, "
        "groups 64 and 32 (held, not timed)")
    wna16_more_cases(torch, results)
    log("K1 at the SSM and hybrid layers' matmul shapes (Mamba-2 780M, Hymba "
        "1.5B: N = 6448 and 6482, groups 128 / 64)")
    wna16_cases(torch, timer, results, SSM_WNA16_CASES)
    log("K1 at Whisper-small's decoder and InternVL2-1B's matmul shapes "
        f"(int4, group 128; (768, 768) held at M = {CROSS_KV_M}, the "
        "cross-attention k / v of start_cache at 4 x 1500 frames)")
    wna16_cases(torch, timer, results, ENCDEC_VLM_WNA16_CASES)
    log("K1 at serve_trace's decode rows (48 slots: held at M = 48, timed at "
        "64, the top of their M bucket)")
    wna16_cases(torch, timer, results, SERVE_WNA16_CASES)
    log("K1's bounds at the mma passes of its launch plan (bf16 "
        f"{BF16_FLOP_S / 1e12:.0f} TFLOP/s, HBM {HBM_BYTES_S / 1e12:.2f} TB/s)")
    k1_shapes = wna16_bounds(results)
    decode_cases(torch, timer, results)
    log("K2 at the engine's decode shapes (8 slots, idle ones at length 0, "
        "table widths 8-64)")
    engine_decode_cases(torch, timer, results)
    log("K2 at Hymba's heads (25 / 5 of 64, G = 5), its window of 1024 and "
        "full attention, and at the engine's decode shapes")
    decode_cases(torch, timer, results, HYMBA_DECODE_CASES, Dh=64)
    engine_decode_cases(torch, timer, results, heads=HYMBA_HEADS,
                        prefix="decode hymba engine")
    log("K2 at serve_trace's decode shapes (48 slots, every eighth idle, "
        "bf16 pool, table widths 32-128)")
    engine_decode_cases(torch, timer, results, SERVE_DECODE_CASES,
                        prefix="decode serve engine",
                        kv_dtype=torch.bfloat16)
    chunk_cases(torch, timer, results)
    log("kv_quant lane (pools quantized through PagedKVPool.quantize_blocks,"
        " every block but each sequence's tail; a zeroed sidecar must equal "
        "the no-quant kernel exactly)")
    for bits in (8, 4):
        decode_cases(torch, timer, results, DECODE_Q_CASES, bits=bits)
        engine_decode_cases(torch, timer, results, ENGINE_DECODE_Q_CASES,
                            bits=bits)
        chunk_cases(torch, timer, results, CHUNK_Q_CASES, bits=bits)
    log("K3-mla, the chunk walk's latent mode (float32 q and latent pool; "
        f"tolerance {TOL['float32']})")
    mla_chunk_cases(torch, timer, results)
    log("chunk walks' bounds at their tensor-core passes (TF32 "
        f"{TF32_FLOP_S / 1e12:.0f} TFLOP/s, HBM {HBM_BYTES_S / 1e12:.2f} TB/s)")
    tensor_core_bounds(results, built)
    k2 = k2_table(results)
    k2_hymba = k2_table(results, "decode hymba engine")
    k2_serve = k2_table(results, "decode serve engine")
    log(f"kernel phase {time.perf_counter() - t0:.1f} s")

    # 3-4. the main path with the quantize-cold tier off, then on, then off
    # at the tier-on budget; each run counts only its own launches
    counters = {"wna16_gemm": (wna16_gemm, "launches"),
                "paged_decode": (paged_decode, "launches"),
                "paged_chunk": (paged_chunk, "launches"),
                "paged_decode_q": (paged_decode, "quant_launches"),
                "paged_chunk_q": (paged_chunk, "quant_launches"),
                "paged_chunk_mla": (paged_chunk_mla, "launches")}
    t0 = time.perf_counter()
    # Llama-2-7B at full width, depth cut 32 -> 8
    model = build_model(torch, MORPH_LLAMA2_7B.replace(n_layers=8))
    log("engine phase, kv-quant tier off (quickstart budget: weights + 8 "
        "KV blocks)")
    launches = engine_phase(torch, model, counters, kv_blocks=8,
                            kv_quant=False, k1_shapes=k1_shapes, k2=k2)[1]
    log("engine phase, kv-quant tier on (weights + 16 KV blocks: the "
        "budget at which the quickstart trace engages the tier)")
    eng, q_launches = engine_phase(torch, model, counters, kv_blocks=16,
                                   kv_quant=True, k1_shapes=k1_shapes, k2=k2)
    launches.update({k: q_launches[k]
                     for k in ("paged_decode_q", "paged_chunk_q")})
    log("engine phase, kv-quant tier off at the tier-on budget (weights + "
        "16 KV blocks: the control that separates the tier's effect)")
    engine_phase(torch, model, counters, kv_blocks=16, kv_quant=False,
                 k1_shapes=k1_shapes, k2=k2)
    log(f"engine phases {time.perf_counter() - t0:.1f} s")

    # 5. step parity
    log(f"step parity (kernels vs plain, tolerance {LOGIT_TOL} x "
        "max|logit|)")
    t0 = time.perf_counter()
    parity_phase(torch, model[0], eng)
    log(f"step parity {time.perf_counter() - t0:.1f} s")
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()

    # 6-7. DeepSeek-V3 at full width, depth cut 61 -> 4: its three dense
    # MLA layers and its first MoE layer. The ladder's first rung is the
    # LIS position of the MoE layer, so the first swap quantizes its experts
    # (any one swap relieves this trace's KV demand)
    t0 = time.perf_counter()
    mla = build_model(torch, DEEPSEEK_V3_671B.replace(n_layers=4))
    rung = mla[2].index(3) + 1
    ladder = tuple(sorted({0, rung, 4}))
    log(f"DeepSeek-V3 engine phase (weights + {MLA_KV_BLOCKS} float32 "
        f"latent blocks; swap levels {ladder}; chunks through K3-mla)")
    mla_eng, mla_launches = engine_phase(
        torch, mla, counters, kv_blocks=MLA_KV_BLOCKS, kv_quant=False,
        k1_shapes=k1_shapes, k2=k2, need=("wna16_gemm", "paged_chunk_mla"),
        ladder=ladder)
    launches["paged_chunk_mla"] = mla_launches["paged_chunk_mla"]
    log(f"DeepSeek-V3 engine phase {time.perf_counter() - t0:.1f} s")
    log(f"DeepSeek-V3 step parity (kernels vs plain, the MoE layer's "
        f"experts int4 through K1; tolerance {LOGIT_TOL} x max|logit|)")
    t0 = time.perf_counter()
    parity_phase(torch, mla[0], mla_eng, quantized=False)
    log(f"DeepSeek-V3 step parity {time.perf_counter() - t0:.1f} s")
    del mla, mla_eng
    gc.collect()
    torch.cuda.empty_cache()

    # 8. Llama-4 Maverick at full width, depth cut 48 -> 2 (dense, moe):
    # step parity at the fp and the all-int4 level (K1, and K2 / K3 at G = 5)
    t0 = time.perf_counter()
    mav = maverick_phase(torch, counters)
    log(f"Maverick phase {time.perf_counter() - t0:.1f} s; launches {mav}")
    gc.collect()
    torch.cuda.empty_cache()

    # 9-10. Hymba 1.5B at full width and depth: the hybrid path (K1 on
    # every swapped matmul, K2 at G = 5 and Dh 64 on every decode), then
    # its step parity
    t0 = time.perf_counter()
    hym = build_model(torch, HYMBA_1P5B)
    log("Hymba engine phase (weights + 8 float32 KV blocks; whole-prompt "
        "prefill at the prompt's length)")
    hym_eng = engine_phase(torch, hym, counters, kv_blocks=8, kv_quant=False,
                           k1_shapes=k1_shapes, k2=k2_hymba,
                           need=("wna16_gemm", "paged_decode"))[0]
    log(f"Hymba engine phase {time.perf_counter() - t0:.1f} s")
    log(f"Hymba step parity (kernels vs plain, tolerance {LOGIT_TOL} x "
        f"max|logit|; state against the float32 witness, {STATE_TOL} x "
        f"max|state| past the plain route's own gap)")
    t0 = time.perf_counter()
    ssm_parity_phase(torch, hym[0], hym[1], hym_eng.plan)
    log(f"Hymba step parity {time.perf_counter() - t0:.1f} s")
    del hym, hym_eng
    gc.collect()
    torch.cuda.empty_cache()

    # 11-12. Mamba-2 780M at full width, depth cut 48 -> MAMBA_LAYERS: no KV
    # blocks, so only queue delay trips the controller, at MAMBA_RPS; then
    # step parity
    t0 = time.perf_counter()
    mam = build_model(torch, MAMBA2_780M.replace(n_layers=MAMBA_LAYERS))
    log(f"Mamba-2 engine phase (the trace at {MAMBA_RPS} requests a second; "
        f"budget the weights, its KV block being 0 bytes)")
    mam_eng = engine_phase(torch, mam, counters, kv_blocks=8, kv_quant=False,
                           k1_shapes=k1_shapes, k2=k2, need=("wna16_gemm",),
                           rps=MAMBA_RPS)[0]
    log(f"Mamba-2 engine phase {time.perf_counter() - t0:.1f} s")
    del mam, mam_eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"Mamba-2 step parity at full depth (kernels vs plain, tolerance "
        f"{LOGIT_TOL} x max|logit|; state against the float32 witness, "
        f"{STATE_TOL} x max|state| past the plain route's own gap)")
    t0 = time.perf_counter()
    mcfg, mparams, morder = build_model(torch, MAMBA2_780M, profile=False)
    ssm_parity_phase(torch, mcfg, mparams, build_swap_plan(
        mcfg, mparams, morder, levels=(0, mcfg.n_layers), use_kernel=True))
    log(f"Mamba-2 step parity {time.perf_counter() - t0:.1f} s")
    del mparams

    # 13-14. the model API's encoder-decoder and VLM paths at full width:
    # Whisper-small's encode + cached decode (K1 on its int4 decoder) and
    # InternVL2-1B's image prompt (LIS profile, forward, prefill + decode)
    t0 = time.perf_counter()
    log(f"Whisper-small phase (encode, start_cache, {WHISPER_STEPS} decode "
        f"steps of {WHISPER_B} sequences; kernels vs plain, tolerance "
        f"{LOGIT_TOL} x max|logit|)")
    whisper_phase(torch, k1_shapes)
    log(f"Whisper-small phase {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("InternVL2-1B phase (LIS profile with the frontend, forward, prefill "
        f"+ {VLM_DECODE_STEPS} decode steps at levels 0 and 24; kernels vs "
        f"plain, tolerance {LOGIT_TOL} x max|logit|)")
    internvl_phase(torch, k1_shapes)
    log(f"InternVL2-1B phase {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # 15-16. the serving cluster on this card: replicas of the Llama model
    # under a fault plan that drains, fences and kills, with KV migration
    # between them; then migration parity at full width
    t0 = time.perf_counter()
    model = build_model(torch, MORPH_LLAMA2_7B.replace(n_layers=8),
                        profile=False)
    log(f"cluster phase ({CLUSTER_REPLICAS} replicas, the engine phase's "
        f"trace at {CLUSTER_RPS:g} requests a second, every replica's steps "
        f"x {CLUSTER_SLOW:g} on the virtual clock)")
    cluster_phase(torch, model, counters)
    log(f"cluster phase {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"migration parity phase ({MIG_PROMPT}-token prompts, greedy, "
        f"{MIG_GEN} tokens, export after {MIG_STOP})")
    migration_parity_phase(torch, model, counters)
    log(f"migration parity phase {time.perf_counter() - t0:.1f} s")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 17. training at full width: the train step with remat and AdamW on
    # the Markov data, its float32 witness, int8 gradient compression, the
    # remat policies and a checkpoint resume (plain torch: no TPU kernel is
    # on the training path)
    t0 = time.perf_counter()
    log(f"train phase ({MORPH_LLAMA2_7B.name} x{TRAIN_LAYERS} layers at full "
        f"width, bf16, B={TRAIN_B} S={TRAIN_S}, {TRAIN_STEPS} AdamW steps "
        f"{TRAIN_OPT}; witness tolerances loss {WITNESS_LOSS_RTOL}, norm "
        f"{WITNESS_NORM_RTOL}, cos >= {WITNESS_COS}; remat {REMAT_RTOL}; "
        f"checkpoint {CKPT_LAYERS} layers at S={CKPT_S}, {CKPT_SHARDS} "
        "shards)")
    train = train_phase(torch, MORPH_LLAMA2_7B.replace(n_layers=TRAIN_LAYERS))
    log(f"train phase {time.perf_counter() - t0:.1f} s")

    # 18. the dry run against the card: phase 17's cell on a (1, 1) mesh
    t0 = time.perf_counter()
    log("dry-run phase (launch/dryrun.py on a 1 x 1 mesh, phase 17's cell)")
    dryrun_phase(torch, MORPH_LLAMA2_7B.replace(n_layers=TRAIN_LAYERS), train,
                 card)
    log(f"dry-run phase {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # 19. the serve_trace twin: its sim engines as written, then its four
    # policies with real compute at Llama-2-7B's full width and depth on a
    # bf16 pool, and step parity over that pool
    t0 = time.perf_counter()
    log("serve_trace phase (i): examples/serve_trace_torch.py on cuda (sim "
        "compute, L4 virtual clock; its lines against the JAX script's)")
    serve_trace_sim_phase(torch)
    log(f"serve_trace phase (ii): run_policies with real compute, "
        f"{MORPH_LLAMA2_7B.name} x{MORPH_LLAMA2_7B.n_layers} layers at full "
        f"width, bf16 weights and pool, the example's budget, ladder and "
        f"azure trace, cut by policy to {SERVE_DURATIONS} s")
    for k, n in serve_trace_phase(torch, counters, k1_shapes,
                                  k2_serve).items():
        launches[k] += n
    log(f"serve_trace phase {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # 20. the morph_profile twin as written, then its profile and table at
    # full width; the kernel route against the plain route
    t0 = time.perf_counter()
    log(f"morph_profile phase (tolerances: float32 table {PPL_RTOL_F32}; "
        f"full width, bf16: table {PPL_RTOL_BF16}, LTS / LRS "
        f"{COS_ATOL_BF16})")
    launches["wna16_gemm"] += morph_profile_phase(torch, k1_shapes)
    log(f"morph_profile phase {time.perf_counter() - t0:.1f} s")

    # the representative main-path case of each kernel, errors over all cases
    main_case = {"wna16_gemm": "wna16 M=8 K=4096 N=11008 int4",
                 "paged_decode": ("decode B=8 ctx=2048 H=32 KVH=32 w=0 "
                                  "cap=0.0 fused=True"),
                 "paged_chunk": ("chunk Cp=256 pos0=200 H=32 KVH=32 w=0 "
                                 "cap=0.0 fused=True"),
                 "paged_decode_q": ("decode B=8 ctx=2048 H=32 KVH=32 w=0 "
                                    "cap=0.0 fused=True int8"),
                 "paged_chunk_q": ("chunk Cp=256 pos0=200 H=32 KVH=32 w=0 "
                                   "cap=0.0 fused=True int8"),
                 "paged_chunk_mla": ("mla chunk Cp=256 pos0=200 H=128 W=576 "
                                     "dv=512 fused=True")}
    csrc = "src/repro_torch/kernels/csrc/"
    where = {"wna16_gemm": (csrc + "wna16_gemm.cu",
                            "src/repro/kernels/wna16_gemm.py:81"),
             "paged_decode": (csrc + "paged_attention.cu",
                              "src/repro/kernels/paged_attention.py:38"),
             "paged_chunk": (csrc + "paged_chunk.cu",
                             "src/repro/kernels/paged_attention.py:250"),
             "paged_decode_q": (csrc + "paged_attention.cu",
                                "src/repro/kernels/paged_attention.py:78"),
             "paged_chunk_q": (csrc + "paged_chunk.cu",
                               "src/repro/kernels/paged_attention.py:315"),
             "paged_chunk_mla": (csrc + "paged_attention_mla.cu",
                                 "src/repro/kernels/paged_attention.py:320")}
    line = []
    for name, case in main_case.items():
        rows = [r for r in results if r["kernel"] == name]
        r = next(x for x in rows if x["case"] == case)
        line.append({"name": name, "route": "cuda", "source": where[name][0],
                     "replaces": where[name][1], "launches": launches[name],
                     "max_abs_err": max(x["err"] for x in rows),
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "case": case,
                     "card": card})
    log(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
