#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
(``CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch built for CUDA. It
builds the port's kernels from ``src/repro_torch/kernels/csrc`` into
``src/repro_torch/kernels/build`` and runs four phases, each of which
raises on failure:

1. device: the card's name and power limit, torch/CUDA versions, and the
   kernels' build time;
2. kernels: every hand-written kernel (wNa16 GEMM, paged decode, chunk
   prefill) against its plain torch version at the main path's shapes,
   with the largest error against a stated tolerance and CUDA-event
   medians of the kernel, the plain version and one library call;
3. engine: the quickstart path — LIS profile, int4 swap plan, the
   token-budgeted ``MorphServeEngine`` serving a bursty trace with real
   compute — on Llama-2-7B at full width (d 4096, 32 heads, d_ff 11008,
   vocab 32000) cut to 8 layers, bf16 weights from a seeded generator;
4. step parity: one decode step and one chunk step of that model through
   the kernels against the same steps with the plain versions.

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
It exits non-zero, with no ``ok`` line, when there is no CUDA device, when
it does not sit in a checkout of the repository, or when any phase fails.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate, bf16
# tensor-core rate, float32 rate outside the tensor cores
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12

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

REPS = 15
SLEEP_CYCLES = 2_000_000      # ~1 ms at the H100's clock: covers the enqueue


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
def wna16_cases(torch, timer, results):
    from repro_torch.kernels import ref
    from repro_torch.kernels.wna16_gemm import wna16_gemm
    from repro_torch.quant import quantize_tensor
    gen = torch.Generator(device="cuda").manual_seed(11)
    for (K, N) in ((4096, 4096), (4096, 11008), (11008, 4096)):
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        for bits in (4, 8):
            qt = quantize_tensor(w.to(torch.bfloat16), bits=bits, group=128)
            wd = qt.dequantize(torch.bfloat16)
            for M in (1, 8, 256):
                x = torch.randn((M, K), generator=gen, device="cuda").to(
                    torch.bfloat16)
                args = (x, qt.packed, qt.scales, qt.zeros)
                kw = dict(bits=bits, group=qt.group)
                want = ref.wna16_ref(*args, **kw)
                got = wna16_gemm(*args, **kw)
                torch.cuda.synchronize()
                name = f"wna16 M={M} K={K} N={N} int{bits}"
                err = check_close(name, got, want)
                t_k = timer.ms(lambda: wna16_gemm(*args, **kw))
                t_p = timer.ms(lambda: ref.wna16_ref(*args, **kw))
                t_l = timer.ms(lambda: torch.matmul(x, wd))
                nbytes = (x.numel() * 2 + qt.packed.numel()
                          + 2 * qt.scales.numel() * 4 + M * N * 2)
                flops = 2 * M * K * N
                bound = max(nbytes / HBM_BYTES_S, flops / BF16_FLOP_S) * 1e3
                by = "bytes" if nbytes / HBM_BYTES_S >= flops / BF16_FLOP_S \
                    else "operations"
                results.append(dict(kernel="wna16_gemm", case=name, err=err,
                                    ms=t_k, plain_ms=t_p, library_ms=t_l,
                                    bound_ms=bound, bound_by=by))
                log(f"  {name}: err {err:.2e} kernel {t_k:.4f} ms plain "
                    f"{t_p:.4f} ms matmul(bf16 W) {t_l:.4f} ms bound "
                    f"{bound:.4f} ms ({by})")


def _pool_case(torch, gen, B, lens, KVH, Dh, bs, extra_blocks=0):
    """Pools (cap, bs, KVH, Dh) f32 and block tables with globally distinct
    live ids (the engine's block-ownership contract); padding is scratch 0."""
    need = [-(-int(n) // bs) for n in lens]
    nb = max(1, max(need) + extra_blocks)
    nb = 1 << (nb - 1).bit_length()
    cap = sum(need) + 1
    kp = torch.randn((cap, bs, KVH, Dh), generator=gen, device="cuda")
    vp = torch.randn((cap, bs, KVH, Dh), generator=gen, device="cuda")
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


def decode_cases(torch, timer, results):
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode
    gen = torch.Generator(device="cuda").manual_seed(12)
    bs, Dh = 16, 128
    cases = [(B, ctx, 32, 32, 0, 0.0, fused) for B in (1, 8)
             for ctx in (17, 256, 2048) for fused in (True, False)]
    cases += [(8, 256, 32, 8, 0, 0.0, True), (8, 2048, 32, 32, 64, 30.0, True),
              (8, 2048, 32, 8, 64, 30.0, False)]
    for B, ctx, H, KVH, window, softcap, fused in cases:
        G = H // KVH
        lens = torch.tensor([ctx - (b * 5) % max(ctx // 2, 1)
                             for b in range(B)], dtype=torch.int32,
                            device="cuda")
        kp, vp, tables = _pool_case(torch, gen, B, lens.tolist(), KVH, Dh, bs,
                                    extra_blocks=1)
        q = torch.randn((B, H, Dh), generator=gen, device="cuda").to(
            torch.bfloat16)
        kn = torch.randn((B, KVH, Dh), generator=gen, device="cuda")
        vn = torch.randn((B, KVH, Dh), generator=gen, device="cuda")
        kw = dict(scale=Dh ** -0.5, window=window, softcap=softcap,
                  fused_new=fused)
        a = (q, kn if fused else None, vn if fused else None, kp, vp, tables,
             lens)
        want = ref.paged_decode_ref(*a, **kw)
        got = paged_decode(*a, **kw)
        torch.cuda.synchronize()
        name = (f"decode B={B} ctx={ctx} H={H} KVH={KVH} w={window} "
                f"cap={softcap} fused={fused}")
        err = check_close(name, got, want)
        t_k = timer.ms(lambda: paged_decode(*a, **kw))
        t_p = timer.ms(lambda: ref.paged_decode_ref(*a, **kw))
        # visited work: each sequence's visible pool tokens (+ the new one)
        qpos = lens + (1 if fused else 0) - 1
        vis = [min(int(n), window - (1 if fused else 0)) if window else int(n)
               for n in lens]
        vis_tot = sum(vis) + (B if fused else 0)
        nbytes = (q.numel() * 2 * 2 + vis_tot * KVH * Dh * 4 * 2
                  + tables.numel() * 4 + B * 4)
        flops = 4 * G * Dh * KVH * vis_tot
        bound = max(nbytes / HBM_BYTES_S, flops / F32_FLOP_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_S >= flops / F32_FLOP_S \
            else "operations"
        # library: SDPA over the gathered context of the visible span
        T = int(lens.max()) + (1 if fused else 0)
        kpos = torch.arange(T, device="cuda")
        mask = kpos[None, :] < (lens[:, None] + (1 if fused else 0))
        if window:
            mask &= kpos[None, :] > (qpos[:, None] - window)
        kp2, vp2 = kp, vp
        if fused:          # the new token at position lens[b] of a copy
            kp2, vp2 = kp.clone(), vp.clone()
            blk = tables.long().gather(1, (lens.long() // bs)[:, None])[:, 0]
            kp2[blk, lens.long() % bs] = kn
            vp2[blk, lens.long() % bs] = vn
        lib = _sdpa_gathered(torch, q[:, :, None], kp2, vp2, tables, T,
                             mask[:, None, None, :], G)
        t_l = timer.ms(lib)
        results.append(dict(kernel="paged_decode", case=name, err=err, ms=t_k,
                            plain_ms=t_p, library_ms=t_l, bound_ms=bound,
                            bound_by=by))
        log(f"  {name}: err {err:.2e} kernel {t_k:.4f} ms plain {t_p:.4f} ms "
            f"sdpa {t_l:.4f} ms bound {bound:.4f} ms ({by})")


def chunk_cases(torch, timer, results):
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_chunk
    gen = torch.Generator(device="cuda").manual_seed(13)
    bs, Dh = 16, 128
    cases = [(Cp, pos0, 32, 32, 0, 0.0, fused) for Cp in (16, 256)
             for pos0 in (0, 200) for fused in (True, False)]
    cases += [(256, 200, 32, 8, 0, 0.0, True), (256, 200, 32, 32, 64, 30.0,
                                                 True),
              (16, 200, 32, 8, 64, 30.0, False)]
    for Cp, pos0, H, KVH, window, softcap, fused in cases:
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
        a = (q, kn if fused else None, vn if fused else None, kp, vp, tables,
             pos0)
        want = ref.paged_chunk_ref(*a, **kw)
        got = paged_chunk(*a, **kw)
        torch.cuda.synchronize()
        name = (f"chunk Cp={Cp} pos0={pos0} H={H} KVH={KVH} w={window} "
                f"cap={softcap} fused={fused}")
        err = check_close(name, got, want)
        t_k = timer.ms(lambda: paged_chunk(*a, **kw))
        t_p = timer.ms(lambda: ref.paged_chunk_ref(*a, **kw))
        n_vis = [min(pos0 + i + 1, window) if window else pos0 + i + 1
                 for i in range(Cp)]
        ctx_read = min(pos0, window - 1) if window else pos0
        nbytes = (q.numel() * 2 * 2 + (ctx_read + Cp) * KVH * Dh * 4 * 2
                  + tables.numel() * 4)
        flops = 4 * Dh * H * sum(n_vis)
        bound = max(nbytes / HBM_BYTES_S, flops / F32_FLOP_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_S >= flops / F32_FLOP_S \
            else "operations"
        if fused:
            kp2, vp2 = kp.clone(), vp.clone()
            pos = pos0 + torch.arange(Cp, device="cuda")
            blk = tables[0].long()[pos // bs]
            kp2[blk, pos % bs] = kn[0]
            vp2[blk, pos % bs] = vn[0]
        else:
            kp2, vp2 = kp, vp
        T = pos0 + Cp
        qi = pos0 + torch.arange(Cp, device="cuda")[:, None]
        kpos = torch.arange(T, device="cuda")[None, :]
        mask = kpos <= qi
        if window:
            mask &= kpos > qi - window
        lib = _sdpa_gathered(torch, q.permute(0, 2, 1, 3), kp2, vp2, tables,
                             T, mask[None, None], G)
        t_l = timer.ms(lib)
        results.append(dict(kernel="paged_chunk", case=name, err=err, ms=t_k,
                            plain_ms=t_p, library_ms=t_l, bound_ms=bound,
                            bound_by=by))
        log(f"  {name}: err {err:.2e} kernel {t_k:.4f} ms plain {t_p:.4f} ms "
            f"sdpa {t_l:.4f} ms bound {bound:.4f} ms ({by})")


# ---------------------------------------------------------------------------
# phase 3: the quickstart path at full width
# ---------------------------------------------------------------------------
def engine_phase(torch, counters):
    from repro_torch.configs import MORPH_LLAMA2_7B, ServingConfig
    from repro_torch.core import profile_swap_sequence, tree_bytes
    from repro_torch.engine import (EngineConfig, MorphServeEngine,
                                    NVIDIA_H100_SXM, azure_like)
    from repro_torch.engine.kv_cache import kv_block_bytes
    from repro_torch.models import lm

    cfg = MORPH_LLAMA2_7B.replace(n_layers=8)        # depth cut, full width
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    calib = torch.randint(0, cfg.vocab, (2, 32), device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(1))
    prof = profile_swap_sequence(cfg, params, calib, bits=4)
    torch.cuda.synchronize()
    log(f"model: {cfg.name} x{cfg.n_layers} layers d={cfg.d_model} "
        f"H={cfg.n_heads} KVH={cfg.n_kv_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} {cfg.dtype}; LIS swap order {prof.order} "
        f"({time.perf_counter() - t0:.1f} s incl. init)")

    # quickstart's deliberately tight HBM budget: weights + 8 fp32 KV blocks
    wb = tree_bytes(params)
    bb = kv_block_bytes(cfg, 16, 4)
    sc = ServingConfig(hbm_budget_bytes=int((wb + 8 * bb) / 0.95) + 2 * bb,
                       kv_block_size=16, max_batch_slots=8, max_seq_len=1024,
                       swap_levels=(0, 1, 2, 4), mode="performance",
                       kv_resize_step_frac=0.25)
    ecfg = EngineConfig(policy="morph", compute="real", use_quant_kernel=True,
                        hw=NVIDIA_H100_SXM)
    t0 = time.perf_counter()
    eng = MorphServeEngine(cfg, params, sc, ecfg, swap_order=prof.order,
                           device="cuda")
    torch.cuda.synchronize()
    log(f"engine built ({time.perf_counter() - t0:.1f} s): weights "
        f"{wb / 1e9:.3f} GB, KV block {bb / 1e6:.3f} MB, budget "
        f"{sc.hbm_budget_bytes / 1e9:.3f} GB, start pool "
        f"{eng.pool.num_blocks - 1} blocks")

    bad_logits = []

    def checked(fn, what):
        def run(*a, **kw):
            out = fn(*a, **kw)
            if not bool(torch.isfinite(out).all()):
                bad_logits.append(what)
            return out
        return run

    for what in ("decode", "prefill", "prefill_batch", "prefill_chunk"):
        setattr(eng.exec, what, checked(getattr(eng.exec, what), what))

    trace = azure_like(duration_s=4.0, base_rps=2.0, seed=3, prompt_mean=160,
                       gen_mean=24, prompt_max=512, gen_max=48)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    report = eng.run_trace(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}

    hist = eng.monitor.history
    levels = sorted({t.swap_level for t in hist})
    blocks = [t.kv_total_blocks for t in hist]
    chunks = sum(r.prefill_chunks for r in eng.all_requests)
    tokens = sum(len(r.generated) for r in eng.all_requests)
    log(f"served {report.n_finished}/{report.n_requests} requests; "
        f"{report.row()} (virtual clock, H100 cost model)")
    log(f"swap levels used {levels}; KV pool {blocks[0]} -> peak "
        f"{max(blocks)} -> end {blocks[-1]} blocks; swaps "
        f"{len(eng.actuator.swap_log)}, resizes {len(eng.resize_log)}, "
        f"chunk prefills {chunks}, steps {len(hist)}")
    log(f"engine wall time {wall:.2f} s for {tokens} generated tokens "
        f"(host clock, synchronized); launches {launches}")
    fails = []
    if report.n_finished != report.n_requests or report.n_requests == 0:
        fails.append("not every request was served")
    if max(levels) <= 0:
        fails.append("no swap level > 0 was reached")
    if chunks <= 0:
        fails.append("no chunked prefill happened")
    for name, n in launches.items():
        if n <= 0:
            fails.append(f"kernel {name} was not launched on the main path")
    if bad_logits:
        fails.append(f"non-finite logits in {sorted(set(bad_logits))}")
    if fails:
        raise AssertionError("engine phase: " + "; ".join(fails))
    return cfg, eng, launches


# ---------------------------------------------------------------------------
# phase 4: one decode step and one chunk step, kernels vs plain
# ---------------------------------------------------------------------------
def parity_phase(torch, cfg, eng):
    """One decode step (8 live sequences of ragged length) and one chunk
    step of the full-width model at the deepest swap level (every layer
    int4, so every matmul of the layers goes through K1), through the
    kernels and through the plain versions, each from the same pool
    state."""
    from repro_torch.engine.kv_cache import PagedKVPool
    level = max(eng.plan.levels)
    layers = eng.plan.layer_list(level)
    ex = eng.exec
    bs, slots, nb_t, Sp = 16, 8, 16, 112
    lens = torch.tensor([100 - 7 * i for i in range(slots)],
                        dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)
    pool = PagedKVPool(cfg, slots * nb_t + 1, bs, dtype=torch.float32,
                       device="cuda")
    tables = torch.arange(1, 1 + slots * nb_t, dtype=torch.int32,
                          device="cuda").reshape(slots, nb_t)
    prompts = torch.randint(0, cfg.vocab, (slots, Sp), generator=gen,
                            device="cuda")
    ex.prefill_batch(layers, prompts, pool.k, pool.v, tables[:, :Sp // bs],
                     lens)

    def compare(what, run):
        a = run(pool.k.clone(), pool.v.clone(), False)
        b = run(pool.k.clone(), pool.v.clone(), True)
        torch.cuda.synchronize()
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
    compare(f"decode step ({slots} live slots, level {level}: all layers "
            "int4)",
            lambda k, v, plain: ex.decode(layers, tokens, lens, k, v, tables,
                                          plain=plain))
    pos0 = int(lens[0])
    chunk = torch.randint(0, cfg.vocab, (1, 64), generator=gen, device="cuda")
    compare(f"chunk step (Cp=64 at pos0={pos0})",
            lambda k, v, plain: ex.prefill_chunk(layers, chunk, pos0, k, v,
                                                 tables[0], plain=plain))


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
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import paged_chunk, paged_decode
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
    log("kernel phase (bf16 activations, float32 pool; tolerance "
        f"|k-p| <= rtol*|p| + atol*max|p|, {TOL})")
    wna16_cases(torch, timer, results)
    decode_cases(torch, timer, results)
    chunk_cases(torch, timer, results)

    # 3. the main path; only its launches are counted
    counters = (wna16_gemm, paged_decode, paged_chunk)
    cfg, eng, launches = engine_phase(torch, counters)

    # 4. step parity
    log(f"step parity (kernels vs plain, tolerance {LOGIT_TOL} x "
        "max|logit|)")
    parity_phase(torch, cfg, eng)

    # the representative main-path case of each kernel, errors over all cases
    main_case = {"wna16_gemm": "wna16 M=8 K=4096 N=11008 int4",
                 "paged_decode": ("decode B=8 ctx=2048 H=32 KVH=32 w=0 "
                                  "cap=0.0 fused=True"),
                 "paged_chunk": ("chunk Cp=256 pos0=200 H=32 KVH=32 w=0 "
                                 "cap=0.0 fused=True")}
    csrc = "src/repro_torch/kernels/csrc/"
    where = {"wna16_gemm": (csrc + "wna16_gemm.cu",
                            "src/repro/kernels/wna16_gemm.py:81"),
             "paged_decode": (csrc + "paged_attention.cu",
                              "src/repro/kernels/paged_attention.py:38"),
             "paged_chunk": (csrc + "paged_attention.cu",
                             "src/repro/kernels/paged_attention.py:250")}
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
