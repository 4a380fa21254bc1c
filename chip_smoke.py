#!/usr/bin/env python3
"""Drive horovod_tpu_torch's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``horovod_tpu_torch/csrc`` and print the
   build time;
3. hold every kernel against its plain PyTorch version at the main-path
   shapes (LayerNorm ``[16384, 1024]`` bf16, softmax cross-entropy
   ``[16384, 32768]`` bf16, flash attention forward, dq and dk/dv at q/k/v
   ``[8, 2048, 8, 128]`` bf16 causal), and time the kernel, the plain
   version and one PyTorch call computing the same function (the LayerNorm
   and flash kernels in turns with that call, median of 5 batches of 20,
   the LayerNorm's each a CUDA graph; the cross-entropy kernels mean of 20
   calls); then the flash kernels at ragged shapes (T = 96, 129 causal;
   T_q = 64 against T_kv = 128 and 128 against 320, not causal; 130
   against 70, causal) in fp32 and bf16;
4. check a small fp32 transformer on the card (kernels, flash attention
   included) against the same weights on the CPU (plain versions):
   logits, loss and gradients;
5. train the full-width transformer-LM (d_model 1024, 8 heads of 128,
   d_ff 4096, vocab 32768, seq 2048, bf16, batch 8) with
   ``DistributedOptimizer(AdamW(lr=1e-4, weight_decay=1e-4))`` over NCCL
   for a few steps on a fixed batch: the loss must be finite and fall,
   and every kernel's launch count must rise by its expected count per
   step.

Prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that last line.  ``--profile`` adds one profiled step.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12     # H100 SXM dense bf16 on the tensor cores

N_ROWS, D_MODEL, VOCAB = 8 * 2048, 1024, 32768
LAYERS, STEPS = 8, 5   # full depth of the main path; a few steps
# attention of the main path: batch, seq, heads, head dim
ATTN_B, ATTN_T, ATTN_H, ATTN_D = 8, 2048, D_MODEL // 128, 128


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0].strip()


def _runner(fn, iters, graph):
    """A callable that makes ``iters`` calls of ``fn``: the calls
    themselves, or one replay of a CUDA graph that holds them, so that the
    host's time per call does not set the pace of a short kernel."""
    import torch

    if not graph:
        def run():  # each result is dropped at once, as the caller would
            for _ in range(iters):
                fn()
        return run
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    return g.replay


def _elapsed_ms(run):
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    return _elapsed_ms(_runner(fn, iters, False)) / iters


def time_in_turns(kernel, library, batches=5, iters=20, warmup=3,
                  graph=False):
    """Median ms per call of ``kernel`` and of ``library``, timed in turns
    (kernel, library, kernel, library, ...), ``batches`` batches of
    ``iters`` calls each: a slow stretch of the card falls on both.  With
    ``graph``, each batch is one replay of a CUDA graph of its calls."""
    import torch

    for fn in (kernel, library):
        for _ in range(warmup):
            fn()
    runs = [_runner(fn, iters, graph) for fn in (kernel, library)]
    times = ([], [])
    for _ in range(batches):
        for run, out in zip(runs, times):
            out.append(_elapsed_ms(run) / iters)
    torch.cuda.synchronize()
    return statistics.median(times[0]), statistics.median(times[1])


def rates(entry, ops):
    """Adds the achieved TFLOP/s and the share of the bound to a kernel's
    entry of the ``kernels`` line."""
    entry["tflops"] = ops / (entry["ms"] * 1e-3) / 1e12
    entry["bound_share"] = entry["bound_ms"] / entry["ms"]
    return entry


def bound(nbytes, ops, ops_per_s=FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def assert_close(name, got, want, rtol, atol):
    import torch

    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version (max abs err "
            f"{max_err(got, want):.3e}, rtol={rtol}, atol={atol})")


def check_dlogits(name, got, want, labels, dloss):
    """dlogits against the plain version, every entry at its own scale:
    most are far below the label entry's, so one absolute tolerance for
    the tensor would leave them unchecked.  Each entry may differ by one
    rounding to the output dtype (one ulp of it, relative; 1e-5 for
    fp32), plus 1/128 of the dtype's smallest normal number, since
    subnormal results keep few bits; the label entry exp(x - lse) - 1
    also by a few fp32 ulps of 1, times its row's dloss, lost to the
    cancellation."""
    import torch

    fi = torch.finfo(want.dtype)
    rtol = 1e-5 if want.dtype == torch.float32 else fi.eps
    tol = rtol * want.float().abs() + fi.tiny / 128
    rows = torch.arange(want.shape[0], device=want.device)
    tol[rows, labels.long()] += 2 ** -20 * dloss.float()
    worst = float(((got.float() - want.float()).abs() / tol).max())
    if not worst <= 1:
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version (max abs err "
            f"{max_err(got, want):.3e}, {worst:.2f} times the tolerance of "
            f"rtol={rtol} per entry)")


def check_kernels():
    """Phase 3: each kernel against its plain version, with times."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops.cuda import layer_norm as ln
    from horovod_tpu_torch.ops.cuda import softmax_xent as sx

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n, d, v = N_ROWS, D_MODEL, VOCAB
    eps = 1e-6
    x = torch.randn(n, d, device=dev, generator=gen).to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
    beta = 0.1 * torch.randn(d, device=dev, generator=gen)
    dy = torch.randn(n, d, device=dev, generator=gen).to(torch.bfloat16)
    kernels = []

    # LayerNorm forward (with statistics, as in training).  Tolerances:
    # bf16 out may differ by one bf16 rounding (2^-8 relative); fp32
    # statistics only by summation order.
    out, mean, rstd = ln.layer_norm_fwd(x, gamma, beta, eps, True)
    p_out, p_mean, p_rstd = ln.layer_norm_fwd_plain(x, gamma, beta, eps)
    torch.cuda.synchronize()
    assert_close("layer_norm_fwd out", out, p_out, 1e-2, 1e-2)
    assert_close("layer_norm_fwd mean", mean, p_mean, 1e-5, 1e-5)
    assert_close("layer_norm_fwd rstd", rstd, p_rstd, 1e-4, 1e-5)
    w16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    ops = 8 * n * d
    t_b, by = bound(n * d * 2 * 2 + 2 * d * 4 + 2 * n * 4, ops)
    # kernel and library call in turns, as the flash kernels are, each
    # batch one CUDA graph: a call takes less device time than the host
    # needs to make it
    ms, library_ms = time_in_turns(
        lambda: ln.layer_norm_fwd(x, gamma, beta, eps, True),
        lambda: F.layer_norm(x, (d,), w16, b16, eps), graph=True)
    kernels.append(rates(dict(
        name="layer_norm_fwd", route="cuda",
        source="horovod_tpu_torch/csrc/layer_norm.cu",
        replaces="horovod_tpu/ops/pallas/layer_norm.py:36",
        max_abs_err=max(max_err(out, p_out), max_err(mean, p_mean),
                        max_err(rstd, p_rstd)),
        ms=ms,
        plain_ms=time_ms(
            lambda: ln.layer_norm_fwd_plain(x, gamma, beta, eps)),
        bound_ms=t_b, bound_by=by, library_ms=library_ms), ops))

    # LayerNorm backward.  dx bf16 as above; dgamma/dbeta are fp32 sums
    # over 16384 rows taken in another order.
    dx, dg, db = ln.layer_norm_bwd(x, gamma, mean, rstd, dy)
    p_dx, p_dg, p_db = ln.layer_norm_bwd_plain(x, gamma, mean, rstd, dy)
    torch.cuda.synchronize()
    assert_close("layer_norm_bwd dx", dx, p_dx, 1e-2, 1e-2)
    assert_close("layer_norm_bwd dgamma", dg, p_dg, 1e-3, 1e-3)
    assert_close("layer_norm_bwd dbeta", db, p_db, 1e-3, 1e-3)
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [d], w16, b16, eps)
    ops = 12 * n * d
    t_b, by = bound(3 * n * d * 2 + 2 * n * 4 + 3 * d * 4, ops)
    ms, library_ms = time_in_turns(
        lambda: ln.layer_norm_bwd(x, gamma, mean, rstd, dy),
        lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [d], lmean, lrstd, w16, b16, [True, True, True]),
        graph=True)
    kernels.append(rates(dict(
        name="layer_norm_bwd", route="cuda",
        source="horovod_tpu_torch/csrc/layer_norm.cu",
        replaces="horovod_tpu/ops/pallas/layer_norm.py:53",
        max_abs_err=max(max_err(dx, p_dx), max_err(dg, p_dg),
                        max_err(db, p_db)),
        ms=ms,
        plain_ms=time_ms(
            lambda: ln.layer_norm_bwd_plain(x, gamma, mean, rstd, dy)),
        bound_ms=t_b, bound_by=by, library_ms=library_ms), ops))
    del x, dy, out, p_out, dx, p_dx

    # softmax cross-entropy at the LM head's shape; dloss = 1/N as in the
    # mean loss.  Tolerances: fp32 loss differs only by summation order
    # over 32768 terms; bf16 dlogits by one bf16 rounding of each entry
    # (check_dlogits).
    logits = (3 * torch.randn(n, v, device=dev, generator=gen)).to(
        torch.bfloat16)
    labels = torch.randint(0, v, (n,), device=dev, generator=gen,
                           dtype=torch.int32)
    labels64 = labels.long()
    loss, lse = sx.softmax_xent_fwd(logits, labels, True)
    p_loss, p_lse = sx.softmax_xent_fwd_plain(logits, labels)
    torch.cuda.synchronize()
    assert_close("softmax_xent_fwd loss", loss, p_loss, 1e-5, 1e-4)
    assert_close("softmax_xent_fwd lse", lse, p_lse, 1e-5, 1e-4)
    ops = 4 * n * v
    t_b, by = bound(n * v * 2 + n * 4 * 3, ops)
    kernels.append(rates(dict(
        name="softmax_xent_fwd", route="cuda",
        source="horovod_tpu_torch/csrc/softmax_xent.cu",
        replaces="horovod_tpu/ops/pallas/softmax_xent.py:37",
        max_abs_err=max(max_err(loss, p_loss), max_err(lse, p_lse)),
        ms=time_ms(lambda: sx.softmax_xent_fwd(logits, labels, True)),
        plain_ms=time_ms(lambda: sx.softmax_xent_fwd_plain(logits, labels),
                         iters=5),
        bound_ms=t_b, bound_by=by,
        library_ms=time_ms(lambda: F.cross_entropy(
            logits, labels64, reduction="none"))),
        ops))

    dloss = torch.full((n,), 1.0 / n, device=dev)
    dlogits = sx.softmax_xent_bwd(logits, labels, lse, dloss)
    p_dlogits = sx.softmax_xent_bwd_plain(logits, labels, lse, dloss)
    torch.cuda.synchronize()
    check_dlogits("softmax_xent_bwd", dlogits, p_dlogits, labels, dloss)
    lg = logits.detach().requires_grad_(True)
    lib_loss = F.cross_entropy(lg, labels64)
    t_b, by = bound(2 * n * v * 2 + n * 4 * 3, ops)
    kernels.append(rates(dict(
        name="softmax_xent_bwd", route="cuda",
        source="horovod_tpu_torch/csrc/softmax_xent.cu",
        replaces="horovod_tpu/ops/pallas/softmax_xent.py:64",
        max_abs_err=max_err(dlogits, p_dlogits),
        ms=time_ms(lambda: sx.softmax_xent_bwd(logits, labels, lse, dloss)),
        plain_ms=time_ms(
            lambda: sx.softmax_xent_bwd_plain(logits, labels, lse, dloss),
            iters=5),
        bound_ms=t_b, bound_by=by,
        # the backward of F.cross_entropy's own graph
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_loss, lg, retain_graph=True))),
        ops))
    del logits, dlogits, p_dlogits, lg, lib_loss
    kernels += check_flash()
    check_flash_ragged()
    for k in kernels:
        print(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3e} "
              f"ms {k['ms']:.4f} plain_ms {k['plain_ms']:.4f} "
              f"library_ms {k['library_ms']:.4f} bound_ms "
              f"{k['bound_ms']:.4f} ({k['bound_by']}) tflops "
              f"{k['tflops']:.1f} bound_share {k['bound_share']:.3f}",
              flush=True)
    return kernels


def attention_pairs(tq, tkv, causal):
    """(query, key) pairs that the mask keeps: what the products cost."""
    if not causal:
        return tq * tkv
    return sum(min(i + 1, tkv) for i in range(tq))


def check_flash_close(name, got, want, rel):
    """``got`` [B, T, H, D] against ``want`` row by row: each (b, t, h) row
    of D entries within ``rel`` times that row's largest entry of the
    plain version, never above ``rel`` times the tensor's largest.  The
    rows' scales differ by orders (out and dq of query i fall as
    1/sqrt(i), dk and dv of key j likewise), so one limit for the tensor
    would pass a kernel that got the small rows wrong.  Each row may also
    differ by 2^-18 of the tensor's largest entry: a query that sees one
    key has dp = delta, so its dq is fp32 cancellation noise in both."""
    w = want.float()
    d = (got.float() - w).abs()
    top = float(w.abs().max())
    limit = (rel * w.abs().amax(-1) + 2 ** -18 * top).clamp(max=rel * top)
    worst = float((d.amax(-1) / limit).max())
    if not worst <= 1:
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version (max abs err "
            f"{float(d.max()):.3e}, {worst:.2f} times the limit of rel={rel} "
            f"of each row's largest entry)")
    print(f"{name}: max abs err {float(d.max()):.3e}, {worst:.3f} of the "
          f"per-row limit", flush=True)
    return float(d.max())


def flash_inputs(dtype, b, tq, tkv, h, d, seed):
    """q, k, v as the model hands them over (views of one qkv tensor)
    when T_q == T_kv; dO contiguous."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, device=dev, generator=gen).to(dtype)
    if tq == tkv:
        q, k, v = mk(b, tq, 3, h, d).unbind(dim=2)
    else:
        q, k, v = mk(b, tq, h, d), mk(b, tkv, h, d), mk(b, tkv, h, d)
    return q, k, v, mk(b, tq, h, d)


def run_flash(q, k, v, do, causal, scale, rel, tag):
    """The three flash kernels against their plain versions; returns the
    largest error of each and what the timing needs."""
    from horovod_tpu_torch.ops.cuda import flash_attention as fa

    out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, causal, scale)
    # lse: only the order of the fp32 sums differs
    lse_err = max_err(lse, p_lse)
    if not lse_err <= 1e-4:
        raise AssertionError(f"flash_attention_fwd lse {tag}: max abs err "
                             f"{lse_err:.3e} > 1e-4")
    errs = {"fwd": max(check_flash_close(f"flash_attention_fwd out {tag}",
                                         out, p_out, rel), lse_err)}
    del p_out, p_lse
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    errs["dq"] = check_flash_close(
        f"flash_attention_bwd_dq {tag}", dq, fa.flash_attention_bwd_dq_plain(
            q, k, v, do, lse, delta, causal, scale), rel)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                        scale)
    p_dk, p_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  causal, scale)
    errs["dkv"] = max(
        check_flash_close(f"flash_attention_bwd_dkv dk {tag}", dk, p_dk, rel),
        check_flash_close(f"flash_attention_bwd_dkv dv {tag}", dv, p_dv, rel))
    return errs, lse, delta


def check_flash():
    """Phase 3, flash attention at the main path's shape: q/k/v
    ``[8, 2048, 8, 128]`` bf16, causal.  Tolerances: out, dq, dk, dv within
    2e-2 of each row's largest entry of the plain version
    (``check_flash_close``; P and dS are rounded to bf16 before their
    products, at other points of the online softmax than in the plain
    version, and outputs to bf16); lse 1e-4 absolute."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops.cuda import flash_attention as fa

    b, t, h, d = ATTN_B, ATTN_T, ATTN_H, ATTN_D
    scale = 1 / d ** 0.5
    plan = fa.flash_attention_fwd_plan(b, h, t, d)
    print(f"flash forward: persistent grid of {plan['grid']} blocks over "
          f"{b * h * -(-t // 128)} work tiles, {plan['k_stages']} K and "
          f"{plan['v_stages']} V stages", flush=True)
    q, k, v, do = flash_inputs(torch.bfloat16, b, t, t, h, d, seed=1)
    errs, lse, delta = run_flash(q, k, v, do, True, scale, 2e-2,
                                 f"[{b}, {t}, {h}, {d}] bf16 causal")
    # the library's yardstick, on its own [B, H, T, D] layout
    q4, k4, v4 = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    do4 = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    out4 = sdpa()

    pairs = attention_pairs(t, t, True) * b * h
    item = 2  # bf16
    tensor = b * t * h * d * item
    rows = b * h * t * 4  # one fp32 [B*H, T] vector
    common = dict(route="cuda", source="horovod_tpu_torch/csrc/"
                  "flash_attention.cu")
    # kernel and SDPA yardstick in turns, median of 5 batches of 20 calls;
    # dq and dk/dv against the backward of SDPA's graph for the same
    # gradients (its one kernel computes dq, dk and dv together)
    fwd = lambda: fa.flash_attention_fwd(q, k, v, True, scale)
    dq = lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True,
                                           scale)
    dkv = lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True,
                                             scale)
    specs = [
        ("flash_attention_fwd", 130, "fwd", fwd, sdpa,
         fa.flash_attention_fwd_plain, (q, k, v, True, scale),
         4 * tensor + rows, 4),
        ("flash_attention_bwd_dq", 228, "dq", dq,
         lambda: torch.autograd.grad(out4, (q4,), do4, retain_graph=True),
         fa.flash_attention_bwd_dq_plain,
         (q, k, v, do, lse, delta, True, scale), 5 * tensor + 2 * rows, 6),
        ("flash_attention_bwd_dkv", 277, "dkv", dkv,
         lambda: torch.autograd.grad(out4, (k4, v4), do4, retain_graph=True),
         fa.flash_attention_bwd_dkv_plain,
         (q, k, v, do, lse, delta, True, scale), 6 * tensor + 2 * rows, 8),
    ]
    kernels = []
    for name, line, err, kernel, library, plain, args, nbytes, per in specs:
        ops = per * pairs * d
        t_b, by = bound(nbytes, ops, BF16_TC_OPS_PER_S)
        ms, library_ms = time_in_turns(kernel, library)
        kernels.append(rates(dict(
            name=name, **common,
            replaces=f"horovod_tpu/ops/pallas/flash_attention.py:{line}",
            max_abs_err=errs[err], ms=ms,
            plain_ms=time_ms(lambda: plain(*args), iters=3, warmup=1),
            bound_ms=t_b, bound_by=by, library_ms=library_ms), ops))
    return kernels


def check_flash_ragged():
    """Phase 3, flash attention at ragged shapes: T = 96 and 129 causal
    (a part tile), T_q = 64 against T_kv = 128 and T_q = 128 against T_kv =
    320, not causal, and T_q = 130 against T_kv = 70 causal.  fp32 within 1e-5
    of each row's largest entry of the plain version (full fp32 products,
    sums in another order); bf16 within 2e-2 as at the main shape."""
    import torch

    for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for tq, tkv, causal in ((96, 96, True), (64, 128, False),
                                (129, 129, True), (128, 320, False),
                                (130, 70, True)):
            q, k, v, do = flash_inputs(dtype, 2, tq, tkv, 4, 64, seed=tq)
            tag = f"T_q {tq} T_kv {tkv} causal {causal} {dtype}"
            errs, _, _ = run_flash(q, k, v, do, causal, 0.125, rel, tag)
            print(f"flash ragged {tag}: max abs err {errs}", flush=True)


def check_small_model():
    """Phase 4: the kernels inside the model agree with the plain path."""
    import numpy as np
    import torch

    from horovod_tpu_torch.models import Transformer, TransformerConfig, \
        lm_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig(vocab_size=512, n_layers=2, d_model=64,
                            n_heads=4, d_ff=128, max_len=32,
                            dtype=torch.float32)
    tokens = torch.from_numpy(
        np.random.RandomState(1).randint(0, 512, (2, 32)))
    results = {}
    for device in ("cpu", "cuda"):
        model = Transformer(cfg, device=device, seed=3)
        tok = tokens.to(device)
        logits = model(tok)
        loss = lm_loss(logits, tok)
        loss.backward()
        results[device] = (logits.detach().cpu(), loss.detach().cpu(),
                           {k: p.grad.cpu()
                            for k, p in model.named_parameters()})
    (lc, sc, gc), (lg, sg, gg) = results["cpu"], results["cuda"]
    # fp32 on both sides; tolerance of the CPU parity tests
    assert_close("small model logits", lg, lc, 1e-4, 1e-5)
    assert_close("small model loss", sg, sc, 1e-5, 1e-5)
    for k in gc:
        assert_close(f"small model grad {k}", gg[k], gc[k], 1e-3, 1e-5)
    print(f"small model: loss cuda {float(sg):.6f} cpu {float(sc):.6f}",
          flush=True)


def train(layers, steps, smi, profile=False):
    """Phase 5: the data-parallel training step at full width.  With
    ``profile``, one more step runs under ``torch.profiler`` after the
    counted ones and its device time by operator is written to
    ``chiprun_out/profile_step.txt``."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer, TransformerConfig, \
        lm_loss
    from horovod_tpu_torch.ops import cuda as kernels

    hvd.init()
    torch.cuda.reset_peak_memory_stats()
    try:
        batch, seq = 8, 2048
        cfg = TransformerConfig(vocab_size=VOCAB, n_layers=layers,
                                d_model=D_MODEL, n_heads=D_MODEL // 128,
                                d_ff=4 * D_MODEL, max_len=seq,
                                dtype=torch.bfloat16)
        model = Transformer(cfg, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        tokens = torch.from_numpy(np.random.RandomState(0).randint(
            0, VOCAB, (batch, seq))).to(hvd.device())
        print(f"train: depth {layers} layers (full: 8), {n_params} "
              f"parameters, batch {batch} x seq {seq}", flush=True)

        kernels.reset_launch_counts()
        losses, times = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            logits = model(tokens)
            loss = lm_loss(logits, tokens)
            loss.backward()
            opt.step()
            losses.append(loss.item())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = kernels.launch_counts()
        profiled_ms = _profile_step(model, opt, tokens) if profile else None
        if tuple(logits.shape) != (batch, seq, VOCAB):
            raise AssertionError(f"logits shape {tuple(logits.shape)}")
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
    finally:
        hvd.shutdown()

    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    per_step = {"layer_norm_fwd": 2 * layers + 1,
                "layer_norm_bwd": 2 * layers + 1,
                "softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
                "flash_attention_fwd": layers,
                "flash_attention_bwd_dq": layers,
                "flash_attention_bwd_dkv": layers}
    for name, want in per_step.items():
        if counts[name] != want * steps:
            raise AssertionError(
                f"{name} launched {counts[name]} times in {steps} steps, "
                f"expected {want} per step")
    steady = statistics.median(times[1:]) if steps > 1 else times[0]
    print(f"train: losses {losses}", flush=True)
    print(f"train: step times s {times}", flush=True)
    print(f"train: median step {steady * 1e3:.2f} ms, "
          f"{batch * seq / steady:.1f} tokens/s on {smi}", flush=True)
    if profiled_ms is not None:
        print(f"train: device busy {profiled_ms:.3f} ms of a "
              f"{steady * 1e3:.3f} ms step", flush=True)
    print(f"train: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB, launches {counts}", flush=True)
    return counts, {"losses": losses, "step_s": times,
                    "tokens_per_s": batch * seq / steady,
                    "layers": layers, "params": n_params}


def _profile_step(model, opt, tokens):
    import torch
    from torch.profiler import ProfilerActivity

    from horovod_tpu_torch.models import lm_loss

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        opt.zero_grad(set_to_none=True)
        lm_loss(model(tokens), tokens).backward()
        opt.step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    table = events.table(sort_by="self_device_time_total", row_limit=60)
    # operator rows repeat the time of the kernels they launch, and so do
    # user ranges such as Optimizer.step: sum only the device's own rows
    # (kernels and copies)
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in device) / 1e3
    with open(os.path.join(_out_dir(), "profile_step.txt"), "w") as f:
        f.write(f"device time {total:.3f} ms\n{table}\n")
    print(f"profile: device time {total:.3f} ms in one step; top kernels:",
          flush=True)
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}", flush=True)
    return total


def _out_dir():
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra training step")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    try:
        from horovod_tpu_torch.ops.cuda import _build
    except ImportError as exc:
        print(f"chip_smoke: horovod_tpu_torch is not importable ({exc}); "
              f"run from the root of the repository", file=sys.stderr)
        return 1

    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    kernels = check_kernels()
    check_small_model()
    counts, run = train(LAYERS, STEPS, smi, args.profile)
    for k in kernels:
        k["launches"] = counts[k["name"]]

    with open(os.path.join(_out_dir(), "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "kernels": kernels, "train": run}, f,
                  indent=1)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
