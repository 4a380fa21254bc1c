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
   version and one PyTorch call computing the same function (each kernel
   in turns with that call, median of 5 batches of 20, the LayerNorm's
   each a CUDA graph); then the flash kernels at ragged shapes (T = 96, 129 causal;
   T_q = 64 against T_kv = 128 and 128 against 320, not causal; 130
   against 70, causal) in fp32 and bf16, at head dims 24, 40, 192 and 256
   and at B*H = 65536 (the generic kernels), with the times of the D =
   192 and 256 instances; then the column split above D = 256: D = 320
   and 512, fp32 and bf16, causal, at ``[2, 2048, 8, D]`` and a ragged
   T = 1000, and the D = 512 times beside the D = 256 ones with the
   factor of redundant score work;
4. check a small fp32 transformer on the card (kernels, flash attention
   included) against the same weights on the CPU (plain versions):
   logits, loss and gradients; then the same at two heads of 512
   (d_model 1024, the column-split flash kernels);
5. train the full-width transformer-LM (d_model 1024, 8 heads of 128,
   d_ff 4096, vocab 32768, seq 2048, bf16, batch 8) with
   ``DistributedOptimizer(AdamW(lr=1e-4, weight_decay=1e-4))`` over NCCL
   for a few steps on a fixed batch: the loss must be finite and fall,
   and every kernel's launch count must rise by its expected count per
   step; the eager plane's cycle thread runs beside it (``hvd.init``);
6. run the eager collective plane on the card at ``min(cards, 4)``
   ranks (one process a card above one): every collective in fp32, bf16,
   fp16 and int32, join, barrier, ``broadcast_object`` and the in-place
   variants against torch ops on the card, a stream-ordering check, and
   ``grouped_allreduce`` of the full-width model's gradients against
   ``allreduce_gradients``; prints the median negotiation time and the
   fused allreduce's time and GB/s.  Then block-scaled int8, each rank
   with values of its own: ``grouped_allreduce(compression="int8")`` of
   those gradients, ``reduce_scatter`` with int8 and three steps of
   ``DistributedOptimizer(..., compression=Compression.int8)``, each held
   to the fp32 result within ``(n + 1) * blockmax / 254``; above one rank
   the int8 path must have run, at one rank the plane's resolves to the
   exact wire; prints the int8 and fp32 grouped allreduce's times and
   wire bytes;
7. the CNNs: ResNet-18 (narrow), VGG-16 and Inception V3 on the card
   against the same weights on the CPU; then ResNet-50 trained at full
   width and depth as ``bench.py::_bench_resnet`` runs it (224x224x3,
   1000 classes, bf16, batch 64, ``DistributedOptimizer(SGD(0.1,
   momentum=0.9))``, world size 1): the loss must be finite and fall;
   prints images/s per GPU; then one step each of VGG-16 at 224 and
   Inception V3 at 299, full width, batch 16;
8. ZeRO-1 at ``min(cards, 4)`` ranks (one process a card above one):
   phase 5's model trained by ``DistributedOptimizer``,
   ``ShardedDistributedOptimizer`` and ``ZeroDistributedOptimizer`` in
   turns; the ZeRO variants' parameters equal ``DistributedOptimizer``'s
   after three steps on the same gradients, every rank's are bitwise the
   same, each rank holds its layout's block of each moment, gathered and
   resharded state is the rank's; one int8 sharded step within the
   per-block bound; prints step times, optimizer state bytes and peak
   memory, and how far three steps on each model's own gradients take
   each run from ``DistributedOptimizer``'s, beside the same for
   ``DistributedOptimizer`` again and with other buckets;
9. sequence parallelism at the same ranks: ring (causal and not),
   zigzag and Ulysses attention (each by default on the flash kernels)
   at q, k, v ``[2, 8192 * P, 8, 128]`` bf16 against ``flash_attention``
   over the whole sequence on one card (out, dq, dk, dv); the full-width
   transformer trained with zigzag attention on ``[2, 8192]`` tokens a
   GPU (the loss falls, (2P + 1) launches of each flash kernel a block
   and step), then with causal ring attention under
   ``DistributedOptimizer`` (the two communicators' order; the ranks'
   parameters bitwise the same); the zigzag model's first step at two
   layers in fp32 against the whole sequence on one card; and phase 5's
   step with ``remat=True`` against without, in turns.  At one card ZeRO takes the replicated update and
   the ring has no hop, and the phases say so;
10. model parallelism at the same ranks (``hvd.grid``, ``make_mesh``):
   (a) the world's two halves as two process groups allreducing
   integer-valued fp32 at once, bitwise, with ``max_concurrent_groups``
   >= 2, and ZeRO over the dp group of ``grid(dp=2, tp=2)`` (both tp
   columns bitwise equal, within rtol 1e-5 of AdamW on one card over
   the mean gradient); (b) phase 5's transformer split over ``tp`` on
   ``grid(dp=2, tp=2)`` and ``grid(dp=1, tp=4)``, ``[8, 2048]`` tokens a
   dp replica, ``DistributedOptimizer(group=dp)``, 5 steps: the first
   loss within bf16 tolerance of the one-card model's, launches as
   phase 5's, step ms, tokens/s per GPU, peak memory; and two layers in
   fp32 against one card (loss rtol 1e-5, gradients rtol 1e-3 atol
   1e-5); (c) the same with every second block a switch-MoE block of 8
   experts over ``make_mesh({"dp": 2, "ep": 2})`` (capacity factor 1.25,
   groups of 4096), loss ``lm_loss + 0.01 * aux``: finite and falling,
   each expert's tokens and the share dropped, and the two-layer fp32
   check with the router's and the experts' gradients; (d) the 8 blocks
   as 4 pipeline stages of 2 with 8 microbatches of ``[1, 2048]``:
   outputs and every stage's gradients against the sequential blocks on
   one card in fp32, then the bf16 LM with its blocks pipelined for 5
   steps beside the one-card step and the (M + S - 1) / M bubble bound.
   At one card tp, ep and pp have size 1 (the single-rank path);
11. Adasum, durable checkpoints and the input pipeline at the largest
   power of two <= ``min(cards, 4)`` ranks: (a) the eager plane's
   ``allreduce(op=Adasum)`` in fp32, bf16 and fp16, ``grouped_allreduce``,
   ``allreduce_``, with the last rank joined and over each half of the
   world as a process group, each rank with values of its own, held to
   the float64 ``adasum_reference`` (rtol 1e-4, atol 1e-5 in fp32) and
   bitwise the same on every rank; at four ranks again with
   ``HVD_ADASUM_HIERARCHICAL=1``, ``HVD_HIER_LOCAL_SIZE=2`` against
   Adasum of the local averages; the grouped Adasum allreduce of phase
   5's 169,904,128 fp32 gradients beside the Sum one, in turns; (b)
   phase 5's model, each rank on its own batch, 5 steps under
   ``DistributedOptimizer(AdamW, op=Adasum)`` and 5 of
   ``allreduce_gradients(op=Adasum)`` + AdamW: the loss falls, the
   ranks' parameters bitwise equal after each step, every kernel at
   phase 5's count; step times in turns with ``op=Average``; (c)
   ``elastic.run`` with ``HVD_TPU_CKPT_DIR`` (in ``smoke_scratch/``,
   removed after) every 2 steps, stopped after 5, then a new model,
   optimizer and manager resumed from step 4 and trained to 6 against an
   uninterrupted 6-step run (bitwise where two uninterrupted runs are);
   commit, write and restore times and bytes; (d) phase 7's ResNet-50
   step fed by ``BatchIterator`` + ``prefetch_to_device``, by the
   iterator without prefetch and from a resident batch, in turns
   (images/s per GPU); the prefetched batches equal the host's;
12. the launcher at ``min(cards, 4)`` ranks (one launched rank at one
   card): (a) ``python -m horovod_tpu_torch.run -np W --output-filename
   chiprun_out/launcher/train python chip_smoke.py --rank-of
   launcher_train 8`` trains phase 5's main path (each rank its own
   batch) for 5 steps: every kernel at its count a step, the loss
   finite and falling, the parameters bitwise the same on every rank,
   exit code 0; prints the time from the launcher's start to every
   rank's ``hvd.init()`` returning, the median step beside phase 5's,
   and the negotiation time a cycle with its HMAC share beside phase
   6's; (b) ``run(fn, np=W)``: each rank's ``hvd.init()`` and an
   allreduce on the card, the results in rank order, HMAC-checked; (c)
   the last rank of a ``-np W`` job exits with 3 after ``init``: the
   launcher returns 3 naming it, and no worker is alive after the grace
   window; (d) the last rank with another ``HVD_SECRET_KEY``:
   ``broadcast_object`` fails on the others with the HMAC error and
   unpickles nothing (at one card two ranks share the card here: the
   coordinator refuses the last rank's frames, no NCCL collective
   runs);
13. the coordinated control plane at ``min(cards, 4)`` ranks, each job
   through ``python -m horovod_tpu_torch.run`` with heartbeats every
   0.25 s, liveness 2 s and the abort deadline 10 s: (a) phase 5's main
   path under ``DistributedOptimizer`` with ``rank{W-1}:allreduce:K:crash``
   landing in the first gradient bucket of step 8, and an
   ``elastic.State`` commit after steps 7 on: every survivor's host,
   waiting in ``loss.item()`` on the NCCL collective the dead rank left
   hanging, is released by the communicator abort, and its next
   ``DistributedOptimizer`` call or its commit raises
   ``HvdAbortedError(origin=W-1)`` within the deadline; step 7's commit
   is the last one accepted; the launcher exits non-zero naming rank W-1
   and no rank is alive after it; (b) a plane allreduce
   that the last rank drops, under a 2 s stall shutdown: every rank, the
   dropper included, raises the typed error naming it; (c) rank 0's
   ``hvd.abort()`` while the others wait in a plane allreduce of 2^26
   fp32: every rank raises naming 0; (d) ROADMAP C.7's order (rank 0 a
   plane op and then a step, the others the other way round) under the
   stall shutdown: a typed abort on every rank.  Prints each rank's
   seconds from the crash, the drop or the abort to its error, the
   steps before the crash and their median after the first beside phase
   5's, and the heartbeats' round trip.  At one card NCCL takes no two ranks of a communicator on it:
   (b) and (c) run at two ranks on the CPU, which the phase says, and
   (a) and (d) are skipped with a line saying so;
14. elastic membership at ``min(cards, 4)`` ranks, each job through
   ``python -m horovod_tpu_torch.run --elastic`` with phase 13's
   windows, every rank running ``elastic.run`` over an ``elastic.State``
   committed every step (phase 5's model, every rank the same batch a
   step, and the JAX elastic test's integer schedule on the eager
   plane): (a) the last rank crashes in the first gradient bucket of
   step 4; the survivors re-form at W-1, roll back and finish, bitwise
   equal to each other and with the integer schedule exact, against an
   uninterrupted run at W-1 on their cards (the largest gap printed);
   each survivor's seconds from the crash to its directive, of teardown,
   rendezvous, restore and sync, and its first and steady steps; (b)-(d)
   at 2 layers: (b) a late joiner on the last card takes the place of
   the crashed worker W-2, its synced parameters bitwise the
   incumbents'; (c) a drain (the ``preempt`` action's SIGTERM): that
   rank's ``run`` returns ``DRAINED``, its checkpoint writer flushed, no
   ``HvdAbortedError`` anywhere; (d) rank 0's crash under
   ``--coord-failover``: worker 1 becomes rank 0 with the coordinator,
   the launcher exits 0; without it, a typed abort everywhere and exit
   1 naming rank 0.  At one card the four jobs run at four ranks on the
   CPU (gloo), the integer schedule only, which the phase says;
15. the cluster layer: (a) ``TorchEstimator(model_factory=<phase 5's
   transformer>, loss=lm_loss)`` through ``InProcessBackend`` on this
   card, 10 SGD steps of 8 rows (phase 5's batch, over and over) from a
   ``LocalStore``, ``validation=0.125``: the loss finite and falling,
   ``val_loss`` finite, the fitted ``TorchModel``'s logits on the card
   bitwise the trained rank's (it is rank 0's checkpoint, loaded with
   ``map_location`` the card), every kernel's launches 10 steps' plus
   the validation forward's; the fit's seconds (materialize, the
   backend's run: the model's build, rank 0's parameters, the steps,
   rank 0's checkpoint, validation; the reload), and its step in turns
   with phase 5's; (b) the same fit through ``ProcessBackend`` at
   ``min(cards, 4)`` ranks, a rank a card: each rank on its own card,
   the parameters bitwise equal on every rank, the metrics equal, the
   launch to every rank's start; (c) ``spark/runner.py``'s task function
   in ``min(cards, 4)`` processes against a rendezvous the phase hosts,
   as Spark executors on one host run it (this machine has no pyspark):
   local ranks 0..n-1, one card each, an exact allreduce; (d) NIC
   discovery with two task servers started as processes here: the
   interfaces and the seconds.  At one card (b) and (c) run two gloo
   ranks on the CPU at a small shape, which the phase says;
16. the timeline, the hierarchical collectives and autotune: (a) phase
   5's LM at ``min(cards, 4)`` ranks through ``python -m
   horovod_tpu_torch.run --timeline-filename chiprun_out/p16/trace/
   timeline.json --timeline-mark-cycles``, twice from one seed under
   ``DistributedOptimizer(AdamW)``, a step with the timeline and a step
   without in turns: the losses and parameters bitwise equal, and
   bitwise the same on every rank; rank 0's merged trace parses, holds
   every rank's rows, and every bucket has one balanced ``ALLREDUCE``
   span a step on every rank; prints both steps and, a rank, the bucket
   spans' time in a step and how much of it lies before the card ended
   the backward (ROADMAP B.9); (b) the plane's ``grouped_allreduce`` of
   fp32 gradients of phase 5's shapes, an int32 allreduce and an
   allgather of uneven first dimensions under
   ``HVD_HIERARCHICAL_ALLREDUCE=1 HVD_HIERARCHICAL_ALLGATHER=1
   HVD_HIER_LOCAL_SIZE=2`` at four ranks, hierarchical and flat in
   turns: floats within rtol 1e-4 of flat, integers and the gather
   exact, every rank the same bytes; (c) ``HVD_AUTOTUNE=1`` (warm-up 1,
   steady 1, 4 samples a categorical, ``HVD_HIER_LOCAL_SIZE=2``) on
   phase 5's LM at four ranks whose gradients go through the plane: every
   rank applied the same tuned sets at the same cycles and holds the
   same final values, the walk pinned, rank 0's CSV has a row a sample;
   prints the pinned values and the step and negotiation before and
   after pinning.  At fewer than four cards (b) and (c) run four gloo
   ranks on the CPU at phase 15's small width, which the phase says;
17. the session layer at ``min(cards, 4)`` ranks, each job through
   ``python -m horovod_tpu_torch.run`` with phase 13's windows, each
   rank running phase 5's main path under ``DistributedOptimizer`` with
   a plane ``allgather`` of every rank's loss a step: (a) under
   ``--reconnect-budget 5``, a job without a fault and one with
   ``rank{W-1}:allgather:4:blip:1000`` (the last rank's coordinator link
   cut mid-frame in step 4 and refusing connects for 1 s): both finish,
   the loss falls, every kernel at its count a step, and every rank's
   parameters and losses are bitwise the unblipped run's; prints the
   time the cut allgather took, the frames replayed and step 4 beside
   the others' median; (b) ``rank{W-1}:allgather:4:reset:1.0:4`` under
   ``--reconnect-budget 1``: the last rank's heal runs out and it raises
   the typed abort naming the coordinator, every other rank raises it
   naming the last rank, no worker is left; prints the seconds from the
   reset to each rank's error.  At one card a world of one has no
   control plane: both run at two ranks on the CPU at phase 15's small
   width, which the phase says;
18. the framework bindings' host bridge at ``min(cards, 4)`` ranks, one
   job through ``python -m horovod_tpu_torch.run`` with phase 13's
   windows, over the MXNet binding and the repo's numpy MXNet stand-in
   (``tests/_mxnet_shim``: the machine has no MXNet, TensorFlow or
   Keras): each rank builds phase 5's LM on its card, runs one forward
   and backward on its own batch and copies the 69 parameters and
   gradients (169,904,128 values) to the host in fp32 as NDArrays;
   (a) ``DistributedOptimizer(SGD(1e-2))`` (``update`` per index for
   half of them, the tuple index for the rest) and (b)
   ``DistributedTrainer`` over gluon Parameters, one step each: every
   rank's host parameters bitwise the same and within rtol 1e-6 (plus
   1e-5 of the tensor's largest update) of the card's
   ``hvd.DistributedOptimizer(SGD(1e-2))`` step on the same gradients;
   (c) ``broadcast_parameters`` of the 69 from the last rank: every rank
   holds its bytes; (d) the binding's exchange of the gradients (every
   one submitted, then waited for) split into host->card, the plane and
   card->host by the bridge's counters, beside the same one tensor at a
   time and the plane's ``grouped_allreduce`` of the gradients on the
   card, in turns, median of 5.  At one card a world of one exchanges
   nothing: (a)-(c) run at two ranks on the CPU at phase 15's small
   width, beside this process on the card at one rank, whose (d) waits
   for them, which the phase says.

Phases 6 and 8-11 (12-14 and 16-18 through its CLI) start their ranks
above one card through the port's
launcher (``run/launch.py::launch_job``, a rendezvous KV server and a
job key of their own; rank logs under ``chiprun_out/ranks/<phase>``);
their eager plane negotiates through rank 0's coordinator, and phase 6
prints the negotiation's median and 10th-90th percentiles and the
heartbeats' round trip and share of the phase.
Some jobs of a phase run side by side, each waited for in a thread of
this process: phase 12's (c) and (d) and phase 13's (b) and (c); at one
card the CPU jobs of phases 14 (all six), 16 ((b), (c)) and 17 (all
three); on the cards phase 14's (b)-(d) after (a), and phase 17's (b)
beside (a)'s run without a fault. The times those jobs print are then
taken beside each other.
Each phase's wall seconds are printed on a line of its own.

Prints one ``{"kernels": [...]}`` line (each kernel's ``launches`` in
phase 5's run, and ``launches_by_path``: phase 5's, phase 10's tp, MoE
and pipeline runs', phase 11's ``op=Adasum`` run's, phase 12's
launched run's and, above one card, phase 13 (a)'s before and at its
crash and phase 14 (a)'s over both epochs, phase 15 (a)'s fit and,
above one card, (b)'s rank 0 up to its validation loss, phase 16 (a)'s
rank 0 and, at four cards, (c)'s rank 0, above one card phase 17
(a)'s blipped run's rank 0, and phase 18's forward and backward on the
card's rank 0, each of which must be above 0), the
``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that last line.  ``--profile`` adds one profiled step of phase 5, one of
ResNet-50, one of phase 9's zigzag transformer and one of each of phase
10's training runs on each rank.
"""

import argparse
import contextlib
import functools
import json
import math
import os
import shlex
import statistics
import subprocess
import sys
import time

# wall-clock time at which this process had its interpreter and this
# module (standard library only) loaded: phase 12's ranks report it
T_PROCESS = time.time()
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12     # H100 SXM dense bf16 on the tensor cores

N_ROWS, D_MODEL, VOCAB = 8 * 2048, 1024, 32768
LAYERS, STEPS = 8, 5   # full depth of the main path; a few steps
# ResNet-50's warm-up steps and its timed window (bench.py's
# BENCH_WARMUP and BENCH_ITERS defaults)
CNN_WARMUP, CNN_STEPS = 3, 20
# phase 7: (batch per GPU, image side) of each CNN at full width
CNN_SIZES = {"resnet50": (64, 224), "vgg16": (16, 224),
             "inception_v3": (16, 299)}
# attention of the main path: batch, seq, heads, head dim
ATTN_B, ATTN_T, ATTN_H, ATTN_D = 8, 2048, D_MODEL // 128, 128
MAIN_BATCH, MAIN_SEQ = ATTN_B, ATTN_T   # the main path's batch per GPU


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
    # kernel and library call in turns, as the others
    ms, library_ms = time_in_turns(
        lambda: sx.softmax_xent_fwd(logits, labels, True),
        lambda: F.cross_entropy(logits, labels64, reduction="none"))
    kernels.append(rates(dict(
        name="softmax_xent_fwd", route="cuda",
        source="horovod_tpu_torch/csrc/softmax_xent.cu",
        replaces="horovod_tpu/ops/pallas/softmax_xent.py:37",
        max_abs_err=max(max_err(loss, p_loss), max_err(lse, p_lse)),
        ms=ms,
        plain_ms=time_ms(lambda: sx.softmax_xent_fwd_plain(logits, labels),
                         iters=5),
        bound_ms=t_b, bound_by=by, library_ms=library_ms), ops))

    dloss = torch.full((n,), 1.0 / n, device=dev)
    dlogits = sx.softmax_xent_bwd(logits, labels, lse, dloss)
    p_dlogits = sx.softmax_xent_bwd_plain(logits, labels, lse, dloss)
    torch.cuda.synchronize()
    check_dlogits("softmax_xent_bwd", dlogits, p_dlogits, labels, dloss)
    lg = logits.detach().requires_grad_(True)
    lib_loss = F.cross_entropy(lg, labels64)
    t_b, by = bound(2 * n * v * 2 + n * 4 * 3, ops)
    # in turns with the backward of F.cross_entropy's own graph
    ms, library_ms = time_in_turns(
        lambda: sx.softmax_xent_bwd(logits, labels, lse, dloss),
        lambda: torch.autograd.grad(lib_loss, lg, retain_graph=True))
    kernels.append(rates(dict(
        name="softmax_xent_bwd", route="cuda",
        source="horovod_tpu_torch/csrc/softmax_xent.cu",
        replaces="horovod_tpu/ops/pallas/softmax_xent.py:64",
        max_abs_err=max_err(dlogits, p_dlogits),
        ms=ms,
        plain_ms=time_ms(
            lambda: sx.softmax_xent_bwd_plain(logits, labels, lse, dloss),
            iters=5),
        bound_ms=t_b, bound_by=by, library_ms=library_ms), ops))
    del logits, dlogits, p_dlogits, lg, lib_loss
    kernels += check_flash()
    check_flash_ragged()
    check_flash_wide()
    check_flash_split()
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


def check_flash_wide():
    """Phase 3, the head dims and head counts the ``wgmma`` kernels do not
    take, which run the generic kernels: D = 24, 40, 192 and 256 in fp32
    and bf16, causal and not ([2, 160, 3, D] against [2, 96, 3, D] keys
    when causal, else T = 130), and B*H = 65536 at T = 16 (D = 16: bf16
    on the wgmma kernels; D = 24).  Tolerances as in
    ``check_flash_ragged``.  Then the times of the D = 192 and 256
    instances at ``[4, 1024, 8, D]`` bf16 and fp32, causal (mean of 10
    calls)."""
    import torch

    from horovod_tpu_torch.ops.cuda import flash_attention as fa

    for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for d in (24, 40, 192, 256):
            for causal in (True, False):
                tq, tkv = (160, 96) if causal else (130, 130)
                q, k, v, do = flash_inputs(dtype, 2, tq, tkv, 3, d, seed=d)
                tag = f"D {d} T_q {tq} T_kv {tkv} causal {causal} {dtype}"
                errs, _, _ = run_flash(q, k, v, do, causal, d ** -0.5, rel,
                                       tag)
                print(f"flash wide {tag}: max abs err {errs}", flush=True)
        for d in (16, 24):
            q, k, v, do = flash_inputs(dtype, 256, 16, 16, 256, d, seed=d)
            tag = f"B*H 65536 T 16 D {d} {dtype}"
            errs, _, _ = run_flash(q, k, v, do, True, 0.25, rel, tag)
            print(f"flash heads {tag}: max abs err {errs}", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for d in (192, 256):
            q, k, v, do = flash_inputs(dtype, 4, 1024, 1024, 8, d, seed=d)
            out, lse = fa.flash_attention_fwd(q, k, v, True, d ** -0.5)
            delta = (do.float() * out.float()).sum(-1).transpose(
                1, 2).contiguous()
            args = (q, k, v, do, lse, delta, True, d ** -0.5)
            ms = [time_ms(lambda: fa.flash_attention_fwd(q, k, v, True,
                                                         d ** -0.5), 10),
                  time_ms(lambda: fa.flash_attention_bwd_dq(*args), 10),
                  time_ms(lambda: fa.flash_attention_bwd_dkv(*args), 10)]
            print(f"flash wide time [4, 1024, 8, {d}] {dtype} causal: fwd "
                  f"{ms[0]:.4f} ms, dq {ms[1]:.4f} ms, dkv {ms[2]:.4f} ms",
                  flush=True)


def check_flash_split():
    """Phase 3, the column split above D = 256 (a block a 256-column
    window of the output, each summing the scores over all of D): D = 320
    and 512 in fp32 and bf16, causal, at ``[2, 2048, 8, D]`` (B*H = 16)
    and at a ragged ``[2, 1000, 8, D]``, tolerances as in
    ``check_flash_ragged``.  Then the times of the D = 256 instance and
    the D = 512 split at ``[2, 2048, 8, D]`` causal (mean of 10 calls),
    with the factor of redundant score work: every z-block of D = 512
    recomputes S (and dP), ceil(D / 256) = 2 times the score products of
    one pass."""
    import torch

    from horovod_tpu_torch.ops.cuda import flash_attention as fa

    for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for d in (320, 512):
            for t in (2048, 1000):
                q, k, v, do = flash_inputs(dtype, 2, t, t, 8, d, seed=d + t)
                tag = f"D {d} [2, {t}, 8, {d}] causal {dtype}"
                errs, _, _ = run_flash(q, k, v, do, True, d ** -0.5, rel,
                                       tag)
                print(f"flash split {tag}: max abs err {errs}", flush=True)
                del q, k, v, do
    for dtype in (torch.bfloat16, torch.float32):
        times = {}
        for d in (256, 512):
            q, k, v, do = flash_inputs(dtype, 2, 2048, 2048, 8, d, seed=d)
            out, lse = fa.flash_attention_fwd(q, k, v, True, d ** -0.5)
            delta = (do.float() * out.float()).sum(-1).transpose(
                1, 2).contiguous()
            args = (q, k, v, do, lse, delta, True, d ** -0.5)
            times[d] = [
                time_ms(lambda: fa.flash_attention_fwd(q, k, v, True,
                                                       d ** -0.5), 10),
                time_ms(lambda: fa.flash_attention_bwd_dq(*args), 10),
                time_ms(lambda: fa.flash_attention_bwd_dkv(*args), 10)]
        z = -(-512 // fa.SPLIT_D)
        # products of one pass (fwd: S, PV; dq: S, dP, dQ; dk/dv: S, dP,
        # dV, dK) against the split's, whose z-blocks each redo S and dP
        work = [(2 * z + 2) / 4, (4 * z + 2) / 6, (4 * z + 4) / 8]
        for i, what in enumerate(("fwd", "dq", "dkv")):
            print(f"flash split time [2, 2048, 8, D] {dtype} causal {what}: "
                  f"D 256 {times[256][i]:.4f} ms, D 512 {times[512][i]:.4f}"
                  f" ms ({times[512][i] / times[256][i]:.2f}x; {z} "
                  f"z-blocks, score work x{z}, products x{work[i]:.2f} of "
                  f"one pass at D 512)", flush=True)


def check_models():
    """Phase 4: the small transformer, then two layers with two heads of
    512 (d_model 1024: the column-split flash kernels)."""
    check_small_model()
    check_small_model("wide-head model", d_model=1024, n_heads=2, d_ff=2048)


def check_small_model(what="small model", d_model=64, n_heads=4, d_ff=128):
    """Phase 4: the kernels inside the model agree with the plain path.
    The CPU side takes one forward and backward before the compared one:
    on the card's host a process's first fp32 forward on the CPU now and
    then comes out other than its later ones, while the card's is the
    same in every process (ROADMAP C.10); the gap is printed."""
    import numpy as np
    import torch

    from horovod_tpu_torch.models import Transformer, TransformerConfig, \
        lm_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig(vocab_size=512, n_layers=2, d_model=d_model,
                            n_heads=n_heads, d_ff=d_ff, max_len=32,
                            dtype=torch.float32)
    tokens = torch.from_numpy(
        np.random.RandomState(1).randint(0, 512, (2, 32)))
    results, layers = {}, {}
    for device in ("cpu", "cuda"):
        model = Transformer(cfg, device=device, seed=3)
        # each module's input and output, for the report of a failure
        # (ROADMAP C.10)
        outs = layers[device] = {}
        for name, mod in model.named_modules():
            if name:
                mod.register_forward_hook(
                    lambda m, i, o, name=name, outs=outs: outs.__setitem__(
                        name, [x.detach().cpu() if torch.is_tensor(x)
                               else None for x in (i[0], o)]))
        tok = tokens.to(device)
        if device == "cpu":
            first = model(tok)
            lm_loss(first, tok).backward()
            model.zero_grad(set_to_none=True)
        logits = model(tok)
        loss = lm_loss(logits, tok)
        loss.backward()
        results[device] = (logits.detach().cpu(), loss.detach().cpu(),
                           {k: p.grad.cpu()
                            for k, p in model.named_parameters()})
    (lc, sc, gc), (lg, sg, gg) = results["cpu"], results["cuda"]
    first_gap = max_err(first.detach(), lc)
    # fp32 on both sides; tolerance of the CPU parity tests
    try:
        assert_close(f"{what} logits", lg, lc, 1e-4, 1e-5)
    except AssertionError:
        for name, want in layers["cpu"].items():
            errs = [f"{what} {max_err(g, w):.3e}" for what, g, w in zip(
                ("input", "output"), layers["cuda"][name], want)
                if g is not None and w is not None]
            print(f"{what} layer {name}: max abs err card against CPU "
                  f"{', '.join(errs)}", flush=True)
        raise
    assert_close(f"{what} loss", sg, sc, 1e-5, 1e-5)
    for k in gc:
        assert_close(f"{what} grad {k}", gg[k], gc[k], 1e-3, 1e-5)
    print(f"{what}: loss cuda {float(sg):.6f} cpu {float(sc):.6f}; "
          f"the CPU's first forward {first_gap:.3e} from its second",
          flush=True)


def train(layers, steps, smi, profile=False):
    """Phase 5: the data-parallel training step at full width.  With
    ``profile``, one more step runs under ``torch.profiler`` after the
    counted ones and its device time by operator is written to
    ``chiprun_out/profile_step.txt``."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics as hvd_basics
    from horovod_tpu_torch.models import Transformer, TransformerConfig
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
        buckets = len(opt._buckets)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        tokens = torch.from_numpy(np.random.RandomState(0).randint(
            0, VOCAB, (batch, seq))).to(hvd.device())
        print(f"train: depth {layers} layers (full: 8), {n_params} "
              f"parameters, batch {batch} x seq {seq}; eager plane "
              f"running: {hvd_basics._get_state().controller.is_running()}",
              flush=True)

        kernels.reset_launch_counts()
        logits, losses, times = _timed_steps(model, opt, tokens, steps)
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
    expect_launches("train", counts, per_step_launches(layers), steps)
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
                    "layers": layers, "params": n_params,
                    "buckets": buckets}


def _timed_steps(model, opt, tokens, steps):
    """``steps`` training steps; -> (the last logits, the losses, each
    step's seconds on the host clock, the card synchronised around it)."""
    import torch

    from horovod_tpu_torch.models import lm_loss

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
    return logits, losses, times


# Phase 6 tolerances against the same function in torch ops on the card:
# fp32 sums in another order; bf16 and fp16 one rounding of each partial
# sum (the ring's order, not torch's); integers exactly.  Each relative to
# the tensor's largest entry as an absolute floor too, for sums that
# cancel.
EAGER_TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 4e-3,
             "int32": 0}


def eager_checks(layers):
    """Phase 6 on this rank, ``hvd.init()`` done: every eager collective
    on tensors on the card against the same function in torch ops (each
    rank makes every rank's inputs from seeds), a stream-ordering check,
    then ``grouped_allreduce`` of the full-width model's gradients (fp32,
    the shapes of phase 5's parameters, values from seeds) against
    ``allreduce_gradients``: bitwise at one rank, within fp32 rounding
    above.  -> the rank's numbers."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import mpi_ops
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.ops_enum import reduce_scatter_split_sizes
    from horovod_tpu_torch.models import Transformer, TransformerConfig

    t_phase = time.perf_counter()
    dev, r, n = hvd.device(), hvd.rank(), hvd.size()
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16, "int32": torch.int32}
    checked = []

    def every(shape_of, dtype, seed):
        """Every rank's input: rank q's from seed and q."""
        out = []
        for q in range(n):
            gen = torch.Generator(device=dev).manual_seed(seed * 1009 + q)
            shape = shape_of(q) if callable(shape_of) else shape_of
            if dtype == torch.int32:
                out.append(torch.randint(-1000, 1000, shape, generator=gen,
                                         device=dev, dtype=dtype))
            else:
                out.append(torch.randn(shape, generator=gen,
                                       device=dev).to(dtype))
        return out

    def reduced(xs, average, pre=1.0, post=1.0):
        """The plane's arithmetic in torch ops: prescale in the dtype, the
        sum, the average and the postscale in the dtype; integers summed
        exactly and scaled once in float64, truncated."""
        dtype = xs[0].dtype
        if dtype.is_floating_point:
            s = torch.stack([x * pre if pre != 1.0 else x
                             for x in xs]).float().sum(0).to(dtype)
            if average:
                s = s / n
            return s * post if post != 1.0 else s
        s = torch.stack(xs).long().sum(0)
        factor = pre * post / (n if average else 1)
        return (s.double() * factor if factor != 1.0 else s).to(dtype)

    def expect(what, got, want):
        torch.cuda.synchronize()
        tol = EAGER_TOL[str(want.dtype).replace("torch.", "")]
        same = (got.dtype == want.dtype and got.shape == want.shape
                and got.device == want.device)
        if same and tol == 0:
            same = torch.equal(got, want)
        elif same:
            scale = max([1.0] + [float(want.float().abs().max())]
                        * (want.numel() > 0))
            same = torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol * scale)
        if not same:
            raise AssertionError(
                f"eager {what} on rank {r}: got {got.dtype} "
                f"{tuple(got.shape)} on {got.device}, want {want.dtype} "
                f"{tuple(want.shape)}"
                + (f", max abs err {max_err(got, want):.3e}"
                   if got.shape == want.shape else ""))
        checked.append(what)

    splits = [d + 1 for d in range(n)]
    rows = 2 * n + 1
    counts = reduce_scatter_split_sizes(rows, n)
    for name, dtype in dtypes.items():
        xs = every((257, 33), dtype, 1)
        expect(f"allreduce average {name}",
               hvd.allreduce(xs[r], name=f"p6.avg.{name}"), reduced(xs, True))
        expect(f"allreduce sum {name}",
               hvd.allreduce(xs[r], op=hvd.Sum, name=f"p6.sum.{name}"),
               reduced(xs, False))
        expect(f"allreduce scaled {name}",
               hvd.allreduce(xs[r], op=hvd.Average, prescale_factor=0.5,
                             postscale_factor=3.0, name=f"p6.scaled.{name}"),
               reduced(xs, True, 0.5, 3.0))
        ys = every(lambda q: (q + 1, 5), dtype, 2)
        expect(f"allgather {name}", hvd.allgather(ys[r], name=f"p6.ag.{name}"),
               torch.cat(ys))
        expect(f"broadcast {name}",
               hvd.broadcast(xs[r], root_rank=n - 1, name=f"p6.bc.{name}"),
               xs[n - 1])
        zs = every((sum(splits), 4), dtype, 3)
        got, recv = hvd.synchronize(hvd.alltoall_async(
            zs[r], splits=torch.tensor(splits), name=f"p6.a2a.{name}"))
        recv = recv.tolist()
        off = sum(splits[:r])
        expect(f"alltoall {name}", got,
               torch.cat([z[off:off + splits[r]] for z in zs]))
        if list(recv) != [splits[r]] * n:
            raise AssertionError(f"alltoall {name}: received splits {recv}")
        ws = every((rows, 3), dtype, 4)
        off = sum(counts[:r])
        expect(f"reduce_scatter {name}",
               hvd.reduce_scatter(ws[r], name=f"p6.rs.{name}"),
               reduced(ws, True)[off:off + counts[r]])

    gs = [every((100 + 7 * i,), dt, 10 + i)
          for i, dt in enumerate(dtypes.values())]
    outs = hvd.grouped_allreduce([g[r] for g in gs], op=hvd.Sum,
                                 name="p6.grouped")
    for name, g, o in zip(dtypes, gs, outs):
        expect(f"grouped_allreduce {name}", o, reduced(g, False))
    # the in-place variants of mpi_ops write into the caller's tensors
    xs = every((64, 3), torch.float32, 5)
    t = xs[r].clone()
    if mpi_ops.allreduce_(t, name="p6.ar_") is not t:
        raise AssertionError("allreduce_ returned another tensor")
    expect("mpi_ops allreduce_", t, reduced(xs, True))
    t = xs[r].clone()
    mpi_ops.broadcast_(t, 0, name="p6.bc_")
    expect("mpi_ops broadcast_", t, xs[0])
    ts = [g[r].clone() for g in gs]
    mpi_ops.grouped_allreduce_(ts, op=hvd.Sum, name="p6.grouped_")
    for name, g, t in zip(dtypes, gs, ts):
        expect(f"mpi_ops grouped_allreduce_ {name}", t, reduced(g, False))

    # join: the first half of the ranks stops after one step; the others'
    # second step sums without them; the last to join is one of the others
    for i in range(1 if r < n // 2 else 2):
        doers = [q for q in range(n) if i < (1 if q < n // 2 else 2)]
        expect(f"join step {i}", hvd.allreduce(
            torch.full((4,), float(r + 1), device=dev), op=hvd.Sum,
            name=f"p6.join.{i}"),
            torch.full((4,), float(sum(q + 1 for q in doers)), device=dev))
    last = hvd.join()
    if not n // 2 <= last < n:
        raise AssertionError(f"join returned {last}")
    hvd.barrier(name="p6.barrier")
    obj = hvd.broadcast_object({"from": r, "xs": list(range(1000))}
                               if r == 0 else None, root_rank=0)
    if obj != {"from": 0, "xs": list(range(1000))}:
        raise AssertionError("broadcast_object")

    # stream order: the tensor is submitted while 128 kernels queued on
    # the current stream are still writing it (about 5 ms of work)
    big = torch.zeros(1 << 24, device=dev)
    for _ in range(128):
        big.add_(1.0)
    got = hvd.synchronize(hvd.allreduce_async(big, op=hvd.Sum,
                                              name="p6.stream"))
    expect("stream order", got, torch.full_like(big, 128.0 * n))
    del big, got

    cfg = TransformerConfig(vocab_size=VOCAB, n_layers=layers,
                            d_model=D_MODEL, n_heads=D_MODEL // 128,
                            d_ff=4 * D_MODEL, max_len=2048,
                            dtype=torch.bfloat16)
    shapes = [p.shape for p in
              Transformer(cfg, device=dev, seed=0).parameters()]
    gen = torch.Generator(device=dev).manual_seed(100 + r)
    grads = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    nbytes = sum(g.numel() * g.element_size() for g in grads)
    want = hvd.allreduce_gradients(grads)
    got = hvd.grouped_allreduce(grads, name="p6.grads")
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        if n == 1 and not torch.equal(a, b):
            raise AssertionError(f"gradient {i}: eager and direct differ")
        scale = float(b.abs().max())
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-6 * scale):
            raise AssertionError(f"gradient {i}: eager and direct differ "
                                 f"beyond fp32 rounding")
    checked.append("grouped_allreduce of the full-width gradients")
    int8_checked, int8_res = int8_checks(grads)
    checked += int8_checked

    def timed(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    del got, want
    eager_ms = timed(lambda: hvd.grouped_allreduce(grads, name="p6.grads"))
    direct_ms = timed(lambda: hvd.allreduce_gradients(grads))
    controller = basics._get_state().controller
    res = {"rank": r, "world": n,
           "params": sum(g.numel() for g in grads), "bytes": nbytes,
           "eager_ms": eager_ms, "eager_gb_s": nbytes / eager_ms / 1e6,
           "direct_ms": direct_ms, "direct_gb_s": nbytes / direct_ms / 1e6,
           "negotiation_ms_median": 1e3 * statistics.median(
               controller.negotiation_times()),
           # the spread: 10th and 90th percentiles
           "negotiation_ms_p10_p90": [1e3 * q for q in _deciles(
               controller.negotiation_times())],
           "cycles": len(controller.negotiation_times()),
           # the control plane's heartbeats over the phase: round trips
           # and the share of the phase's wall time the thread spent in
           # them (none at one rank)
           **_heartbeat_stats(time.perf_counter() - t_phase),
           # each exchange's signing and checking (none at one rank)
           "hmac_ms_median": (1e3 * statistics.median(
               controller.hmac_times()) if controller.hmac_times()
               else None),
           "cache_hits": controller.cache_hits, **int8_res}
    del grads
    checked += sync_batch_norm_under_optimizer()
    res["checks"] = len(checked)
    res.update(step_with_and_without_plane(layers))
    return res


def _rank_max(t):
    """The elementwise max of ``t`` over the ranks (the default group,
    after the eager plane has issued what this rank submitted)."""
    import torch.distributed as dist

    from horovod_tpu_torch.common import basics

    basics._get_state().controller.drain()
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def _fused_buffers(tensors):
    """Index lists of the fused buffers the eager plane reduces a
    ``grouped_allreduce`` of ``tensors`` (one dtype, submitted in one
    cycle) in: its greedy in-order plan up to the fusion threshold."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.fusion import plan_buckets

    return list(plan_buckets(
        range(len(tensors)), key_fn=lambda i: 0,
        nbytes_fn=lambda i: tensors[i].numel() * tensors[i].element_size(),
        threshold=basics._get_state().controller._threshold))


def _block_scaled(t, block):
    """``t`` with its ``block``-element blocks scaled by 1, 10^-0.5, ...,
    10^-3 in turn, as gradients differ in size from block to block: a
    quantizer with one scale for many blocks then errs beyond the
    per-block bound in the small ones."""
    import torch

    flat = t.reshape(-1)
    steps = torch.arange(flat.numel(), device=t.device) // block % 7
    return (flat * torch.pow(10.0, -0.5 * steps.float())).view(t.shape)


def _block_max(t, block):
    """Each 256-block's largest magnitude of ``t`` flattened, padded."""
    import torch.nn.functional as F

    flat = t.reshape(-1).float().abs()
    return F.pad(flat, (0, -flat.numel() % block)).view(-1, block).amax(1)


def _within_int8_bound(what, got, exact, blockmax, n):
    """``|got - exact| <= (n + 1) * blockmax / 254`` elementwise
    (``horovod_tpu/common/compression.py:88-90``), ``blockmax`` one value
    per 256-block of the flattened tensors; -> the largest error."""
    import torch

    err = (got.float() - exact.float()).reshape(-1).abs()
    bound = (n + 1) * blockmax.repeat_interleave(256)[:err.numel()] / 254
    worst = float((err - bound * (1 + 1e-5) - 1e-30).max())
    if worst > 0:
        raise AssertionError(f"int8 {what}: an error {worst:.3e} above the "
                             f"bound (n + 1) * blockmax / 254")
    return float(err.max()) if err.numel() else 0.0


def int8_checks(grads, pairs=3):
    """Phase 6's int8 cases on this rank, each rank with values of its
    own: ``grouped_allreduce(compression="int8")`` and
    ``allreduce_gradients(compression=Compression.int8)`` (the optimizer's
    per-gradient path) of the full-width gradients, ``reduce_scatter``
    with int8 and three steps of ``DistributedOptimizer(...,
    compression=Compression.int8)``, each held to the fp32 result within
    the reference's bound ``(n + 1) * blockmax / 254``, ``blockmax`` the
    largest magnitude of the element's own 256-block.  Above one rank the
    eager plane's int8 path must have run; at one rank it resolves to the
    exact wire (``xla_executor.py:232``) and returns the input's values.
    The optimizer's path quantizes at one rank too, as ``jax_api`` does.
    -> (the names of the checks, the numbers: both full-width paths'
    int8 and fp32 times in turns, wire bytes, the per-gradient path's
    memory beyond its inputs)."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.compression import INT8_BLOCK, \
        int8_wire_bytes
    from horovod_tpu_torch.common.ops_enum import reduce_scatter_split_sizes

    dev, r, n = hvd.device(), hvd.rank(), hvd.size()
    wires = basics._get_state().controller._executor.wires
    checked = []
    grads = [_block_scaled(g, INT8_BLOCK) for g in grads]

    def expect_int8_ran(what, before):
        ran = wires["int8"] - before
        if (n > 1) != (ran > 0):
            raise AssertionError(f"int8 {what}: {ran} int8 reductions at "
                                 f"{n} rank(s)")

    # the gradients: the plane quantizes each fused buffer from its
    # start, so each element is held to the largest magnitude of its own
    # 256-block of that buffer (over the ranks' inputs and the exact sum)
    exact = hvd.grouped_allreduce(grads, op=hvd.Sum, name="p6.q.exact")
    before = wires["int8"]
    got = hvd.grouped_allreduce(grads, op=hvd.Sum, name="p6.q.grads",
                                compression="int8")
    torch.cuda.synchronize()
    expect_int8_ran("grouped_allreduce", before)
    if n == 1 and not all(torch.equal(a, g) for a, g in zip(got, grads)):
        raise AssertionError("int8 at one rank: a gradient changed")
    worst = 0.0
    for idx in _fused_buffers(grads):
        mine, want, out = (torch.cat([ts[i].reshape(-1) for i in idx])
                           for ts in (grads, exact, got))
        blockmax = torch.maximum(_rank_max(_block_max(mine, INT8_BLOCK)),
                                 _block_max(want, INT8_BLOCK))
        worst = max(worst, _within_int8_bound(
            f"fused buffer of gradients {idx[0]}-{idx[-1]}", out, want,
            blockmax, n))
        del mine, want, out
    checked.append("int8 grouped_allreduce of the full-width gradients")
    del got

    # allreduce_gradients, as DistributedOptimizer reduces them: each
    # gradient quantized from its own start (quantized at one rank too)
    exact = hvd.allreduce_gradients(grads, op=hvd.Sum)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = hvd.allreduce_gradients(grads, op=hvd.Sum,
                                  compression=hvd.Compression.int8)
    torch.cuda.synchronize()
    leaf_extra = torch.cuda.max_memory_allocated() - base
    maxima = torch.cat([_block_max(g, INT8_BLOCK) for g in grads])
    blockmax = torch.maximum(_rank_max(maxima), torch.cat(
        [_block_max(e, INT8_BLOCK) for e in exact]))
    leaf_worst, start = 0.0, 0
    for a, b in zip(got, exact):
        blocks = -(-a.numel() // INT8_BLOCK)
        leaf_worst = max(leaf_worst, _within_int8_bound(
            "allreduce_gradients", a, b, blockmax[start:start + blocks], n))
        start += blocks
    if not leaf_worst > 0:
        raise AssertionError("int8 allreduce_gradients: nothing quantized")
    checked.append("int8 allreduce_gradients of the full-width gradients")
    del got, exact

    # reduce_scatter: one tensor, so the blocks are its own
    gen = torch.Generator(device=dev).manual_seed(400 + r)
    x = _block_scaled(torch.randn(8 * n + 3, 1000, generator=gen,
                                  device=dev), INT8_BLOCK)
    counts = reduce_scatter_split_sizes(x.shape[0], n)
    start = sum(counts[:r])
    full = hvd.allreduce(x, op=hvd.Sum, name="p6.q.rs.exact")
    before = wires["int8"]
    rs = hvd.reduce_scatter(x, op=hvd.Sum, name="p6.q.rs",
                            compression="int8")
    expect_int8_ran("reduce_scatter", before)
    if n == 1 and not torch.equal(rs, x):
        raise AssertionError("int8 reduce_scatter at one rank changed x")
    blockmax = torch.maximum(_rank_max(_block_max(x, INT8_BLOCK)),
                             _block_max(full, INT8_BLOCK))
    mine = torch.zeros_like(full)
    mine[start:start + counts[r]] = rs
    keep = torch.zeros_like(full, dtype=torch.bool)
    keep[start:start + counts[r]] = True
    _within_int8_bound("reduce_scatter", torch.where(keep, mine, full),
                       full, blockmax, n)
    checked.append("int8 reduce_scatter")

    # DistributedOptimizer: leaves of 19200, 300 and 3000 elements go
    # through int8 on their own; the bias of 10 passes exactly
    torch.manual_seed(6)
    model = torch.nn.Sequential(torch.nn.Linear(64, 300), torch.nn.ReLU(),
                                torch.nn.Linear(300, 10)).to(dev)
    params = list(model.parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=0.1),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.int8)
    quantized_err = 0.0
    for step in range(3):
        gen = torch.Generator(device=dev).manual_seed(500 + 10 * step + r)
        xb = torch.randn(32, 64, generator=gen, device=dev)
        yb = torch.randn(32, 10, generator=gen, device=dev)
        opt.zero_grad()
        loss = F.mse_loss(model(xb), yb)
        local = torch.autograd.grad(loss, params, retain_graph=True)
        loss.backward()
        opt.synchronize()
        sums = hvd.allreduce_gradients(list(local), op=hvd.Sum)
        for p, g, total in zip(params, local, sums):
            if p.numel() < INT8_BLOCK:
                scale = float(total.abs().max()) / n
                if not torch.allclose(p.grad, total / n, rtol=1e-5,
                                      atol=1e-6 * scale):
                    raise AssertionError("int8 optimizer: a leaf below "
                                         "one block was not exact")
                continue
            blockmax = torch.maximum(_rank_max(_block_max(g, INT8_BLOCK)),
                                     _block_max(total, INT8_BLOCK))
            quantized_err = max(quantized_err, _within_int8_bound(
                "DistributedOptimizer", p.grad * n, total, blockmax, n))
        with opt.skip_synchronize():
            opt.step()
    if not quantized_err > 0:
        raise AssertionError("int8 optimizer: no gradient was quantized")
    checked.append("int8 DistributedOptimizer")

    def grouped(comp):
        hvd.grouped_allreduce(grads, op=hvd.Sum, name="p6.q.time",
                              compression=comp)

    def leaves(comp):
        hvd.allreduce_gradients(grads, op=hvd.Sum, compression={
            "int8": hvd.Compression.int8, "none": hvd.Compression.none}[comp])

    def timed(fn, comp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(comp)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    ms = {}
    for path, fn in (("grouped", grouped), ("leaves", leaves)):
        timed(fn, "int8")
        timed(fn, "none")
        ms[path] = {"int8": [], "none": []}
        for _ in range(pairs):   # in turns: a drift of the host falls on both
            for comp in ("int8", "none", "none", "int8"):
                ms[path][comp].append(timed(fn, comp))
    numel = sum(g.numel() for g in grads)
    return checked, {
        "int8_ms": statistics.median(ms["grouped"]["int8"]),
        "int8_fp32_ms": statistics.median(ms["grouped"]["none"]),
        "int8_wire_bytes": int8_wire_bytes(numel, n),
        "fp32_wire_bytes": 2 * (n - 1) * 4 * numel // n,
        "int8_max_err_grads": worst,
        "int8_leaf_ms": statistics.median(ms["leaves"]["int8"]),
        "int8_leaf_fp32_ms": statistics.median(ms["leaves"]["none"]),
        "int8_leaf_wire_bytes": sum(int8_wire_bytes(g.numel(), n)
                                    for g in grads),
        "int8_leaf_extra_bytes": leaf_extra,
        "int8_max_err_leaves": leaf_worst}


def sync_batch_norm_under_optimizer(steps=3):
    """``SyncBatchNorm`` trained by ``DistributedOptimizer`` (SGD) on each
    rank's 8 rows of a global batch, with an eager allreduce in flight
    through every step: the plane's collectives (the allreduce, the
    statistics' allgather, the backward's allreduce) and the optimizer's
    run on two communicators and must not deadlock.  Held against one
    ``BatchNorm1d`` model trained on the whole batch on this card: fp32,
    rtol 1e-4 with an absolute floor of 1e-5 of the tensor's largest
    entry (the statistics summed in another order, three steps).
    -> the names of the checks."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd

    dev, r, n = hvd.device(), hvd.rank(), hvd.size()
    rows, width = 8, 64
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(rows * n, width, generator=gen, device=dev)
    y = torch.randn(rows * n, 4, generator=gen, device=dev)

    def make(norm):
        torch.manual_seed(5)
        return torch.nn.Sequential(
            torch.nn.Linear(width, 32), norm, torch.nn.ReLU(),
            torch.nn.Linear(32, 4)).to(dev)

    model, ref = make(hvd.SyncBatchNorm(32)), make(torch.nn.BatchNorm1d(32))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    mine = slice(r * rows, (r + 1) * rows)
    checked = []
    for step in range(steps):
        h = hvd.allreduce_async(
            torch.full((1024,), float(r + step), device=dev), op=hvd.Sum,
            name=f"p6.sbn.flight.{step}")
        opt.zero_grad()
        F.mse_loss(model(x[mine]), y[mine]).backward()
        opt.step()
        got = hvd.synchronize(h)
        torch.cuda.synchronize()
        if not torch.equal(got, torch.full_like(
                got, float(n * step + n * (n - 1) // 2))):
            raise AssertionError(f"allreduce in flight, step {step}")
        ref_opt.zero_grad()
        F.mse_loss(ref(x), y).backward()
        ref_opt.step()
    want = ref.state_dict()
    for k, got in model.state_dict().items():
        scale = max(1.0, float(want[k].abs().max()))
        if not torch.allclose(got.double(), want[k].double(), rtol=1e-4,
                              atol=1e-5 * scale):
            raise AssertionError(
                f"SyncBatchNorm under DistributedOptimizer on rank {r}: "
                f"{k} max abs err {max_err(got, want[k]):.3e}")
        checked.append(f"sync_batch_norm {k}")
    return checked


def step_with_and_without_plane(layers, steps=6, pairs=3):
    """Phase 5's training step at ``hvd.size()`` ranks, each on a batch of
    its own, the gradients averaged by ``DistributedOptimizer``, in
    blocks of ``steps`` that alternate between the eager plane's cycle
    thread running and idle, and the plane stopped (a negotiated stop;
    the optimizer does not use the plane; a new plane, with groups of
    its own, starts before each running block), ``pairs`` of each, after
    two steps of warm-up: a drift of the host over the run falls on both
    sides.  -> the median step of the running and of the stopped blocks
    (each block's first step left out), each block's median, and the
    cycles the plane ran meanwhile."""
    import dataclasses

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.models import Transformer, TransformerConfig

    batch, seq = 8, 2048
    cfg = TransformerConfig(vocab_size=VOCAB, n_layers=layers,
                            d_model=D_MODEL, n_heads=D_MODEL // 128,
                            d_ff=4 * D_MODEL, max_len=seq,
                            dtype=torch.bfloat16)
    model = Transformer(cfg, seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    tokens = torch.from_numpy(np.random.RandomState(100 + hvd.rank()).randint(
        0, VOCAB, (batch, seq))).to(hvd.device())
    _, losses, _ = _timed_steps(model, opt, tokens, 2)
    on, off, medians, cycles, on_s = [], [], [], 0, 0.0
    for block in range(2 * pairs):
        state = basics._get_state()
        running = block % 2 == 0
        if running and block > 0:
            basics._state = dataclasses.replace(
                state, controller=basics._start_eager_plane(
                    state.rank, state.size, state.device,
                    "nccl" if state.device.type == "cuda" else "gloo",
                    Config.from_env(), state.key, state.plane))
        controller = basics._get_state().controller
        if controller.is_running() != running:
            raise AssertionError(f"block {block}: the eager plane is "
                                 f"{'' if running else 'not '}stopped")
        start = controller.cycles
        _, block_losses, times = _timed_steps(model, opt, tokens, steps)
        losses += block_losses
        medians.append(1e3 * statistics.median(times[1:]))
        (on if running else off).extend(times[1:])
        if running:
            cycles += controller.cycles - start
            on_s += sum(times)
            controller.shutdown()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"step losses {losses}")
    return {"step_ms_plane_on": 1e3 * statistics.median(on),
            "step_ms_plane_off": 1e3 * statistics.median(off),
            "step_ms_blocks": medians,
            "plane_cycles_during_steps": cycles,
            "plane_cycles_per_s": cycles / on_s}


def _world():
    """Ranks of the multi-card phases: one a card, at most four."""
    import torch

    return min(torch.cuda.device_count(), 4)


def in_ranks(phase, layers, profile=False, world=None, env=None):
    """Run ``RANK_PHASES[phase](layers)`` (with ``profile=True`` when
    asked) on ``world`` ranks (default ``_world()``): in this process at
    one card (``hvd.init`` around it), else one process a card over NCCL
    (two ranks on one card are refused by NCCL), started by the port's
    launcher (``run/launch.py::launch_job`` on ``allocate``'d local
    slots, with a rendezvous KV server and a job key of their own), each
    with ``env`` added to its environment and printing its result as
    one ``RANK_RESULT`` line into its log (``chiprun_out/ranks/<phase>/
    rank.<N>/stdout|stderr``).  A rank that fails fails the phase with
    the logs of the ranks that printed no result.  -> the ranks'
    results."""
    import base64

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.run import allocate
    from horovod_tpu_torch.run.http_server import RendezvousServer
    from horovod_tpu_torch.run.launch import launch_job
    from horovod_tpu_torch.run.service import secret
    from horovod_tpu_torch.utils.logging import get_logger

    world = world or _world()
    if env and world == 1:
        raise ValueError("in_ranks: env= needs rank processes")
    if world == 1:
        hvd.init()
        try:
            return [_run_phase(phase, layers, profile)]
        finally:
            hvd.shutdown()
    slots = allocate.allocate([allocate.HostInfo("localhost", world)], world)
    logs = os.path.join(_out_dir(), "ranks", phase)
    extra = {"HVD_SECRET_KEY": base64.b64encode(
        secret.make_secret_key()).decode(), **(env or {})}
    command = " ".join(shlex.quote(a) for a in _rank_argv(
        phase, layers, profile))
    get_logger()   # its handler writes to this script's stderr
    server = RendezvousServer()
    port = server.start()
    try:
        # the rank logs are the record; the console stays this script's
        with open(os.devnull, "w") as null, \
                contextlib.redirect_stdout(null), \
                contextlib.redirect_stderr(null):
            code = launch_job(slots, command, "127.0.0.1", port,
                              extra_env=extra, output_filename=logs)
    finally:
        server.stop()
    return _rank_results(phase, logs, world, code)


def _rank_argv(phase, layers, profile=False):
    """One rank of ``phase``: this script with ``--rank-of``."""
    return ([sys.executable, os.path.abspath(__file__), "--rank-of", phase,
             str(layers)] + (["--profile"] if profile else []))


def _rank_log(logs, r, world):
    """(stdout, stderr) of rank ``r`` under the launcher's
    ``--output-filename`` layout."""
    rank_dir = os.path.join(logs, f"rank.{r:0{len(str(max(world - 1, 1)))}d}")
    out = []
    for name in ("stdout", "stderr"):
        try:
            with open(os.path.join(rank_dir, name)) as f:
                out.append(f.read())
        except FileNotFoundError:
            out.append("")
    return out


def _rank_results(phase, logs, world, code):
    """Each rank's ``RANK_RESULT``; the launcher's exit code ``code`` or
    a rank without a result fails ``phase`` with the logs of the ranks
    that printed none."""
    results, missing = [], []
    for r in range(world):
        out, err = _rank_log(logs, r, world)
        lines = [line for line in out.splitlines()
                 if line.startswith("RANK_RESULT ")]
        if lines:
            results.append(json.loads(lines[-1].split(" ", 1)[1]))
        else:
            missing.append(f"--- rank {r} stdout (tail) ---\n{out[-4000:]}"
                           f"\n--- rank {r} stderr (tail) ---\n"
                           f"{err[-4000:]}")
    if code != 0 or missing:
        raise AssertionError(f"{phase}: the launcher exited {code}; ranks "
                             f"without a result:\n" + "\n".join(missing))
    return results


def _run_phase(phase, layers, profile):
    if profile:
        return RANK_PHASES[phase](layers, profile=True)
    return RANK_PHASES[phase](layers)


# a rank that has not finished its phase by then prints every thread's
# stack and exits, so that a hang shows where it stands (in_ranks waits
# 900 s)
RANK_WATCHDOG_S = 840


def _rank_of(phase, layers, profile):
    """One rank of a multi-card phase (``--rank-of PHASE LAYERS``)."""
    import faulthandler

    import horovod_tpu_torch as hvd

    faulthandler.dump_traceback_later(RANK_WATCHDOG_S, exit=True)
    if phase in LAUNCHER_PHASES:
        # phase 12's ranks make their own init and shutdown
        res = RANK_PHASES[phase](layers)
    else:
        hvd.init()
        try:
            res = _run_phase(phase, layers, profile)
        finally:
            hvd.shutdown()
    print("RANK_RESULT " + json.dumps(res), flush=True)
    return 0


def _deciles(xs):
    """(10th, 90th) percentile of ``xs``."""
    qs = statistics.quantiles(xs, n=10) if len(xs) > 1 else list(xs) * 9
    return qs[0], qs[-1]


def _heartbeat_stats(wall_s):
    """The control plane's heartbeats on this rank so far: the round
    trip's median (ms), the beats, and the share of ``wall_s`` spent in
    them."""
    from horovod_tpu_torch.common import basics

    beats = basics._get_state().plane.heartbeat_times()
    return {"heartbeat_ms_median": (1e3 * statistics.median(beats)
                                    if beats else None),
            "heartbeats": len(beats),
            "heartbeat_share": sum(beats) / wall_s if beats else None}


def eager_phase(smi, layers):
    """Phase 6: :func:`eager_checks` at ``world = min(cards, 4)`` ranks
    (``in_ranks``)."""
    results = in_ranks("eager", layers)
    for res in results:
        print(f"eager rank {res['rank']} of {res['world']}: {res['checks']} "
              f"checks passed; negotiation median "
              f"{res['negotiation_ms_median']:.4f} ms (10th-90th "
              f"percentile {res['negotiation_ms_p10_p90'][0]:.4f}-"
              f"{res['negotiation_ms_p10_p90'][1]:.4f}) over "
              f"{res['cycles']} cycles through the coordinator (HMAC "
              + (f"{res['hmac_ms_median'] * 1e3:.2f} us a cycle"
                 if res["hmac_ms_median"] is not None else "none: one rank")
              + ("; heartbeats: none, one rank" if res["heartbeats"] == 0
                 else f"; {res['heartbeats']} heartbeats, round trip "
                      f"median {res['heartbeat_ms_median']:.4f} ms, "
                      f"{100 * res['heartbeat_share']:.4f}% of the phase's "
                      f"wall time")
              + f"); grouped_allreduce of {res['params']} fp32 gradients "
              f"{res['eager_ms']:.3f} ms ({res['eager_gb_s']:.1f} GB/s), "
              f"allreduce_gradients {res['direct_ms']:.3f} ms "
              f"({res['direct_gb_s']:.1f} GB/s); {res['cache_hits']} cache "
              f"hits on {smi}", flush=True)
        print(f"eager rank {res['rank']} of {res['world']}: int8 "
              f"grouped_allreduce of {res['params']} fp32 gradients "
              f"{res['int8_ms']:.3f} ms, {res['int8_wire_bytes']} bytes "
              f"sent a rank (max abs err {res['int8_max_err_grads']:.3e}), "
              f"against fp32 {res['int8_fp32_ms']:.3f} ms, "
              f"{res['fp32_wire_bytes']} bytes (ring); {smi}", flush=True)
        print(f"eager rank {res['rank']} of {res['world']}: int8 "
              f"allreduce_gradients (per gradient) "
              f"{res['int8_leaf_ms']:.3f} ms, {res['int8_leaf_wire_bytes']} "
              f"bytes sent a rank, {res['int8_leaf_extra_bytes']} bytes of "
              f"memory beyond its inputs (max abs err "
              f"{res['int8_max_err_leaves']:.3e}), against fp32 "
              f"{res['int8_leaf_fp32_ms']:.3f} ms; {smi}", flush=True)
        print(f"eager rank {res['rank']} of {res['world']}: step at "
              f"{res['world']} GPU(s) {res['step_ms_plane_on']:.2f} ms with "
              f"the plane running ({res['plane_cycles_during_steps']} "
              f"cycles, {res['plane_cycles_per_s']:.1f} a second), "
              f"{res['step_ms_plane_off']:.2f} ms with it stopped; block "
              f"medians (running and stopped in turns) "
              f"{[round(t, 2) for t in res['step_ms_blocks']]} ms on {smi}",
              flush=True)
    return results


# phase 8: steps of each optimizer before the checks, then blocks of
# steps in turns
ZERO_CHECK_STEPS, ZERO_BLOCK_STEPS, ZERO_PAIRS = 3, 4, 3
# phase 8's witness of the summation order: DistributedOptimizer with
# buckets of this many bytes (the default is 64 MB)
WITNESS_THRESHOLD = 16 * 1024 * 1024
# phase 9: each rank's shard of the sequence (the main path's 16,384
# tokens a GPU at batch 2), and the remat turns
SEQ_SHARD, SEQ_BATCH, SEQ_STEPS = 8192, 2, 5
REMAT_BLOCK_STEPS, REMAT_PAIRS = 4, 3


def main_config(layers, seq=2048, dtype=None, **kw):
    """The main path's transformer (phase 5) at ``layers``."""
    import torch

    from horovod_tpu_torch.models import TransformerConfig

    return TransformerConfig(vocab_size=VOCAB, n_layers=layers,
                             d_model=D_MODEL, n_heads=D_MODEL // 128,
                             d_ff=4 * D_MODEL, max_len=seq,
                             dtype=dtype or torch.bfloat16, **kw)


def per_step_launches(layers, remat=False, flash=1):
    """Each kernel's launches in one training step of the transformer:
    LayerNorm twice a block and once at the end, the loss once, each
    flash kernel ``flash`` times a block; under remat every forward
    kernel of a block runs twice."""
    again = 2 if remat else 1
    return {"layer_norm_fwd": 2 * layers * again + 1,
            "layer_norm_bwd": 2 * layers + 1,
            "softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
            "flash_attention_fwd": flash * layers * again,
            "flash_attention_bwd_dq": flash * layers,
            "flash_attention_bwd_dkv": flash * layers}


def expect_launches(what, counts, per_step, steps):
    for name, want in per_step.items():
        if counts[name] != want * steps:
            raise AssertionError(
                f"{what}: {name} launched {counts[name]} times in {steps} "
                f"steps, expected {want} per step")


def _drain():
    """Let the eager plane issue what this rank submitted before a
    collective of the default group (ROADMAP C.7)."""
    from horovod_tpu_torch.common import basics

    basics._get_state().controller.drain()


def _flat_params(model):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _same_on_every_rank(what, t, group=None, like=None):
    """``t`` must be bitwise the same on every rank (of ``group``, a
    ``ProcessGroup``); a rank without a result takes part with ``t=None``
    and ``like``, a tensor of its shape and dtype."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch import groups

    tg = groups.torch_group(group)
    root = t.clone() if t is not None else torch.empty_like(like)
    _drain()
    dist.broadcast(root, dist.get_global_rank(tg, 0) if tg is not None
                   else 0, group=tg)
    if t is not None and not torch.equal(root, t):
        raise AssertionError(f"{what}: rank {dist.get_rank()}'s values are "
                             f"not bitwise its group's first rank's")


def _state_bytes(state):
    import torch

    return sum(v.numel() * v.element_size() for entry in state.values()
               for v in entry.values() if torch.is_tensor(v))


def _lm_step(model, opt, tokens, labels=None, positions=None):
    """One training step; -> the loss (a tensor on the card)."""
    from horovod_tpu_torch.models import lm_loss
    from horovod_tpu_torch.ops.cuda.softmax_xent import softmax_xent

    opt.zero_grad(set_to_none=True)
    logits = model(tokens, positions=positions)
    loss = lm_loss(logits, tokens) if labels is None else \
        softmax_xent(logits, labels).mean()
    loss.backward()
    opt.step()
    return loss.detach()


def _blocks_in_turns(runs, steps, pairs):
    """``runs``: name -> a step function.  ``pairs`` rounds in which each
    run takes a block of ``steps`` synchronised steps, in turns.  -> name
    -> (each block's median step ms, first step left out; each block's
    peak memory above what was allocated at its start)."""
    import torch

    out = {k: ([], []) for k in runs}
    for _ in range(pairs):
        for name, step in runs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            times = []
            for _ in range(steps):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out[name][0].append(1e3 * statistics.median(times[1:]))
            out[name][1].append(torch.cuda.max_memory_allocated() - base)
    return out


def _param_errors(models, names):
    """Each later model's parameters against the first's: the largest
    error, and whether they are within rtol 1e-5, atol 2e-6."""
    import torch

    ref = _flat_params(models[names[0]])
    out = {}
    for k in names[1:]:
        got = _flat_params(models[k])
        out[k] = {"max": max_err(got, ref),
                  "close": torch.allclose(got, ref, rtol=1e-5, atol=2e-6)}
        del got
    return out


def zero_checks(layers):
    """Phase 8 on this rank, ``hvd.init()`` done: the main path's model
    (phase 5's configuration, each rank a batch of its own) trained by
    ``DistributedOptimizer``, ``ShardedDistributedOptimizer`` and
    ``ZeroDistributedOptimizer`` (AdamW lr 1e-4, weight decay 1e-4), three
    models from one seed.  After ``ZERO_CHECK_STEPS`` steps on the same
    gradients each ZeRO variant's parameters equal
    ``DistributedOptimizer``'s within rtol 1e-5, atol 2e-6 (Adam's
    normalised step on gradients summed in another order), every model's
    are bitwise the same on every rank,
    each ZeRO rank holds its layout's elements a moment (``ceil(params /
    P)`` in the in-graph layout, the ``np.array_split`` block in the
    eager one), and
    ``gather_zero_state`` then ``reshard_zero_state`` give the eager
    state back bitwise.  Then ``ZERO_PAIRS`` blocks of steps in turns
    (each model its own gradients; step time, peak memory above the
    resident, and how far the models then lie apart), and one int8
    ``ShardedDistributedOptimizer`` step (SGD at lr 1 from zero
    parameters, so that the parameters are minus the reduced gradient)
    on gradients scaled 1 to 10^-3 from block to block, held to the fp32
    sum within ``(n + 1) * blockmax / 254``.  Last, the witness of the
    summation order (:func:`_own_gradient_gaps`).  -> the rank's
    numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.compression import Compression, INT8_BLOCK
    from horovod_tpu_torch.models import Transformer, lm_loss
    from horovod_tpu_torch.ops import cuda as kernels
    from horovod_tpu_torch.sharding import zero_shard_layout

    dev, r, n = hvd.device(), hvd.rank(), hvd.size()
    tokens = torch.from_numpy(np.random.RandomState(100 + r).randint(
        0, VOCAB, (MAIN_BATCH, MAIN_SEQ))).to(dev)
    wrappers = {
        "DistributedOptimizer": lambda m, o: hvd.DistributedOptimizer(
            o, named_parameters=m.named_parameters()),
        "ShardedDistributedOptimizer":
            lambda m, o: hvd.ShardedDistributedOptimizer(o),
        "ZeroDistributedOptimizer":
            lambda m, o: hvd.ZeroDistributedOptimizer(o)}
    models, opts = {}, {}
    for name, wrap in wrappers.items():
        models[name] = Transformer(main_config(layers), seed=0)
        opts[name] = wrap(models[name], torch.optim.AdamW(
            models[name].parameters(), lr=1e-4, weight_decay=1e-4))
    names = list(models)
    n_params = sum(p.numel() for p in models[names[0]].parameters())

    # the checked steps: every optimizer takes the same gradients, this
    # rank's backward of one of the models.  Above one rank the
    # optimizers sum them in other orders, and a model's own bf16 forward
    # turns the last-bit differences of the parameters after one step
    # into different roundings of its activations, so three models that
    # each computed their own gradients part further than Adam's
    # tolerance within three steps
    src = models["ZeroDistributedOptimizer"]
    losses = []
    for _ in range(ZERO_CHECK_STEPS):
        src.zero_grad(set_to_none=True)
        loss = lm_loss(src(tokens), tokens)
        loss.backward()
        losses.append(loss.item())
        grads = [p.grad for p in src.parameters()]
        for k in names:
            for p, g in zip(models[k].parameters(), grads):
                p.grad = g.clone()
            opts[k].step()
        del grads
    for k in names:
        opts[k].zero_grad(set_to_none=True)
    err = _param_errors(models, names)
    for k, e in err.items():
        if not e["close"]:
            raise AssertionError(f"zero: {k}'s parameters after "
                                 f"{ZERO_CHECK_STEPS} steps differ from "
                                 f"DistributedOptimizer's by {e['max']:.3e}")
    for k in names:
        _same_on_every_rank(f"zero {k}", _flat_params(models[k]))
    chunk = {"ShardedDistributedOptimizer": -(-n_params // n),
             "ZeroDistributedOptimizer": zero_shard_layout(n_params, n,
                                                           r)[2]}
    for k in names[1:]:
        for key in ("exp_avg", "exp_avg_sq"):
            held = opts[k].state_dict()["state"][0][key].numel()
            if held != chunk[k]:
                raise AssertionError(f"zero: {k} holds {held} elements of "
                                     f"{key}, expected {chunk[k]}")
    state = opts["ZeroDistributedOptimizer"].state_dict()
    back = hvd.reshard_zero_state(hvd.gather_zero_state(state, n_params),
                                  n_params)
    for key, v in state["state"][0].items():
        if not torch.equal(v, back["state"][0][key]):
            raise AssertionError(f"zero: {key} after gather and reshard "
                                 f"is not the rank's state")
    del state, back
    state_bytes = {k: _state_bytes(opts[k].state) for k in names}
    param_bytes = n_params * 4

    # the main path: each model its own steps, in turns
    kernels.reset_launch_counts()
    turns = _blocks_in_turns(
        {k: (lambda k=k: _lm_step(models[k], opts[k], tokens))
         for k in names}, ZERO_BLOCK_STEPS, ZERO_PAIRS)
    counts = kernels.launch_counts()
    expect_launches("zero", counts, per_step_launches(layers),
                    len(names) * ZERO_PAIRS * ZERO_BLOCK_STEPS)
    for k in names:
        opts[k].zero_grad(set_to_none=True)
    process_peak = torch.cuda.max_memory_allocated()
    apart = {k: e["max"] for k, e in _param_errors(models, names).items()}

    # one int8 ShardedDistributedOptimizer step
    m = models["ShardedDistributedOptimizer"]
    del models, opts
    _release()
    m.zero_grad(set_to_none=True)
    lm_loss(m(tokens), tokens).backward()
    flat = _block_scaled(torch.cat([p.grad.reshape(-1)
                                    for p in m.parameters()]), INT8_BLOCK)
    exact = flat.clone()
    _drain()
    dist.all_reduce(exact)
    blockmax = torch.maximum(_rank_max(_block_max(flat, INT8_BLOCK)),
                             _block_max(exact, INT8_BLOCK))
    with torch.no_grad():
        offset = 0
        for p in m.parameters():
            p.zero_()
            p.grad = flat[offset:offset + p.numel()].view(p.shape).clone()
            offset += p.numel()
    del flat
    hvd.ShardedDistributedOptimizer(torch.optim.SGD(m.parameters(), lr=1.0),
                                    compression=Compression.int8).step()
    int8_err = _within_int8_bound("ShardedDistributedOptimizer step",
                                  -_flat_params(m) * n, exact, blockmax, n)
    del m, exact, blockmax
    _release()
    own = _own_gradient_gaps(layers, tokens, wrappers)
    return {"rank": r, "world": n, "params": n_params, "losses": losses,
            "max_err_vs_distributed": {k: e["max"] for k, e in err.items()},
            "apart_after_own_steps": apart, "state_bytes": state_bytes,
            "param_bytes": param_bytes, "counts": counts,
            "step_ms_blocks": {k: v[0] for k, v in turns.items()},
            "peak_over_resident": {k: v[1] for k, v in turns.items()},
            "process_peak": process_peak, "int8_max_err": int8_err,
            "own_gradient_gaps": own, "sharded": n > 1}


def _own_gradient_gaps(layers, tokens, wrappers):
    """Phase 8's witness of the summation order: models from seed 0, one
    at a time, each trained ``ZERO_CHECK_STEPS`` steps on its own
    gradients (AdamW lr 1e-4, weight decay 1e-4) by
    ``DistributedOptimizer``, by it again (the same buckets), by it with
    ``WITNESS_THRESHOLD``-byte buckets (the same sum, cut into other
    NCCL calls, so some elements are summed in another order) and by
    each ZeRO variant.  -> each later run's largest parameter error
    against the first's (a reading, not a check: the checks are the
    shared-gradient ones)."""
    import torch

    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.utils import env as env_util

    do = wrappers["DistributedOptimizer"]
    runs = {"DistributedOptimizer": (do, None),
            "DistributedOptimizer again": (do, None),
            f"DistributedOptimizer {WITNESS_THRESHOLD >> 20} MB buckets":
                (do, WITNESS_THRESHOLD)}
    runs.update((k, (w, None)) for k, w in wrappers.items()
                if k != "DistributedOptimizer")
    ref, gaps = None, {}
    for name, (wrap, threshold) in runs.items():
        model = Transformer(main_config(layers), seed=0)
        before = os.environ.get(env_util.HVD_FUSION_THRESHOLD)
        if threshold is not None:
            os.environ[env_util.HVD_FUSION_THRESHOLD] = str(threshold)
        try:
            opt = wrap(model, torch.optim.AdamW(
                model.parameters(), lr=1e-4, weight_decay=1e-4))
        finally:
            if before is None:
                os.environ.pop(env_util.HVD_FUSION_THRESHOLD, None)
            else:
                os.environ[env_util.HVD_FUSION_THRESHOLD] = before
        for _ in range(ZERO_CHECK_STEPS):
            _lm_step(model, opt, tokens)
        flat = _flat_params(model)
        if ref is None:
            ref = flat
        else:
            gaps[name] = max_err(flat, ref)
        del model, opt, flat
        _release()
    return gaps


def zero_phase(smi):
    """Phase 8: :func:`zero_checks` at ``min(cards, 4)`` ranks."""
    results = in_ranks("zero", LAYERS)
    for res in results:
        n = res["world"]
        head = f"zero rank {res['rank']} of {n}"
        if not res["sharded"]:
            print(f"{head}: P = 1: ZeroDistributedOptimizer takes the "
                  f"replicated update, ShardedDistributedOptimizer one "
                  f"shard of the whole", flush=True)
        for k, ms in res["step_ms_blocks"].items():
            over = res["peak_over_resident"][k]
            alone = res["param_bytes"] + res["state_bytes"][k] + max(over)
            print(f"{head}: {k}: step {statistics.median(ms):.2f} ms (block "
                  f"medians in turns {[round(t, 2) for t in ms]}), "
                  f"optimizer state {res['state_bytes'][k]} bytes a rank, "
                  f"peak above the resident {max(over) / 2**30:.2f} GiB, "
                  f"parameters + state + that peak {alone / 2**30:.2f} GiB; "
                  f"max abs err against DistributedOptimizer "
                  f"{res['max_err_vs_distributed'].get(k, 0.0):.3e} after "
                  f"{ZERO_CHECK_STEPS} steps on the same gradients, "
                  f"{res['apart_after_own_steps'].get(k, 0.0):.3e} after "
                  f"{ZERO_PAIRS * ZERO_BLOCK_STEPS} more on its own on "
                  f"{smi}", flush=True)
        print(f"{head}: losses of the checked steps "
              f"{[round(x, 4) for x in res['losses']]}", flush=True)
        print(f"{head}: {ZERO_CHECK_STEPS} steps each on its own "
              f"gradients, max abs err against DistributedOptimizer's: "
              + ", ".join(f"{k} {v:.3e}"
                          for k, v in res["own_gradient_gaps"].items())
              + f" on {smi}", flush=True)
        print(f"{head}: process peak {res['process_peak'] / 2**30:.2f} GiB "
              f"(three models resident); int8 ShardedDistributedOptimizer "
              f"step max abs err {res['int8_max_err']:.3e} (within "
              f"(n + 1) * blockmax / 254)", flush=True)
    return results


def _attention_variants(r, n):
    """name -> (the sequence-parallel call on shards, zigzag layout,
    causal, flash launches of each kernel in one call on rank ``r``)."""
    from horovod_tpu_torch.parallel import (ring_attention,
                                            ulysses_attention,
                                            zigzag_ring_attention)

    return {
        "ring_causal": (lambda q, k, v: ring_attention(q, k, v, causal=True),
                        False, True, r + 1),
        "ring": (lambda q, k, v: ring_attention(q, k, v, causal=False),
                 False, False, n),
        "zigzag": (lambda q, k, v: zigzag_ring_attention(q, k, v), True,
                   True, 2 * n + 1),
        "ulysses": (lambda q, k, v: ulysses_attention(q, k, v, causal=True),
                    False, True, 1)}


def sequence_attention(iters=5):
    """Phase 9, attention alone: q, k, v, dO ``[2, 8192 * P, 8, 128]``
    bf16 from a seed on every rank, each rank running its shard through
    ring (causal and not), zigzag and Ulysses attention (each with its
    default attention: the flash kernels on the card), forward and
    backward; out, dq, dk and dv held row by row
    (``check_flash_close``, 2e-2 of each row's largest entry) to
    ``flash_attention`` over the whole sequence on this card.  Then each
    variant's forward and backward timed in turns, and the whole
    sequence's on one card.  -> the numbers."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda as kernels
    from horovod_tpu_torch.ops.cuda.flash_attention import flash_attention
    from horovod_tpu_torch.parallel import zigzag_shard

    dev, r, n = hvd.device(), hvd.rank(), hvd.size()
    b, t, h, d = SEQ_BATCH, SEQ_SHARD * n, ATTN_H, ATTN_D
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))

    def shard(x, zz):
        if zz:
            x = zigzag_shard(x, n)
        return x[:, r * SEQ_SHARD:(r + 1) * SEQ_SHARD].contiguous()

    def fwd_bwd(fn, inputs, dout):
        leaves = [x.detach().requires_grad_(True) for x in inputs]
        out = fn(*leaves)
        out.backward(dout)
        return [out.detach()] + [x.grad for x in leaves]

    full = {}
    for causal in (True, False):
        full[causal] = fwd_bwd(lambda a, b_, c: flash_attention(
            a, b_, c, causal=causal), (q, k, v), do)
    variants = _attention_variants(r, n)
    errs, launches = {}, {}
    for name, (fn, zz, causal, per_call) in variants.items():
        kernels.reset_launch_counts()
        got = fwd_bwd(fn, [shard(x, zz) for x in (q, k, v)], shard(do, zz))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        launches[name] = counts["flash_attention_fwd"]
        for kname in ("flash_attention_fwd", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv"):
            if counts[kname] != per_call:
                raise AssertionError(f"sequence {name}: {kname} launched "
                                     f"{counts[kname]} times, expected "
                                     f"{per_call}")
        errs[name] = max(
            check_flash_close(f"sequence {name} {what} rank {r} of {n}", g,
                              shard(w, zz), 2e-2)
            for g, w, what in zip(got, full[causal],
                                  ("out", "dq", "dk", "dv")))
        del got
    del full
    shards = {zz: [shard(x, zz) for x in (q, k, v, do)]
              for zz in (False, True)}
    calls = {name: (lambda fn=fn, zz=zz: fwd_bwd(
        fn, shards[zz][:3], shards[zz][3]))
        for name, (fn, zz, _, _) in variants.items()}
    calls["one_card_causal"] = lambda: fwd_bwd(
        lambda a, b_, c: flash_attention(a, b_, c, causal=True), (q, k, v),
        do)
    ms = {k: [] for k in calls}
    for fn in calls.values():
        fn()
    for _ in range(iters):
        for name, fn in calls.items():
            _drain()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[name].append(1e3 * (time.perf_counter() - t0))
    return {"attention_shape": [b, t, h, d], "attention_max_err": errs,
            "attention_ms": {k: statistics.median(v) for k, v in ms.items()},
            "attention_launches": launches}


def _zigzag_batch(n, r, seed=0, zigzag=True):
    """The global batch ``[2, 8192 * P + 1]`` from ``seed``: tokens and
    their next-token targets zigzag-reordered together (unless
    ``zigzag`` is false: contiguous shards, as the ring takes them), then
    this rank's shard of each and of the global positions (as
    ``examples/long_context_training.py`` prepares them)."""
    import numpy as np
    import torch

    from horovod_tpu_torch.parallel import zigzag_shard

    t = SEQ_SHARD * n
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(
        0, VOCAB, (SEQ_BATCH, t + 1)))
    order = (lambda x: zigzag_shard(x, n)) if zigzag else (lambda x: x)
    mine = slice(r * SEQ_SHARD, (r + 1) * SEQ_SHARD)
    inp, tgt = (order(x)[:, mine] for x in (tokens[:, :-1], tokens[:, 1:]))
    pos = order(torch.arange(t)[None])[0, mine]
    return tokens, inp, tgt, pos


def _zigzag_attn(q, k, v, causal=True, scale=None):
    from horovod_tpu_torch.parallel import zigzag_ring_attention

    return zigzag_ring_attention(q, k, v, scale=scale)


def sequence_training(layers, profile=False):
    """Phase 9, training: the main path's transformer at full width with
    ``attn_fn`` = zigzag ring attention, global sequence 8192 * P (so
    ``max_len`` too), batch 2 (each GPU holds ``[2, 8192]`` tokens),
    global positions passed to ``forward``, ``DistributedOptimizer(AdamW)``
    over the world, ``SEQ_STEPS`` steps: the loss finite and falling,
    (2P + 1) * layers launches of each flash kernel a step.  With
    ``profile``, one more step under ``torch.profiler``
    (``chiprun_out/profile_zigzag_rank<r>.txt``).  -> the numbers."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.ops import cuda as kernels

    dev, r, n = hvd.device(), hvd.rank(), hvd.size()
    cfg = main_config(layers, seq=SEQ_SHARD * n, attn_fn=_zigzag_attn)
    model = Transformer(cfg, seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    _, inp, tgt, pos = (x.to(dev) for x in _zigzag_batch(n, r))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(SEQ_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _lm_step(model, opt, inp, tgt, pos)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        _drain()
        dist.all_reduce(loss)
        losses.append(loss.item() / n)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_launches("sequence training", counts,
                    per_step_launches(layers, flash=2 * n + 1), SEQ_STEPS)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"sequence training: losses {losses}")
    step = statistics.median(times[1:])
    profiled = _profile(lambda: _lm_step(model, opt, inp, tgt, pos),
                        f"profile_zigzag_rank{r}.txt") if profile else None
    return {"train_losses": losses, "train_step_s": times,
            "train_tokens_per_s_per_gpu": SEQ_BATCH * SEQ_SHARD / step,
            "train_peak": peak, "train_counts": counts,
            "train_profiled_device_ms": profiled}


def _ring_attn(q, k, v, causal=True, scale=None):
    from horovod_tpu_torch.parallel import ring_attention

    return ring_attention(q, k, v, causal=causal, scale=scale)


def sequence_ring_training(layers):
    """Phase 9, the order of the two communicators: the training of
    :func:`sequence_training` with ``attn_fn`` = causal ring attention on
    contiguous shards.  Its backward is a different graph on every rank
    (rank r attends r + 1 blocks), so the ring's permutations on the
    sequence group and ``DistributedOptimizer``'s bucket allreduces on
    the default group may interleave differently from rank to rank; NCCL
    does not promise progress then.  ``SEQ_STEPS`` steps must finish,
    the loss finite and falling, the parameters bitwise the same on
    every rank and each flash kernel launched r + 1 times a block on
    rank r.  -> the numbers."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.ops import cuda as kernels

    dev, r, n = hvd.device(), hvd.rank(), hvd.size()
    cfg = main_config(layers, seq=SEQ_SHARD * n, attn_fn=_ring_attn)
    model = Transformer(cfg, seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    _, inp, tgt, pos = (x.to(dev)
                        for x in _zigzag_batch(n, r, zigzag=False))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(SEQ_STEPS):
        t0 = time.perf_counter()
        loss = _lm_step(model, opt, inp, tgt, pos)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        _drain()
        dist.all_reduce(loss)
        losses.append(loss.item() / n)
    counts = kernels.launch_counts()
    expect_launches("causal ring training", counts,
                    per_step_launches(layers, flash=r + 1), SEQ_STEPS)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"causal ring training: losses {losses}")
    _same_on_every_rank("causal ring training", _flat_params(model))
    return {"ring_train_losses": losses, "ring_train_step_s": times,
            "ring_train_tokens_per_s_per_gpu":
                SEQ_BATCH * SEQ_SHARD / statistics.median(times[1:])}


def sequence_two_layer_parity():
    """Phase 9: at two layers in fp32 (TF32 off, phase 4's setting), the
    first step's global loss and averaged gradients of the zigzag model
    on P ranks against the same model over the whole sequence on this
    card: loss rtol 1e-5, gradients rtol 1e-3 with atol 1e-5 (phase 4's
    tolerances).  -> the loss, each side's gradient norm, the largest
    error."""
    import dataclasses

    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.ops.cuda.softmax_xent import softmax_xent

    dev, r, n = hvd.device(), hvd.rank(), hvd.size()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = main_config(2, seq=SEQ_SHARD * n, dtype=torch.float32,
                          attn_fn=_zigzag_attn)
        tokens, inp, tgt, pos = (x.to(dev) for x in _zigzag_batch(n, r))
        model = Transformer(cfg, seed=0)
        loss = softmax_xent(model(inp, positions=pos), tgt).mean()
        loss.backward()
        grads = hvd.allreduce_gradients(
            {k: p.grad for k, p in model.named_parameters()})
        loss = loss.detach()
        _drain()
        dist.all_reduce(loss)
        loss = loss / n
        del model
        whole = Transformer(dataclasses.replace(cfg, attn_fn=None), seed=0)
        want = softmax_xent(whole(tokens[:, :-1]), tokens[:, 1:]).mean()
        want.backward()
        assert_close("sequence two-layer loss", loss, want.detach(), 1e-5,
                     1e-5)
        worst = 0.0
        for k, p in whole.named_parameters():
            assert_close(f"sequence two-layer grad {k}", grads[k], p.grad,
                         1e-3, 1e-5)
            worst = max(worst, max_err(grads[k], p.grad))
        norms = (float(torch.stack([g.norm() for g in grads.values()])
                       .norm()),
                 float(torch.stack([p.grad.norm()
                                    for p in whole.parameters()]).norm()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"parity_loss": [float(loss), float(want.detach())],
            "parity_grad_norm": norms, "parity_max_err": worst}


def remat_turns(layers):
    """Phase 9, remat: phase 5's step (full width, batch 8 x 2048, bf16,
    ``DistributedOptimizer(AdamW)``, each rank a batch of its own) with
    ``remat=True`` and without, from one seed: the first step's loss
    bitwise the same (the same forward), the averaged gradients within
    phase 4's tolerance (rtol 1e-3, atol 1e-5), the forward kernels
    launched twice a block under remat; then ``REMAT_PAIRS`` blocks of
    steps in turns (step time, peak memory above the resident).  -> the
    numbers."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.ops import cuda as kernels

    dev, r = hvd.device(), hvd.rank()
    tokens = torch.from_numpy(np.random.RandomState(100 + r).randint(
        0, VOCAB, (MAIN_BATCH, MAIN_SEQ))).to(dev)
    models, opts, first, counts = {}, {}, {}, {}
    for remat in (False, True):
        models[remat] = Transformer(main_config(layers, remat=remat), seed=0)
        opts[remat] = hvd.DistributedOptimizer(
            torch.optim.AdamW(models[remat].parameters(), lr=1e-4,
                              weight_decay=1e-4),
            named_parameters=models[remat].named_parameters())
        kernels.reset_launch_counts()
        first[remat] = _lm_step(models[remat], opts[remat], tokens)
        counts[remat] = kernels.launch_counts()
        expect_launches(f"remat={remat}", counts[remat],
                        per_step_launches(layers, remat=remat), 1)
    if not torch.equal(first[True], first[False]):
        raise AssertionError(f"remat: first losses {float(first[True])} and "
                             f"{float(first[False])} differ")
    bitwise, worst = True, 0.0
    for (k, a), b in zip(models[True].named_parameters(),
                         models[False].parameters()):
        assert_close(f"remat grad {k}", a.grad, b.grad, 1e-3, 1e-5)
        bitwise = bitwise and torch.equal(a.grad, b.grad)
        worst = max(worst, max_err(a.grad, b.grad))
    turns = _blocks_in_turns(
        {f"remat={k}": (lambda k=k: _lm_step(models[k], opts[k], tokens))
         for k in (False, True)}, REMAT_BLOCK_STEPS, REMAT_PAIRS)
    return {"remat_first_loss": float(first[True]),
            "remat_grads_bitwise": bitwise, "remat_grad_max_err": worst,
            "remat_counts": {str(k): v for k, v in counts.items()},
            "remat_step_ms_blocks": {k: v[0] for k, v in turns.items()},
            "remat_peak_over_resident": {k: v[1] for k, v in turns.items()}}


def sequence_checks(layers, profile=False):
    """Phase 9 on this rank, ``hvd.init()`` done."""
    import horovod_tpu_torch as hvd

    res = {"rank": hvd.rank(), "world": hvd.size()}
    for part in (sequence_attention,
                 lambda: sequence_training(layers, profile),
                 lambda: sequence_ring_training(layers),
                 sequence_two_layer_parity, lambda: remat_turns(layers)):
        res.update(part())
        _release()
    return res


def _release():
    """Free what a finished part left: an optimizer's hooks and its
    parameters hold each other, so only the collector frees them."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def sequence_phase(smi, profile=False):
    """Phase 9: :func:`sequence_checks` at ``min(cards, 4)`` ranks."""
    results = in_ranks("sequence", LAYERS, profile)
    for res in results:
        n = res["world"]
        head = f"sequence rank {res['rank']} of {n}"
        if n == 1:
            print(f"{head}: P = 1: the ring has no hop, zigzag two chunks "
                  f"on one card, Ulysses no exchange", flush=True)
        ms = {k: round(v, 3) for k, v in res["attention_ms"].items()}
        print(f"{head}: attention {res['attention_shape']} bf16 forward + "
              f"backward ms {ms}, max abs err "
              f"{ {k: float(f'{v:.3e}') for k, v in res['attention_max_err'].items()} }, "
              f"flash launches a call {res['attention_launches']} on {smi}",
              flush=True)
        print(f"{head}: zigzag transformer ({LAYERS} layers, "
              f"[{SEQ_BATCH}, {SEQ_SHARD}] tokens a GPU of a "
              f"{SEQ_SHARD * n} sequence): losses "
              f"{[round(x, 4) for x in res['train_losses']]}, step times s "
              f"{[round(x, 4) for x in res['train_step_s']]}, "
              f"{res['train_tokens_per_s_per_gpu']:.1f} tokens/s per GPU, "
              f"peak memory {res['train_peak'] / 2**30:.2f} GiB on {smi}",
              flush=True)
        print(f"{head}: causal ring transformer under DistributedOptimizer "
              f"(the two communicators' order): losses "
              f"{[round(x, 4) for x in res['ring_train_losses']]}, step "
              f"times s {[round(x, 4) for x in res['ring_train_step_s']]}, "
              f"{res['ring_train_tokens_per_s_per_gpu']:.1f} tokens/s per "
              f"GPU, parameters bitwise the same on every rank on {smi}",
              flush=True)
        if res["train_profiled_device_ms"] is not None:
            print(f"{head}: zigzag step device busy "
                  f"{res['train_profiled_device_ms']:.3f} ms "
                  f"(profile_zigzag_rank{res['rank']}.txt)", flush=True)
        print(f"{head}: two layers fp32, zigzag on {n} against one card: "
              f"loss {res['parity_loss']}, gradient norm "
              f"{res['parity_grad_norm']}, max abs err "
              f"{res['parity_max_err']:.3e}", flush=True)
        blocks = res["remat_step_ms_blocks"]
        peaks = res["remat_peak_over_resident"]
        print(f"{head}: remat: first loss {res['remat_first_loss']:.6f} "
              f"bitwise without; gradients bitwise "
              f"{res['remat_grads_bitwise']} (max abs err "
              f"{res['remat_grad_max_err']:.3e}); "
              + "; ".join(
                  f"{k} step {statistics.median(v):.2f} ms (blocks "
                  f"{[round(t, 2) for t in v]}), peak above the resident "
                  f"{max(peaks[k]) / 2**30:.2f} GiB"
                  for k, v in blocks.items()) + f" on {smi}", flush=True)
    return results


# phase 10: model parallelism at min(cards, 4) ranks
MP_STEPS, MP_BATCH, MP_PARITY_BATCH = 5, 8, 2
MOE_EVERY, N_EXPERTS, AUX_WEIGHT = 2, 8, 0.01   # examples/transformer_lm.py
PIPE_MICRO = 8                                  # microbatches of [1, 2048]
BF16_TOL = (1e-2, 1e-2)   # phase 3's bf16 tolerance (rtol, atol)


def _fit(n, **axes):
    """``axes`` shrunk to ``n`` ranks: the last axis above 1 halves until
    the sizes multiply to ``n`` (at one card every axis is 1)."""
    axes = dict(axes)
    while math.prod(axes.values()) > n:
        last = [a for a, s in axes.items() if s > 1][-1]
        axes[last] //= 2
    if math.prod(axes.values()) != n:
        raise ValueError(f"{axes} do not fit {n} ranks")
    return axes


def _rows(seed, rows, dp_index=0, dp=1):
    """``rows`` token rows of ``MAIN_SEQ`` for dp replica ``dp_index`` of
    ``dp``, from one ``RandomState(seed)`` batch (and that batch)."""
    import numpy as np
    import torch

    whole = torch.from_numpy(np.random.RandomState(seed).randint(
        0, VOCAB, (rows * dp, MAIN_SEQ)))
    return whole[dp_index * rows:(dp_index + 1) * rows], whole


def _tf32_off():
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return old


def _tf32_restore(old):
    import torch

    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = old


def groups_on_card():
    """Phase 10 (a), groups: the world's two halves as two groups
    (``new_group``), each rank allreducing integer-valued fp32 tensors
    in its half, four at once: every sum bitwise the expected one, and
    ``max_concurrent_groups`` >= 2 (the two groups in flight at once;
    >= 1 at one card).  -> the numbers."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import groups

    r, n = hvd.rank(), hvd.size()
    halves = [list(range(n // 2)), list(range(n // 2, n))] if n > 1 \
        else [[0]]
    made = [hvd.new_group(h) for h in halves]
    mine = next(g for g in made if r in g.ranks)
    base = torch.arange(1 << 22, device=hvd.device(),
                        dtype=torch.float32) % 1000
    # every rank leaves the barrier in the same cycle, so that both
    # halves submit at once (the exchange through the coordinator takes
    # ~1 ms: halves that start a few ms apart never overlap)
    hvd.barrier()
    handles = [hvd.allreduce_async(base + 7 * r + i, op=hvd.Sum,
                                   name=f"mp.groups.{i}", group=mine)
               for i in range(4)]
    for i, h in enumerate(handles):
        got = hvd.synchronize(h)
        want = sum(base + 7 * q + i for q in mine.ranks)
        if not torch.equal(got, want):
            raise AssertionError(f"group allreduce {i} on {mine.ranks}: "
                                 f"max abs err {max_err(got, want):.3e}")
    conc = groups.stats()["max_concurrent_groups"]
    if conc < len(made):
        raise AssertionError(f"groups: max_concurrent_groups {conc}, "
                             f"expected >= {len(made)}")
    return {"group_ranks": mine.ranks, "max_concurrent_groups": conc}


def zero_on_grid(layers=2, steps=3):
    """Phase 10 (a), ZeRO over the dp group of ``hvd.grid(dp=2, tp=2)``:
    the main path's model at ``layers``, both tp columns of a dp row fed
    the same rows; ``steps`` steps of ``ZeroDistributedOptimizer(AdamW,
    group=dp)``.  The parameters must end bitwise the same in both
    columns, and within rtol 1e-5 (atol 1e-6) of AdamW on this card over
    the dp rows' mean gradient.  -> the numbers."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import groups
    from horovod_tpu_torch.models import Transformer, lm_loss

    r, n = hvd.rank(), hvd.size()
    axes = _fit(n, dp=2, tp=2)
    grd = hvd.grid(**axes)
    dp_g, tp_g = grd.group("dp"), grd.group("tp")
    dpc = grd.coords(r)[0]
    tok = _rows(800, MP_PARITY_BATCH, dpc, axes["dp"])[0].to(hvd.device())
    model = Transformer(main_config(layers), seed=0)
    ref = [p.detach().clone().requires_grad_() for p in model.parameters()]
    ref_opt = torch.optim.AdamW(ref, lr=1e-4, weight_decay=1e-4)
    opt = hvd.ZeroDistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        group=dp_g)
    for _ in range(steps):
        opt.zero_grad()
        lm_loss(model(tok), tok).backward()
        mean = hvd.allreduce_gradients([p.grad for p in model.parameters()],
                                       group=dp_g)
        for p, g in zip(ref, mean):
            p.grad = g
        ref_opt.step()
        opt.step()
    flat = _flat_params(model)
    assert_close("ZeRO over the dp group against AdamW on one card", flat,
                 torch.cat([p.detach().reshape(-1) for p in ref]), 1e-5,
                 1e-6)
    cols = flat.new_empty((tp_g.size * flat.numel(),))
    _drain()
    dist.all_gather_into_tensor(cols, flat, group=groups.torch_group(tp_g))
    if not all(torch.equal(c, flat) for c in cols.chunk(tp_g.size)):
        raise AssertionError("ZeRO over the dp group: the tp columns' "
                             "parameters differ")
    return {"zero_axes": axes, "zero_shard": opt.shard.numel(),
            "zero_params": flat.numel(),
            "zero_max_err": max_err(flat, torch.cat(
                [p.detach().reshape(-1) for p in ref]))}


def _lm_steps(model, opt, tokens, steps, aux_weight=None):
    """``steps`` training steps, each timed on the host clock with the
    card synchronised around it; -> (losses, seconds)."""
    import torch

    from horovod_tpu_torch.models import apply_with_aux, lm_loss

    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        if aux_weight is None:
            loss = lm_loss(model(tokens), tokens)
        else:
            logits, aux = apply_with_aux(model, tokens)
            loss = lm_loss(logits, tokens) + aux_weight * aux
        loss.backward()
        opt.step()
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return losses, times


def _grad_parity(what, model, mesh, whole, dp_g, loss, want):
    """``model``'s gradients (this rank's blocks) averaged over ``dp_g``
    and its loss averaged over dp, against ``whole``'s on one card: loss
    rtol 1e-5, gradients rtol 1e-3 atol 1e-5 (phase 9's).  -> the largest
    gradient error."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import groups
    from horovod_tpu_torch.parallel.tensor_parallel import (params_shardings,
                                                            shard_tensor)

    grads = hvd.allreduce_gradients(
        {k: p.grad for k, p in model.named_parameters()}, group=dp_g)
    loss = loss.detach().clone()
    _drain()
    dist.all_reduce(loss, group=groups.torch_group(dp_g))
    loss = loss / dp_g.size
    assert_close(f"{what} loss", loss, want.detach(), 1e-5, 1e-5)
    shardings = params_shardings(whole, mesh)
    worst = 0.0
    for k, p in whole.named_parameters():
        block = shard_tensor(p.grad, shardings[k])
        assert_close(f"{what} grad {k}", grads[k], block, 1e-3, 1e-5)
        worst = max(worst, max_err(grads[k], block))
    return worst


def tp_run(axes, layers, profile=False):
    """Phase 10 (b), one grid: the main path's transformer split over
    ``tp`` (``Transformer(..., mesh=hvd.grid(**axes))``), ``[8, 2048]``
    tokens a dp replica, ``DistributedOptimizer(AdamW, group=dp)``,
    ``MP_STEPS`` steps: the first loss within phase 3's bf16 tolerance of
    the one-card model's on the same rows, the loss finite and falling,
    each kernel launched as phase 5's step launches it.  Then the
    two-layer fp32 check against one card.  With ``profile``, one more
    step under ``torch.profiler`` (``chiprun_out/profile_tp<tp>_rank<r>.txt``).
    -> the numbers."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer, lm_loss
    from horovod_tpu_torch.ops import cuda as kernels
    from horovod_tpu_torch.parallel.mesh import as_mesh

    r, dev = hvd.rank(), hvd.device()
    grd = hvd.grid(**axes)
    mesh, dp_g = as_mesh(grd), grd.group("dp")
    dpc = mesh.coords(r)["dp"]
    tok = _rows(900, MP_BATCH, dpc, axes["dp"])[0].to(dev)
    with torch.no_grad():
        whole = Transformer(main_config(layers), seed=0)
        want = lm_loss(whole(tok), tok)
        del whole
    model = Transformer(main_config(layers), seed=0, mesh=grd)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(), group=dp_g)
    _release()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times = _lm_steps(model, opt, tok, MP_STEPS)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_launches(f"tp {axes}", counts, per_step_launches(layers),
                    MP_STEPS)
    assert_close(f"tp {axes} first loss against one card",
                 torch.tensor(losses[0]), want.float().cpu(), *BF16_TOL)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"tp {axes}: losses {losses}")
    step = statistics.median(times[1:])
    profiled = _profile(lambda: _lm_steps(model, opt, tok, 1),
                        f"profile_tp{axes['tp']}_rank{r}.txt") \
        if profile else None
    del model, opt
    _release()

    old = _tf32_off()
    try:
        mine, every = _rows(901, MP_PARITY_BATCH, dpc, axes["dp"])
        mine, every = mine.to(dev), every.to(dev)
        cfg = main_config(2, dtype=torch.float32)
        model = Transformer(cfg, seed=0, mesh=grd)
        loss = lm_loss(model(mine), mine)
        loss.backward()
        whole = Transformer(cfg, seed=0)
        want32 = lm_loss(whole(every), every)
        want32.backward()
        worst = _grad_parity(f"tp {axes} two layers fp32", model, mesh,
                             whole, dp_g, loss, want32)
    finally:
        _tf32_restore(old)
    del model, whole
    _release()
    n = hvd.size()
    return {"axes": axes, "losses": losses, "step_s": times,
            "step_ms": step * 1e3, "first_loss_one_card": float(want),
            "tokens_per_s_per_gpu": axes["dp"] * MP_BATCH * MAIN_SEQ
            / step / n, "peak": peak, "counts": counts,
            "profiled_device_ms": profiled,
            "parity_loss": float(want32), "parity_max_err": worst}


def moe_run(layers, profile=False):
    """Phase 10 (c): the main path's transformer with every second block
    a switch-MoE block of ``N_EXPERTS`` experts (capacity factor 1.25,
    groups of 4096 tokens, C = 640) on ``make_mesh({"dp": 2, "ep": 2})``
    (each card holds ``N_EXPERTS / ep`` experts), ``[8, 2048]`` tokens a
    dp replica, ``DistributedOptimizer(AdamW, group=dp)``, loss
    ``lm_loss + 0.01 * aux``, ``MP_STEPS`` steps: finite and falling.
    Each MoE block's tokens an expert and the share dropped at the last
    step; then the two-layer fp32 check, the router's and the experts'
    gradients included.  -> the numbers."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (MoeMlp, Transformer,
                                          apply_with_aux, lm_loss)
    from horovod_tpu_torch.ops import cuda as kernels
    from horovod_tpu_torch.parallel import make_mesh

    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    axes = _fit(n, dp=2, ep=2)
    mesh = make_mesh(axes)
    dp_g = mesh.group("dp")
    dpc = mesh.coords(r)["dp"]
    tok = _rows(1000, MP_BATCH, dpc, axes["dp"])[0].to(dev)
    cfg = main_config(layers, moe_every=MOE_EVERY, n_experts=N_EXPERTS)
    model = Transformer(cfg, seed=0, mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(), group=dp_g)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times = _lm_steps(model, opt, tok, MP_STEPS, AUX_WEIGHT)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_launches(f"MoE {axes}", counts, per_step_launches(layers),
                    MP_STEPS)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"MoE {axes}: losses {losses}")
    experts = {name: {"kept": m.stats["kept"].tolist(),
                      "routed": m.stats["routed"].tolist(),
                      "dropped_share": float(m.stats["dropped"])
                      / m.stats["valid"]}
               for name, m in model.named_modules() if isinstance(m, MoeMlp)}
    step = statistics.median(times[1:])
    profiled = _profile(lambda: _lm_steps(model, opt, tok, 1, AUX_WEIGHT),
                        f"profile_moe_rank{r}.txt") if profile else None
    del model, opt
    _release()

    old = _tf32_off()
    try:
        mine, every = _rows(1001, MP_PARITY_BATCH, dpc, axes["dp"])
        mine, every = mine.to(dev), every.to(dev)
        cfg = main_config(2, dtype=torch.float32, moe_every=MOE_EVERY,
                          n_experts=N_EXPERTS)
        model = Transformer(cfg, seed=0, mesh=mesh)
        logits, aux = apply_with_aux(model, mine)
        loss = lm_loss(logits, mine) + AUX_WEIGHT * aux
        loss.backward()
        whole = Transformer(cfg, seed=0)
        logits, aux = apply_with_aux(whole, every)
        want32 = lm_loss(logits, every) + AUX_WEIGHT * aux
        want32.backward()
        worst = _grad_parity(f"MoE {axes} two layers fp32", model, mesh,
                             whole, dp_g, loss, want32)
    finally:
        _tf32_restore(old)
    del model, whole
    _release()
    return {"axes": axes, "params_per_gpu": n_params, "losses": losses,
            "step_s": times, "step_ms": step * 1e3,
            "tokens_per_s_per_gpu": axes["dp"] * MP_BATCH * MAIN_SEQ
            / step / n, "peak": peak, "counts": counts, "experts": experts,
            "profiled_device_ms": profiled, "parity_max_err": worst}


def _stage_fn(blocks, h):
    for block in blocks:
        h = block(h)
    return h


def _pipelined_lm(model, blocks, tokens, group=None):
    """The LM with ``blocks`` in the pipeline over ``group`` (None: on
    this card, microbatch after microbatch through the blocks in order):
    embedding and head on every stage (their
    inputs and outputs are the same there), the ``[M, T]`` batch as
    ``M`` microbatches of ``[1, T]``.  -> (the loss, the blocks'
    output)."""
    import torch

    from horovod_tpu_torch.models import lm_loss
    from horovod_tpu_torch.parallel import pipeline_apply

    m, t = tokens.shape
    x = model.embed(tokens) + model.pos_embed(
        torch.arange(t, device=tokens.device))
    if group is None:   # the same microbatches, one after another
        h = torch.cat([_stage_fn(blocks, x[i:i + 1]) for i in range(m)])
    else:
        h = pipeline_apply(_stage_fn, blocks, x[:, None], group=group)[:, 0]
    logits = model.lm_head(model.ln_f(h).to(model.cfg.dtype))
    return lm_loss(logits, tokens), h


def pipeline_run(layers, profile=False):
    """Phase 10 (d): the main path's 8 blocks as ``S = min(cards, 4)``
    stages (``make_mesh({"pp": S})``), ``PIPE_MICRO`` microbatches of
    ``[1, 2048]``.  First the LM in fp32 (TF32 off) with its blocks
    pipelined, against the same LM with its blocks in order on this card:
    the loss (rtol 1e-5) and the blocks' outputs (rtol 1e-4 atol 1e-5,
    phase 4's), this stage's blocks' gradients and the embedding's and
    head's (rtol 1e-3 atol 1e-5, phase 9's).  Then the bf16 LM with its
    blocks pipelined, AdamW, ``MP_STEPS`` steps: finite and falling,
    each kernel launched as ``layers / S`` blocks times ``M`` ticks
    launch it, beside the one-card step of the same LM and the bubble
    bound (M + S - 1) / M.  -> the numbers."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.ops import cuda as kernels
    from horovod_tpu_torch.parallel import make_mesh

    n, dev = hvd.size(), hvd.device()
    s = _fit(n, pp=4)["pp"]
    mesh = make_mesh({"pp": s})
    pp_g = mesh.group("pp")
    idx, per, m = pp_g.rank(), layers // s, PIPE_MICRO
    mine = range(idx * per, (idx + 1) * per)

    tok = _rows(1200, m)[0].to(dev)
    old = _tf32_off()
    try:
        cfg = main_config(layers, dtype=torch.float32)
        model = Transformer(cfg, seed=0)
        loss, out = _pipelined_lm(
            model, [getattr(model, f"block_{i}") for i in mine], tok, pp_g)
        loss.backward()
        whole = Transformer(cfg, seed=0)
        want, h = _pipelined_lm(
            whole, [getattr(whole, f"block_{i}") for i in range(layers)],
            tok)
        want.backward()
        assert_close("pipeline fp32 loss", loss, want, 1e-5, 1e-5)
        assert_close("pipeline fp32 outputs", out, h, 1e-4, 1e-5)
        worst = 0.0
        grads = dict(whole.named_parameters())
        for k, p in model.named_parameters():
            if k.startswith("block_") and int(k.split(".")[0][6:]) \
                    not in mine:
                continue   # another stage's block
            assert_close(f"pipeline fp32 grad {k}", p.grad, grads[k].grad,
                         1e-3, 1e-5)
            worst = max(worst, max_err(p.grad, grads[k].grad))
        out_err = max_err(out, h)
    finally:
        _tf32_restore(old)
    del model, whole, out, h, loss, want
    _release()

    model = Transformer(main_config(layers), seed=0)
    blocks = [getattr(model, f"block_{i}") for i in mine]
    params = [p for name, p in model.named_parameters()
              if not name.startswith("block_")] + \
        [p for b in blocks for p in b.parameters()]
    opt = torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times = [], []

    def pipe_step():
        opt.zero_grad(set_to_none=True)
        loss = _pipelined_lm(model, blocks, tok, pp_g)[0]
        loss.backward()
        opt.step()
        return loss

    for _ in range(MP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(pipe_step().item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_launches("pipeline", counts, per_step_launches(per * m),
                    MP_STEPS)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"pipeline: losses {losses}")
    step = statistics.median(times[1:])
    profiled = _profile(pipe_step, f"profile_pp_rank{pp_g.rank()}.txt") \
        if profile else None
    del model, opt, blocks, params
    _release()

    whole = Transformer(main_config(layers), seed=0)
    opt = torch.optim.AdamW(whole.parameters(), lr=1e-4, weight_decay=1e-4)
    one = _lm_steps(whole, opt, tok, MP_STEPS)[1]
    one_step = statistics.median(one[1:])
    del whole, opt
    _release()
    bubble = (m + s - 1) / m
    return {"stages": s, "blocks_per_stage": per, "micro": m,
            "fp32_out_max_err": out_err, "fp32_grad_max_err": worst,
            "losses": losses, "step_s": times, "step_ms": step * 1e3,
            "one_card_step_ms": one_step * 1e3, "bubble_bound": bubble,
            "ideal_step_ms": one_step * 1e3 / s * bubble,
            "tokens_per_s_per_gpu": m * MAIN_SEQ / step / s, "peak": peak,
            "counts": counts, "profiled_device_ms": profiled}


def model_parallel_checks(layers, profile=False):
    """Phase 10 on this rank, ``hvd.init()`` done; each part's wall
    seconds kept.  ``profile``: one profiled step of each training run."""
    import horovod_tpu_torch as hvd

    n = hvd.size()
    res = {"rank": hvd.rank(), "world": n, "wall_s": {}}
    parts = [("groups", groups_on_card), ("zero", zero_on_grid),
             ("tp_dp2", lambda: {"tp_dp2": tp_run(_fit(n, dp=2, tp=2),
                                                  layers, profile)}),
             ("tp_tp4", lambda: {"tp_tp4": tp_run(_fit(n, dp=1, tp=4),
                                                  layers, profile)}),
             ("moe", lambda: {"moe": moe_run(layers, profile)}),
             ("pipeline", lambda: {"pipeline": pipeline_run(layers,
                                                            profile)})]
    for name, part in parts:
        print(f"model parallel rank {res['rank']}: {name}", flush=True)
        t0 = time.perf_counter()
        res.update(part())
        _release()
        res["wall_s"][name] = time.perf_counter() - t0
    return res


def model_parallel_phase(smi, profile=False):
    """Phase 10: :func:`model_parallel_checks` at ``min(cards, 4)``
    ranks.  -> the ranks' results."""
    results = in_ranks("model", LAYERS, profile)
    for res in results:
        n = res["world"]
        head = f"model parallel rank {res['rank']} of {n}"
        if n == 1:
            print(f"{head}: one card: tp, ep and pp have size 1 (the "
                  f"single-rank path of each)", flush=True)
        print(f"{head}: groups {res['group_ranks']} exact, "
              f"max_concurrent_groups {res['max_concurrent_groups']}; ZeRO "
              f"over dp of {res['zero_axes']}: {res['zero_params']} "
              f"parameters, max abs err against AdamW on one card "
              f"{res['zero_max_err']:.3e}, tp columns bitwise equal",
              flush=True)
        for key in ("tp_dp2", "tp_tp4"):
            tp = res[key]
            print(f"{head}: tp {tp['axes']}: losses "
                  f"{[round(x, 4) for x in tp['losses']]} (one card "
                  f"{tp['first_loss_one_card']:.4f}), step "
                  f"{tp['step_ms']:.2f} ms (s {[round(x, 4) for x in tp['step_s']]}), "
                  f"{tp['tokens_per_s_per_gpu']:.1f} tokens/s per GPU, peak "
                  f"{tp['peak'] / 2**30:.2f} GiB; two layers fp32 max abs "
                  f"gradient err {tp['parity_max_err']:.3e}; launches "
                  f"{tp['counts']} on {smi}", flush=True)
        moe = res["moe"]
        print(f"{head}: MoE {moe['axes']} ({moe['params_per_gpu']} "
              f"parameters a GPU): losses "
              f"{[round(x, 4) for x in moe['losses']]}, step "
              f"{moe['step_ms']:.2f} ms, {moe['tokens_per_s_per_gpu']:.1f} "
              f"tokens/s per GPU, peak {moe['peak'] / 2**30:.2f} GiB; two "
              f"layers fp32 max abs gradient err "
              f"{moe['parity_max_err']:.3e}; launches {moe['counts']} on "
              f"{smi}", flush=True)
        for name, e in moe["experts"].items():
            print(f"{head}: MoE {name}: tokens kept an expert {e['kept']}, "
                  f"routed {e['routed']}, dropped "
                  f"{100 * e['dropped_share']:.2f}%", flush=True)
        pp = res["pipeline"]
        print(f"{head}: pipeline {pp['stages']} stages x "
              f"{pp['blocks_per_stage']} blocks, {pp['micro']} microbatches: "
              f"fp32 max abs err out {pp['fp32_out_max_err']:.3e}, grads "
              f"{pp['fp32_grad_max_err']:.3e}; bf16 losses "
              f"{[round(x, 4) for x in pp['losses']]}, step "
              f"{pp['step_ms']:.2f} ms against one card's "
              f"{pp['one_card_step_ms']:.2f} ms / {pp['stages']} x bubble "
              f"bound {pp['bubble_bound']:.3f} = {pp['ideal_step_ms']:.2f} "
              f"ms, {pp['tokens_per_s_per_gpu']:.1f} tokens/s per GPU, peak "
              f"{pp['peak'] / 2**30:.2f} GiB; launches {pp['counts']} on "
              f"{smi}", flush=True)
        profiled = {k: res[k]["profiled_device_ms"]
                    for k in ("tp_dp2", "tp_tp4", "moe", "pipeline")}
        if any(v is not None for v in profiled.values()):
            print(f"{head}: profiled step device busy ms {profiled} "
                  f"(profile_*_rank{res['rank']}.txt)", flush=True)
        print(f"{head}: wall s "
              f"{ {k: round(v, 2) for k, v in res['wall_s'].items()} }",
              flush=True)
    return results


# ------------------------------------------------------------------ phase 11
# (a) the fast group of hierarchical Adasum at four ranks
HIER_LOCAL = 2
# Adasum's tolerances against the float64 reference (tests/test_collectives.py
# :253 for fp32, tests/test_dtype_matrix.py:149 for bf16; fp16 tighter than
# the dtype matrix's 2e-2)
ADASUM_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 5e-2),
              "float16": (1e-2, 1e-2)}
# (b) checked steps of each Adasum path, then blocks of steps in turns
ADASUM_STEPS, ADASUM_BLOCK_STEPS, ADASUM_PAIRS = 5, 4, 3
# (c) the uninterrupted runs' steps, the step the first elastic run stops
# after (its newest checkpoint is the interval's multiple below), the
# checkpoint interval
CKPT_STEPS, CKPT_STOP, CKPT_INTERVAL = 6, 5, 2
# (d) batches a rank holds, steps a timed window, rounds of the three feeds
PIPE_BATCHES, PIPE_STEPS, PIPE_PAIRS = 4, 10, 3


def _pow2_world():
    """Ranks of phase 11: the largest power of two <= min(cards, 4)."""
    world = _world()
    return 1 << (world.bit_length() - 1)


def _scratch_dir():
    """Where phase 11 writes its checkpoints (GBs): inside the checkout,
    beside the output directory, which keeps only logs and results."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "smoke_scratch")


def _model_grads(layers, seed):
    """fp32 gradients of the shapes of phase 5's parameters, from seeds."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer

    dev = hvd.device()
    shapes = [p.shape for p in Transformer(main_config(layers), device=dev,
                                           seed=0).parameters()]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev) for s in shapes]


def adasum_eager_checks(layers, hier=False):
    """Phase 11 (a) on this rank, ``hvd.init()`` done: the eager plane's
    Adasum, each rank with values of its own (every rank makes every
    rank's from seeds): ``allreduce`` in fp32, bf16 and fp16,
    ``grouped_allreduce``, ``allreduce_``, and (flat, above one rank) with
    the last rank joined and over each half of the world as a process
    group; each held to ``adasum_reference`` in float64 on the host (of
    the local groups' averages when ``hier``), and bitwise the same on
    every rank.  Then the grouped Adasum allreduce of phase 5's
    169,904,128 fp32 gradients beside the Sum one, in turns.  -> the
    rank's numbers."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.adasum import adasum_reference

    dev, r, n = hvd.device(), hvd.rank(), hvd.size()
    checked, errs = [], {}

    def every(shape, dtype, seed):
        return [torch.randn(shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed * 1009 + q)).to(dtype)
            for q in range(n)]

    def leaves(xs):
        """The reference's operands: every rank's, or the local groups'
        averages."""
        if not hier:
            return xs
        return [sum(x.double() for x in xs[c:c + HIER_LOCAL]) / HIER_LOCAL
                for c in range(0, n, HIER_LOCAL)]

    def expect(what, got, xs, group=None):
        name = str(got.dtype).replace("torch.", "")
        want = adasum_reference([x.double().cpu().numpy() for x in xs])
        err = np.abs(got.double().cpu().numpy() - want)
        rtol, atol = ADASUM_TOL[name]
        if not np.all(err <= atol + rtol * np.abs(want)):
            raise AssertionError(f"adasum {what}: max abs err "
                                 f"{err.max():.3e} against the reference")
        _same_on_every_rank(f"adasum {what}", got, group)
        errs[what] = float(err.max())
        checked.append(what)

    dtypes = ("float32",) if hier else ("float32", "bfloat16", "float16")
    for i, name in enumerate(dtypes):
        xs = every((1 << 16,), getattr(torch, name), 10 + i)
        expect(name, hvd.allreduce(xs[r], op=hvd.Adasum,
                                   name=f"p11.{name}"), leaves(xs))
    many = [every(s, torch.float32, 20 + i)
            for i, s in enumerate([(4096,), (33, 129), (1000,)])]
    outs = hvd.grouped_allreduce([xs[r] for xs in many], op=hvd.Adasum,
                                 name="p11.grouped")
    for i, (out, xs) in enumerate(zip(outs, many)):
        expect(f"grouped[{i}]", out, leaves(xs))
    xs = every((3, 1000), torch.float32, 30)
    t = xs[r].clone()
    hvd.allreduce_(t, op=hvd.Adasum, name="p11.inplace")
    expect("in place", t, leaves(xs))
    if n > 1 and not hier:
        xs = every((5000,), torch.float32, 40)
        handle = None
        if r != n - 1:
            handle = hvd.allreduce_async(xs[r], op=hvd.Adasum,
                                         name="p11.joined")
        hvd.join()
        if handle is not None:
            expect("joined", hvd.synchronize(handle),
                   xs[:-1] + [torch.zeros_like(xs[-1])])
        else:
            _same_on_every_rank("adasum joined", None, like=xs[-1])
        halves = [list(range(n // 2)), list(range(n // 2, n))]
        pgs = [hvd.new_group(h, name=f"p11.half.{i}")
               for i, h in enumerate(halves)]
        mine = r // (n // 2)
        xs = every((7000,), torch.float32, 50)
        expect(f"group {halves[mine]}", hvd.allreduce(
            xs[r], op=hvd.Adasum, group=pgs[mine], name="p11.half"),
            [xs[q] for q in halves[mine]], group=pgs[mine])

    grads = _model_grads(layers, 100 + r)
    nbytes = sum(g.numel() * g.element_size() for g in grads)
    out = hvd.grouped_allreduce(grads, op=hvd.Adasum, name="p11.grads")
    torch.cuda.synchronize()
    if not all(torch.isfinite(o).all() for o in out):
        raise AssertionError("adasum of the model's gradients: non-finite")
    _same_on_every_rank("adasum of the model's gradients", out[0])
    del out

    def timed(fn, iters=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    ada_ms, sum_ms = [], []
    for _ in range(3):
        ada_ms.append(timed(lambda: hvd.grouped_allreduce(
            grads, op=hvd.Adasum, name="p11.grads")))
        sum_ms.append(timed(lambda: hvd.grouped_allreduce(
            grads, op=hvd.Sum, name="p11.grads.sum")))
    ada, summed = statistics.median(ada_ms), statistics.median(sum_ms)
    return {"checks": checked, "max_abs_err": errs,
            "params": sum(g.numel() for g in grads), "bytes": nbytes,
            "adasum_ms": ada, "adasum_gb_s": nbytes / ada / 1e6,
            "sum_ms": summed, "sum_gb_s": nbytes / summed / 1e6,
            "adasum_ms_turns": ada_ms, "sum_ms_turns": sum_ms}


def adasum_training(layers):
    """Phase 11 (b): phase 5's transformer, each rank on a batch of its
    own, ``ADASUM_STEPS`` steps under ``DistributedOptimizer(AdamW,
    op=Adasum)``, then as many of ``allreduce_gradients(op=Adasum)`` and
    AdamW: the loss finite and falling, every rank's parameters bitwise
    the same after each step, every kernel launched at phase 5's count a
    step; then both beside ``op=Average`` in blocks of steps in turns.
    -> the numbers and the first path's launch counts."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer, lm_loss
    from horovod_tpu_torch.ops import cuda as kernels

    r = hvd.rank()
    tokens = torch.from_numpy(np.random.RandomState(100 + r).randint(
        0, VOCAB, (MAIN_BATCH, MAIN_SEQ))).to(hvd.device())

    def adamw(model):
        return torch.optim.AdamW(model.parameters(), lr=1e-4,
                                 weight_decay=1e-4)

    def grads_step(model, opt):
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model(tokens), tokens)
        loss.backward()
        params = list(model.parameters())
        for p, g in zip(params, hvd.allreduce_gradients(
                [p.grad for p in params], op=hvd.Adasum)):
            p.grad = g
        opt.step()
        return loss.detach()

    models, steps, res = {}, {}, {}
    for name in ("do_adasum", "allreduce_gradients_adasum", "do_average"):
        model = models[name] = Transformer(main_config(layers), seed=0)
        if name == "allreduce_gradients_adasum":
            opt = adamw(model)
            steps[name] = lambda m=model, o=opt: grads_step(m, o)
        else:
            opt = hvd.DistributedOptimizer(
                adamw(model), named_parameters=model.named_parameters(),
                op=hvd.Adasum if name == "do_adasum" else hvd.Average)
            steps[name] = lambda m=model, o=opt: _lm_step(m, o, tokens)
    for name in ("do_adasum", "allreduce_gradients_adasum"):
        kernels.reset_launch_counts()
        losses = []
        for s in range(ADASUM_STEPS):
            losses.append(float(steps[name]()))
            _same_on_every_rank(f"{name} step {s} parameters",
                        _flat_params(models[name]))
        counts = kernels.launch_counts()
        expect_launches(name, counts, per_step_launches(layers),
                        ADASUM_STEPS)
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: losses {losses}")
        res[name] = {"losses": losses, "counts": counts}
    turns = _blocks_in_turns(steps, ADASUM_BLOCK_STEPS, ADASUM_PAIRS)
    for name, (medians, _) in turns.items():
        res.setdefault(name, {})["step_ms_blocks"] = medians
        res[name]["step_ms"] = statistics.median(medians)
    return res


def durable_resume(layers):
    """Phase 11 (c): phase 5's transformer under ``DistributedOptimizer``
    (AdamW), each rank on batches of its own, a function of the step.
    Two uninterrupted runs of ``CKPT_STEPS`` steps; then ``elastic.run``
    with ``HVD_TPU_CKPT_DIR`` (interval ``CKPT_INTERVAL``) for
    ``CKPT_STOP`` steps, a commit each; then a new model (another seed),
    optimizer, state and manager: ``run`` resumes from the newest
    checkpoint and trains to ``CKPT_STEPS``.  Its parameters must equal
    the uninterrupted run's, bitwise where the two uninterrupted runs
    are bitwise the same, else within their gap.  -> the numbers."""
    import shutil

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer

    r = hvd.rank()
    directory = os.path.join(_scratch_dir(), "ckpt")
    if r == 0:
        shutil.rmtree(directory, ignore_errors=True)
    hvd.barrier(name="p11.ckpt.clean")

    def batch(step):
        return torch.from_numpy(np.random.RandomState(1000 * r + step)
                                .randint(0, VOCAB, (MAIN_BATCH, MAIN_SEQ))
                                ).to(hvd.device())

    def build(seed):
        model = Transformer(main_config(layers), seed=seed)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())
        return model, opt

    def uninterrupted():
        model, opt = build(0)
        for s in range(CKPT_STEPS):
            _lm_step(model, opt, batch(s))
        torch.cuda.synchronize()
        flat = _flat_params(model).clone()
        del model, opt
        _release()
        return flat

    plain, again = uninterrupted(), uninterrupted()
    plain_gap = max_err(plain, again)
    del again
    commit_s, managers = [], []

    def train_to(last, model, opt):
        def fn(state):
            entered = time.perf_counter()
            resumed = state.step
            managers.append(state._ckpt)
            while state.step < last:
                _lm_step(model, opt, batch(state.step))
                state.step += 1
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state.commit()
                commit_s.append(time.perf_counter() - t0)
            return resumed, entered
        return fn

    os.environ["HVD_TPU_CKPT_DIR"] = directory
    os.environ["HVD_TPU_CKPT_INTERVAL"] = str(CKPT_INTERVAL)
    try:
        model, opt = build(0)
        state = hvd.elastic.State(params=model, optimizer_state=opt)
        hvd.elastic.run(train_to(CKPT_STOP, model, opt), state)
        del model, opt, state
        _release()
        model, opt = build(1)
        state = hvd.elastic.State(params=model, optimizer_state=opt)
        t0 = time.perf_counter()
        resumed, entered = hvd.elastic.run(
            train_to(CKPT_STEPS, model, opt), state)
        resume_s = entered - t0
        torch.cuda.synchronize()
        gap = max_err(_flat_params(model), plain)
    finally:
        del os.environ["HVD_TPU_CKPT_DIR"]
        del os.environ["HVD_TPU_CKPT_INTERVAL"]
    if resumed != CKPT_STOP - CKPT_STOP % CKPT_INTERVAL:
        raise AssertionError(f"resumed from step {resumed}")
    if gap > plain_gap:
        raise AssertionError(f"resumed run {gap:.3e} from the uninterrupted "
                             f"one, whose two runs differ by {plain_gap:.3e}")
    writes = [w for m in managers for w in m.writes]
    if any(m.errors for m in managers) or not writes:
        raise AssertionError(f"checkpoint writes {writes}")
    hvd.barrier(name="p11.ckpt.done")
    if r == 0:
        shutil.rmtree(directory, ignore_errors=True)
    return {"resumed_from": resumed, "max_abs_err": gap,
            "uninterrupted_gap": plain_gap, "commit_s": commit_s,
            "writes": writes, "resume_s": resume_s}


def input_pipeline():
    """Phase 11 (d): phase 7's ResNet-50 step (batch 64, 224x224x3, bf16,
    ``DistributedOptimizer(SGD(0.1, momentum=0.9))``) fed three ways in
    turns, ``PIPE_PAIRS`` windows of ``PIPE_STEPS`` steps each: from
    ``BatchIterator`` (shuffled, over ``PIPE_BATCHES`` batches of this
    rank's own images on the host) through ``prefetch_to_device``, from
    the same iterator copied to the card in the loop, and from one batch
    resident on the card.  The prefetched batches must equal the host
    batches, over an epoch and a batch.  -> images/s of each."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import train_cnn
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.utils.data import BatchIterator, prefetch_to_device

    r, dev = hvd.rank(), hvd.device()
    batch, image = CNN_SIZES["resnet50"]
    rng = np.random.default_rng(200 + r)
    data = {"x": rng.standard_normal((PIPE_BATCHES * batch, image, image, 3),
                                     dtype=np.float32),
            "y": rng.integers(0, 1000, PIPE_BATCHES * batch)}

    def batches():
        return iter(BatchIterator(data, batch, shuffle=True, seed=r,
                                  epochs=None))

    staged = prefetch_to_device(batches(), size=2)
    host = batches()
    for i in range(PIPE_BATCHES + 1):
        h, d = next(host), next(staged)
        if d["x"].device != dev or not all(
                torch.equal(d[k].cpu(), torch.from_numpy(h[k]))
                for k in ("x", "y")):
            raise AssertionError(f"prefetched batch {i} is not the host's")

    torch.backends.cudnn.benchmark = True
    try:
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
        opt = train_cnn.make_optimizer(model)
        resident = next(staged)

        def feed(kind):
            if kind == "prefetch":
                return next(staged)
            if kind == "host":
                b = next(host)
                return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            return resident

        losses = [train_cnn.train_step(model, opt, resident["x"],
                                       resident["y"])
                  for _ in range(CNN_WARMUP)]
        windows = {k: [] for k in ("prefetch", "host", "resident")}
        for _ in range(PIPE_PAIRS):
            for kind in windows:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(PIPE_STEPS):
                    b = feed(kind)
                    losses.append(train_cnn.train_step(model, opt, b["x"],
                                                       b["y"]))
                torch.cuda.synchronize()
                windows[kind].append(time.perf_counter() - t0)
        losses = torch.stack(losses).tolist()
    finally:
        staged.close()
        torch.backends.cudnn.benchmark = False
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"input pipeline: losses {losses}")
    return {"images_per_s": {k: [batch * PIPE_STEPS / w for w in ws]
                             for k, ws in windows.items()},
            "checked_batches": PIPE_BATCHES + 1,
            "loss_first_last": (losses[0], losses[-1])}


def adasum_checks(layers):
    """Phase 11 on this rank, ``hvd.init()`` done: (a)-(d).  -> the
    rank's numbers."""
    import horovod_tpu_torch as hvd

    res = {"rank": hvd.rank(), "world": hvd.size(), "wall_s": {}}
    for name, fn in [("eager", lambda: adasum_eager_checks(layers)),
                     ("training", lambda: adasum_training(layers)),
                     ("resume", lambda: durable_resume(layers)),
                     ("pipeline", input_pipeline)]:
        t0 = time.perf_counter()
        res[name] = fn()
        _release()
        res["wall_s"][name] = time.perf_counter() - t0
    return res


def adasum_hier_checks(layers):
    """Phase 11 (a) under ``HVD_ADASUM_HIERARCHICAL=1`` and
    ``HVD_HIER_LOCAL_SIZE=2``."""
    import horovod_tpu_torch as hvd

    return {"rank": hvd.rank(), "world": hvd.size(),
            "eager": adasum_eager_checks(layers, hier=True)}


def adasum_phase(smi):
    """Phase 11: :func:`adasum_checks` at ``_pow2_world()`` ranks, then at
    four the hierarchical (a).  -> the ranks' results."""
    world = _pow2_world()
    results = in_ranks("adasum", LAYERS, world=world)
    hier = []
    if world == 4:
        hier = in_ranks("adasum_hier", LAYERS, world=4, env={
            "HVD_ADASUM_HIERARCHICAL": "1",
            "HVD_HIER_LOCAL_SIZE": str(HIER_LOCAL)})
    for mode, res in [("flat", x) for x in results] + [
            ("hierarchical", x) for x in hier]:
        n, e = res["world"], res["eager"]
        head = f"adasum rank {res['rank']} of {n}"
        print(f"{head} ({mode}): {len(e['checks'])} checks against the "
              f"float64 reference, max abs err "
              f"{ {k: f'{v:.3e}' for k, v in e['max_abs_err'].items()} }",
              flush=True)
        print(f"{head} ({mode}): grouped_allreduce of {e['params']} fp32 "
              f"gradients: Adasum {e['adasum_ms']:.3f} ms "
              f"({e['adasum_gb_s']:.1f} GB/s; turns "
              f"{[round(t, 3) for t in e['adasum_ms_turns']]}), Sum "
              f"{e['sum_ms']:.3f} ms ({e['sum_gb_s']:.1f} GB/s; turns "
              f"{[round(t, 3) for t in e['sum_ms_turns']]}) on {smi}",
              flush=True)
    if world < 4:
        print(f"adasum: hierarchical Adasum needs four ranks (two local "
              f"groups of {HIER_LOCAL}); {world} here", flush=True)
    for res in results:
        head = f"adasum rank {res['rank']} of {res['world']}"
        t = res["training"]
        for name in ("do_adasum", "allreduce_gradients_adasum",
                     "do_average"):
            losses = t[name].get("losses")
            print(f"{head}: {name}: step {t[name]['step_ms']:.2f} ms (block "
                  f"medians {[round(x, 2) for x in t[name]['step_ms_blocks']]}"
                  f" in turns)" + (f", losses {[round(x, 4) for x in losses]}"
                                   if losses else "") + f" on {smi}",
                  flush=True)
        c = res["resume"]
        print(f"{head}: durable resume from step {c['resumed_from']}: max "
              f"abs err {c['max_abs_err']:.3e} against an uninterrupted run "
              f"(two uninterrupted runs differ by "
              f"{c['uninterrupted_gap']:.3e}); commit s "
              f"{[round(x, 3) for x in c['commit_s']]}; writes (step, bytes, "
              f"s) {[(s, b, round(x, 3)) for s, b, x in c['writes']]}; "
              f"restore and sync {c['resume_s']:.3f} s on {smi}", flush=True)
        p = res["pipeline"]
        print(f"{head}: ResNet-50 images/s per GPU: "
              f"{ {k: [round(x, 1) for x in v] for k, v in p['images_per_s'].items()} }"
              f" ({p['checked_batches']} prefetched batches equal the host's;"
              f" loss {p['loss_first_last'][0]:.4f} -> "
              f"{p['loss_first_last'][1]:.4f}) on {smi}", flush=True)
        print(f"{head}: wall s "
              f"{ {k: round(v, 2) for k, v in res['wall_s'].items()} }",
              flush=True)
    return results, hier


# phase 12: the launcher's grace window (HVD_TPU_TERM_GRACE) in (c), and
# the HMAC timing's message size and repeats
TERM_GRACE_S, HMAC_BYTES, HMAC_REPEATS = 5.0, 4096, 1000


def _launcher_argv(world, logs, phase, layers=LAYERS, extra=()):
    """``python -m horovod_tpu_torch.run -np world ...`` starting
    ``--rank-of phase layers`` of this script on every rank."""
    return ([sys.executable, "-m", "horovod_tpu_torch.run", "-np",
             str(world), "--output-filename", logs, *extra]
            + _rank_argv(phase, layers))


def _launcher_cli(world, logs, phase, layers=LAYERS, extra=(),
                  timeout=900, env=None):
    """Run the launcher CLI from the repository's root with ``env`` added
    to this process's environment; -> (its exit code, its stdout and
    stderr)."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(_launcher_argv(world, logs, phase, layers,
                                           extra),
                            cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, **(env or {})})
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        # SIGTERM: the launcher forwards it to its ranks and kills what
        # outlives the grace window
        proc.terminate()
        out, err = proc.communicate(timeout=60)
        raise AssertionError(f"{phase}: the launcher ran past {timeout} s:"
                             f"\n{(out + err)[-4000:]}") from None
    os.makedirs(logs, exist_ok=True)
    with open(os.path.join(logs, "launcher.log"), "w") as f:
        f.write(out + "\n--- stderr ---\n" + err)
    return proc.returncode, out + err


def _jobs(fn, jobs, side):
    """``{name: args}`` -> ``{name: callable}`` whose call returns
    ``fn(*args)``.  With ``side`` every job starts now, all side by side,
    each in a thread of its own, and a call waits for its job: jobs
    that check faults or results, whose times no check reads, share the
    host's cores and the cards.  Else each job starts when it is
    called."""
    if not side:
        return {k: functools.partial(fn, *a) for k, a in jobs.items()}
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(len(jobs))
    futures = {k: pool.submit(fn, *a) for k, a in jobs.items()}
    pool.shutdown(wait=False)
    return {k: f.result for k, f in futures.items()}


def launcher_train(layers):
    """Phase 12 (a) on one rank that ``python -m horovod_tpu_torch.run``
    started: phase 5's main path (``hvd.init()`` on the launcher's
    contract, the full-width transformer, ``DistributedOptimizer(AdamW(
    1e-4, wd 1e-4))``, ``[8, 2048]`` tokens a GPU, each rank its own),
    ``STEPS`` steps.  The loss must be finite and fall, every kernel
    launch its count a step, and the parameters be bitwise the same on
    every rank.  -> the rank's numbers, with the wall-clock times at
    which its interpreter had started (``T_PROCESS``), it had imported
    torch and the port, and its ``hvd.init()`` returned."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.ops import cuda as kernels

    imported = time.time()
    hvd.init()
    init_done = time.time()
    try:
        r, n = hvd.rank(), hvd.size()
        model = Transformer(main_config(layers), seed=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        tokens = torch.from_numpy(np.random.RandomState(r).randint(
            0, VOCAB, (MAIN_BATCH, MAIN_SEQ))).to(hvd.device())
        kernels.reset_launch_counts()
        logits, losses, times = _timed_steps(model, opt, tokens, STEPS)
        counts = kernels.launch_counts()
        if tuple(logits.shape) != (MAIN_BATCH, MAIN_SEQ, VOCAB):
            raise AssertionError(f"logits shape {tuple(logits.shape)}")
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        del logits
        _same_on_every_rank("phase 12 parameters", _flat_params(model))
        controller = basics._get_state().controller
        negotiation, hmac_s = (controller.negotiation_times(),
                               controller.hmac_times())
    finally:
        hvd.shutdown()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"rank {r}: loss not finite or not falling: "
                             f"{losses}")
    expect_launches(f"launched rank {r}", counts, per_step_launches(layers),
                    STEPS)
    return {"rank": r, "world": n, "started": T_PROCESS,
            "imported": imported, "init_done": init_done,
            "losses": losses, "step_s": times, "counts": counts,
            "cycles": len(negotiation),
            "negotiation_ms_median": (1e3 * statistics.median(negotiation)
                                      if negotiation else None),
            "hmac_ms_median": (1e3 * statistics.median(hmac_s)
                               if hmac_s else None)}


def launcher_fail(layers):
    """Phase 12 (c) on one rank: after ``hvd.init()`` and one allreduce
    (every rank's init done), the last rank exits with 3; the others
    print their pids and wait to be terminated."""
    import torch

    import horovod_tpu_torch as hvd

    hvd.init()
    r, n = hvd.rank(), hvd.size()
    hvd.allreduce(torch.ones(1, device=hvd.device()), name="p12.ready")
    print(f"PID {os.getpid()}", flush=True)
    if r == n - 1:
        os._exit(3)
    time.sleep(RANK_WATCHDOG_S)
    raise AssertionError(f"rank {r} was not terminated")


def _trip(marker):
    """Unpickling a ``_Tripwire`` calls this: it must never run."""
    with open(marker, "w") as f:
        f.write(str(os.getpid()))
    return "unpickled"


class _Tripwire:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return _trip, (self.marker,)


def launcher_key(layers):
    """Phase 12 (d) on one rank: the last rank sets another
    ``HVD_SECRET_KEY`` before ``hvd.init()``; every rank then calls
    ``broadcast_object`` of an object whose unpickling would leave a
    file.  -> the rank's error (None if the call returned)."""
    import base64

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.run.service import secret

    if int(os.environ["HVD_RANK"]) == int(os.environ["HVD_SIZE"]) - 1:
        os.environ["HVD_SECRET_KEY"] = base64.b64encode(
            secret.make_secret_key()).decode()
    hvd.init()
    r = hvd.rank()
    marker = os.path.join(_out_dir(), "launcher", "key", f"tripped.{r}")
    try:
        hvd.broadcast_object(_Tripwire(marker), root_rank=0, name="p12.key")
        error = None
    except Exception as exc:  # noqa: BLE001 — the failure is the result
        error = f"{type(exc).__name__}: {exc}"
    finally:
        hvd.shutdown()
    return {"rank": r, "error": error, "tripped": os.path.exists(marker)}


def run_fn_allreduce():
    """Phase 12 (b), shipped by ``run(fn)``: ``hvd.init()``, then an
    allreduce of ``rank + 1`` on the card.  -> (rank, the sum)."""
    import torch

    import horovod_tpu_torch as hvd

    hvd.init()
    try:
        t = torch.full((1 << 20,), float(hvd.rank() + 1),
                       device=hvd.device())
        total = hvd.allreduce(t, op=hvd.Sum, name="p12.run_fn")
        if not torch.equal(total, torch.full_like(t, total[0].item())):
            raise AssertionError("allreduce result not uniform")
        return hvd.rank(), total[0].item()
    finally:
        hvd.shutdown()


def _alive(pid):
    """Running and not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def _hmac_us():
    """Host time of the cycle's HMAC on a message of ``HMAC_BYTES``:
    median of ``HMAC_REPEATS`` sign + check pairs, in us."""
    from horovod_tpu_torch.run.service import secret

    key, msg = secret.make_secret_key(), os.urandom(HMAC_BYTES)
    times = []
    for _ in range(HMAC_REPEATS):
        t0 = time.perf_counter()
        if not secret.check(key, msg, secret.sign(key, msg)):
            raise AssertionError("HMAC check failed on its own digest")
        times.append(time.perf_counter() - t0)
    return 1e6 * statistics.median(times)


def launcher_phase(smi, phase5_step_ms, phase6_negotiation_ms):
    """Phase 12 at ``world = _world()`` ranks (one launched rank at one
    card): (a) ``python -m horovod_tpu_torch.run`` trains phase 5's main
    path (:func:`launcher_train`); (b) ``run(fn)`` of an allreduce on
    the card, results in rank order; (c) a rank exits with 3: the
    launcher returns 3 and names it, no rank outlives the grace window;
    (d) one rank with another ``HVD_SECRET_KEY``: ``broadcast_object``
    fails on the others with the HMAC error, nothing is unpickled (at
    one card two ranks share it: the failing exchange is the plane's
    gloo metadata, and no NCCL collective runs).  -> (a)'s results."""
    from horovod_tpu_torch.run import run

    import chip_smoke

    world = _world()
    out = os.path.join(_out_dir(), "launcher")
    wall = {}

    # (a) the CLI
    t0 = time.time()
    code, text = _launcher_cli(world, os.path.join(out, "train"),
                               "launcher_train")
    results = _rank_results("phase 12 (a)", os.path.join(out, "train"),
                            world, code)
    wall["a"] = time.time() - t0
    to_init = max(res["init_done"] for res in results) - t0
    for res in results:
        steady = statistics.median(res["step_s"][1:])
        neg = res["negotiation_ms_median"]
        hm = res["hmac_ms_median"]
        print(f"launcher rank {res['rank']} of {res['world']}: losses "
              f"{[round(x, 4) for x in res['losses']]}; median step "
              f"{steady * 1e3:.2f} ms (phase 5 in this run: "
              f"{phase5_step_ms:.2f} ms); negotiation median "
              + (f"{neg:.4f} ms over {res['cycles']} cycles, of which HMAC "
                 f"{hm * 1e3:.2f} us" if hm is not None else
                 f"{neg:.4f} ms over {res['cycles']} cycles (one rank: no "
                 f"exchange, no HMAC)" if neg is not None else
                 "(no cycle ran)")
              + (f" (phase 6: {phase6_negotiation_ms:.4f} ms)"
                 if phase6_negotiation_ms is not None else "")
              + f"; launches {res['counts']} on {smi}", flush=True)
    first = {k: min(res[k] for res in results) - t0
             for k in ("started", "imported", "init_done")}
    last = {k: max(res[k] for res in results) - t0
            for k in ("started", "imported", "init_done")}
    print(f"launcher: {world} rank(s), launcher start to every rank's "
          f"hvd.init() returning {to_init:.2f} s: ranks' interpreters up "
          f"at {first['started']:.2f}-{last['started']:.2f} s (the "
          f"launcher's own start, its imports and the spawn), torch and "
          f"the port imported at {first['imported']:.2f}-"
          f"{last['imported']:.2f} s, init returned at "
          f"{first['init_done']:.2f}-{last['init_done']:.2f} s; HMAC sign "
          f"+ check of a "
          f"{HMAC_BYTES}-byte message {_hmac_us():.2f} us (host, median of "
          f"{HMAC_REPEATS}) on {smi}", flush=True)

    # (b) run(fn)
    t0 = time.time()
    got = run(chip_smoke.run_fn_allreduce, np=world, extra_env={
        "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))})
    want = [(r, float(world * (world + 1) // 2)) for r in range(world)]
    if [tuple(x) for x in got] != want:
        raise AssertionError(f"run(fn): {got}, expected {want}")
    wall["b"] = time.time() - t0
    print(f"launcher: run(fn) on {world} rank(s) returned {got} in rank "
          f"order, HMAC-checked, in {wall['b']:.2f} s", flush=True)

    # (c) a failing rank and (d) a rank with another job key, side by
    # side: neither times what it checks
    t0 = time.time()
    logs = os.path.join(out, "fail")
    kworld = max(world, 2)
    jobs = _jobs(_launcher_cli, {
        "fail": (world, logs, "launcher_fail", 0,
                 ("--term-grace", str(TERM_GRACE_S)), 300),
        "key": (kworld, os.path.join(out, "key"), "launcher_key", 0, (),
                300)}, True)
    code, text = jobs["fail"]()
    culprit = f"rank {world - 1} failed first (exit code 3)"
    if code != 3 or culprit not in text:
        raise AssertionError(f"phase 12 (c): launcher exited {code}, "
                             f"expected 3 naming '{culprit}':\n"
                             f"{text[-4000:]}")
    pids = []
    for r in range(world):
        stdout, _ = _rank_log(logs, r, world)
        pids += [int(line.split()[1]) for line in stdout.splitlines()
                 if line.startswith("PID ")]
    if len(pids) != world:
        raise AssertionError(f"phase 12 (c): {len(pids)} pids of {world}")
    deadline = time.time() + TERM_GRACE_S
    while any(_alive(p) for p in pids) and time.time() < deadline:
        time.sleep(0.1)
    if any(_alive(p) for p in pids):
        raise AssertionError(f"phase 12 (c): ranks alive after the grace "
                             f"window: {[p for p in pids if _alive(p)]}")
    wall["c"] = time.time() - t0
    print(f"launcher: rank {world - 1} of {world} exited 3 after init: the "
          f"launcher returned {code} naming it, and none of the {world} "
          f"worker pid(s) is alive ({wall['c']:.2f} s)", flush=True)

    # (d) a rank with another job key
    t0 = time.time()
    logs = os.path.join(out, "key")
    code, text = jobs["key"]()
    keyed = _rank_results("phase 12 (d)", logs, kworld, code)
    for res in keyed:
        if res["error"] is None or "failed HMAC verification" not in \
                res["error"] or res["tripped"]:
            raise AssertionError(f"phase 12 (d): rank {res['rank']}: {res}")
    for res in keyed[:-1]:
        if f"rank {kworld - 1} failed HMAC" not in res["error"]:
            raise AssertionError(f"phase 12 (d): rank {res['rank']} does "
                                 f"not name rank {kworld - 1}: {res}")
    wall["d"] = time.time() - t0
    print(f"launcher: rank {kworld - 1} of {kworld} with another job key: "
          f"broadcast_object failed on every rank ({keyed[0]['error']}), "
          f"nothing unpickled ({wall['d']:.2f} s)", flush=True)
    print(f"launcher: wall s { {k: round(v, 2) for k, v in wall.items()} }"
          + " ((d) the rest of its wait beside (c))",
          flush=True)
    return {"world": world, "launch_to_init_s": to_init,
            "launch_first_s": first, "launch_last_s": last,
            "ranks": results,
            "run_fn": got, "key_errors": [r["error"] for r in keyed],
            "wall_s": wall}


# phase 13: the control plane's windows (the JAX tests' own), the step
# whose first gradient bucket (a)'s crash lands in (the steps before it,
# the first one's warm-up aside, give the step's median with heartbeats
# running), the stall shutdown of (b) and (d), the plane allreduce (c)'s
# peers block in, and the launcher's grace window, which must outlast
# the abort's delivery
FT_HEARTBEAT_S, FT_LIVENESS_S, FT_ABORT_S = 0.25, 2.0, 10.0
FT_STALL_S, FT_STEPS, FT_CRASH_STEP = 2.0, 10, 8
FT_USER_ELEMS, FT_USER_DELAY_S, FT_TERM_GRACE_S = 1 << 26, 1.0, 20.0


def _ft_flags(spec=None, stall=None, liveness=FT_LIVENESS_S):
    """The launcher flags of a phase 13 job."""
    flags = ["--heartbeat-interval", str(FT_HEARTBEAT_S),
             "--liveness-timeout", str(liveness), "--abort-timeout",
             str(FT_ABORT_S), "--term-grace", str(FT_TERM_GRACE_S)]
    if spec:
        flags += ["--fault-spec", spec]
    if stall:
        flags += ["--stall-check-shutdown-time-seconds", str(stall)]
    return tuple(flags)


def _ft_init():
    """A phase 13 rank: print its pid, keep running through the SIGTERM
    of the launcher's kill fan-out (the job's abort must reach it
    first), then ``hvd.init()`` on the card, or on the CPU where the
    phase asks for it (``P13_DEVICE``).  -> the SIGTERMs' times."""
    import signal

    import horovod_tpu_torch as hvd

    terms = []
    signal.signal(signal.SIGTERM, lambda *_: terms.append(time.time()))
    print(f"PID {os.getpid()}", flush=True)
    hvd.init(device=os.environ.get("P13_DEVICE"))
    return terms


def _ft_error(exc, start, where):
    return {"type": type(exc).__name__, "origin": exc.origin_rank,
            "reason": exc.reason, "at": time.time(),
            "elapsed_s": time.perf_counter() - start, "where": where}


def _ft_done(res, terms):
    """Shut down (timed: it must return on aborted communicators)."""
    import horovod_tpu_torch as hvd

    t0 = time.perf_counter()
    hvd.shutdown()
    res["shutdown_s"] = time.perf_counter() - t0
    res["sigterms"] = terms
    return res


def fault_crash(layers):
    """Phase 13 (a) on one launched rank: phase 5's main path (the
    full-width transformer, ``DistributedOptimizer(AdamW(1e-4, wd
    1e-4))``, ``[8, 2048]`` tokens a GPU, each rank its own) until the
    last rank's crash spec fires at the first gradient bucket of step
    ``FT_CRASH_STEP``.  From step ``FT_CRASH_STEP - 1`` on, each step
    ends with an ``elastic.State`` commit, as an elastic loop's does,
    which must refuse every snapshot taken across the abort.  The last
    rank writes the wall time at which it starts that step's backward; a
    survivor records where the typed error came out and when.  -> the
    rank's numbers."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer, lm_loss
    from horovod_tpu_torch.ops import cuda as kernels

    terms = _ft_init()
    r, n = hvd.rank(), hvd.size()
    model = Transformer(main_config(layers), seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    state = hvd.elastic.State(params=model.state_dict(), optimizer_state=opt)
    tokens = torch.from_numpy(np.random.RandomState(r).randint(
        0, VOCAB, (MAIN_BATCH, MAIN_SEQ))).to(hvd.device())
    mark = os.path.join(_out_dir(), "fault", "crash_backward_start")
    kernels.reset_launch_counts()
    losses, times, commits, error, where = [], [], [], None, None
    start = run_start = time.perf_counter()
    try:
        for step in range(FT_STEPS):
            torch.cuda.synchronize()
            start = time.perf_counter()
            where = "forward"
            opt.zero_grad(set_to_none=True)
            loss = lm_loss(model(tokens), tokens)
            if r == n - 1 and step == FT_CRASH_STEP - 1:
                with open(mark, "w") as f:
                    f.write(repr(time.time()))
            where = "backward"
            loss.backward()
            where = "opt.step"
            opt.step()
            where = "loss.item"
            losses.append(loss.item())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
            if step + 1 >= FT_CRASH_STEP - 1:
                where = "commit"
                state.step = step + 1
                state.commit()
                commits.append(state.step)
    except hvd.HvdAbortedError as exc:
        error = _ft_error(exc, start, where)
    return _ft_done({"rank": r, "world": n, "buckets": len(opt._buckets),
                     "losses": losses, "step_s": times, "commits": commits,
                     "last_commit": state._committed[2], "error": error,
                     "counts": kernels.launch_counts(),
                     **_heartbeat_stats(time.perf_counter() - run_start)},
                    terms)


def fault_stall(layers):
    """Phase 13 (b) on one rank: an allreduce of 2^20 fp32 on the eager
    plane, which the last rank's spec drops."""
    import torch

    import horovod_tpu_torch as hvd

    terms = _ft_init()
    r, n = hvd.rank(), hvd.size()
    t = torch.full((1 << 20,), float(r + 1), device=hvd.device())
    start, res = time.perf_counter(), {"rank": r, "world": n, "error": None}
    try:
        hvd.allreduce(t, op=hvd.Sum, name="p13.stall")
    except hvd.HvdAbortedError as exc:
        res["error"] = _ft_error(exc, start, "allreduce")
    return _ft_done(res, terms)


def fault_user(layers):
    """Phase 13 (c) on one rank: rank 0 waits, then calls
    ``hvd.abort()``, and then submits once more; the others block in an
    allreduce of ``FT_USER_ELEMS`` fp32 on the eager plane, which rank 0
    never submits."""
    import torch

    import horovod_tpu_torch as hvd

    terms = _ft_init()
    r, n = hvd.rank(), hvd.size()
    t = torch.ones(FT_USER_ELEMS, device=hvd.device())
    start, res = time.perf_counter(), {"rank": r, "world": n, "error": None}
    try:
        if r == 0:
            time.sleep(FT_USER_DELAY_S)
            res["abort_at"] = time.time()
            hvd.abort()
        hvd.allreduce(t, op=hvd.Sum, name="p13.user")
    except hvd.HvdAbortedError as exc:
        res["error"] = _ft_error(exc, start, "allreduce")
    return _ft_done(res, terms)


def fault_cross(layers):
    """Phase 13 (d) on one rank, ROADMAP C.7's order: rank 0 submits an
    allreduce of 2^20 fp32 to the eager plane and then takes a step of
    phase 5's model under ``DistributedOptimizer``; the other ranks take
    the step first, read its loss (as a training loop does) and submit
    the plane's allreduce after it."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer

    terms = _ft_init()
    r, n = hvd.rank(), hvd.size()
    model = Transformer(main_config(layers), seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    tokens = torch.from_numpy(np.random.RandomState(r).randint(
        0, VOCAB, (MAIN_BATCH, MAIN_SEQ))).to(hvd.device())
    t = torch.ones(1 << 20, device=hvd.device())
    torch.cuda.synchronize()
    start, res = time.perf_counter(), {"rank": r, "world": n, "error": None}
    where = None
    try:
        if r == 0:
            handle = hvd.allreduce_async(t, name="p13.cross")
            where = "step"
            _lm_step(model, opt, tokens)
            where = "synchronize"
            hvd.synchronize(handle)
        else:
            where = "step"
            loss = _lm_step(model, opt, tokens)
            # the loop reads its loss: the host waits for the step, whose
            # bucket allreduces wait for rank 0, which waits in its drain
            where = "loss.item"
            loss.item()
            where = "allreduce"
            hvd.allreduce(t, name="p13.cross")
    except hvd.HvdAbortedError as exc:
        res["error"] = _ft_error(exc, start, where)
    return _ft_done(res, terms)


def _ft_job(name, world, phase, layers, flags, env=None, where="fault"):
    """One phase 13 (or 17) job through ``python -m horovod_tpu_torch.run``
    (rank logs in ``chiprun_out/<where>/<name>/``): -> (the launcher's
    exit code and output, each rank's ``RANK_RESULT`` or None, every
    rank's pid that is still alive once the launcher has returned)."""
    logs = os.path.join(_out_dir(), where, name)
    code, text = _launcher_cli(world, logs, phase, layers, flags,
                               timeout=600, env=env)
    results, pids = [], []
    for r in range(world):
        out, _ = _rank_log(logs, r, world)
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("RANK_RESULT ")]
        results.append(json.loads(lines[-1].split(" ", 1)[1])
                       if lines else None)
        pids += [int(ln.split()[1]) for ln in out.splitlines()
                 if ln.startswith("PID ")]
    if len(pids) != world:
        raise AssertionError(f"{where} {name}: {len(pids)} pids of "
                             f"{world}:\n{text[-4000:]}")
    return code, text, results, [p for p in pids if _alive(p)]


def _ft_expect(name, results, ranks, origin, deadline=FT_ABORT_S):
    """Every rank in ``ranks`` raised ``HvdAbortedError`` naming
    ``origin`` within ``deadline`` seconds and shut down."""
    for r in ranks:
        res = results[r]
        err = res and res["error"]
        if not err or err["type"] != "HvdAbortedError" \
                or err["origin"] != origin or err["elapsed_s"] >= deadline:
            raise AssertionError(f"phase 13 {name}: rank {r}: {res}")


def fault_phase(smi, phase5_step_ms, buckets):
    """Phase 13 at ``min(cards, 4)`` ranks, each job started through
    ``python -m horovod_tpu_torch.run`` with heartbeats every
    ``FT_HEARTBEAT_S``, liveness ``FT_LIVENESS_S`` and the abort deadline
    ``FT_ABORT_S``: (a) a crash inside a gradient bucket of the main path
    (two cards and more); (b) a dropped plane allreduce under the stall
    shutdown; (c) ``hvd.abort()``; (d) ROADMAP C.7's order under the
    stall shutdown (two cards and more).  At one card (b) and (c) run at
    two ranks on the CPU, which the phase asks for and says.  Each job
    ends with no rank alive.  -> every job's results."""
    world = _world()
    env, out = None, {}
    if world == 1:
        env, world = {"P13_DEVICE": "cpu"}, 2
        print("fault: one card, and NCCL puts no two ranks of one "
              "communicator on it: (b) and (c) run at two ranks on the "
              "CPU (gloo; the control plane is the same host code), (a) "
              "and (d) need two cards and are skipped", flush=True)
    last = world - 1
    wall = {}

    if env is None:
        t0 = time.time()
        # the first bucket of step FT_CRASH_STEP: steps before it done
        k = buckets * (FT_CRASH_STEP - 1) + 1
        code, text, res, alive = _ft_job(
            "crash", world, "fault_crash", LAYERS,
            _ft_flags(f"rank{last}:allreduce:{k}:crash"))
        culprit = f"rank {last} failed first (exit code 1)"
        if code == 0 or culprit not in text or alive:
            raise AssertionError(f"phase 13 (a): the launcher exited "
                                 f"{code}, expected it to name "
                                 f"'{culprit}'; alive {alive}:\n"
                                 f"{text[-4000:]}")
        if res[last] is not None:
            raise AssertionError(f"phase 13 (a): rank {last} did not "
                                 f"crash: {res[last]}")
        _ft_expect("(a)", res, range(last), last)
        with open(os.path.join(_out_dir(), "fault",
                               "crash_backward_start")) as f:
            crashed = float(f.read())
        for r in range(last):
            e = res[r]
            before = e["step_s"][:FT_CRASH_STEP - 1]
            # the error comes out of step FT_CRASH_STEP's DO call or, once
            # the host's wait in its loss.item() returns, out of the
            # commit that ends it, which must be refused: no state taken
            # across the crash is accepted
            if len(e["losses"]) not in (FT_CRASH_STEP - 1, FT_CRASH_STEP) \
                    or len(before) < FT_CRASH_STEP - 1:
                raise AssertionError(f"phase 13 (a): rank {r} finished "
                                     f"{len(e['losses'])} steps: {e}")
            if e["commits"] != [FT_CRASH_STEP - 1] \
                    or e["last_commit"] != FT_CRASH_STEP - 1:
                raise AssertionError(
                    f"phase 13 (a): rank {r} committed {e['commits']} "
                    f"(last {e['last_commit']}), expected only step "
                    f"{FT_CRASH_STEP - 1}, the last before the crash: {e}")
            print(f"fault (a) rank {r} of {world}: "
                  f"{e['error']['type']}(origin={e['error']['origin']}) out "
                  f"of {e['error']['where']} "
                  f"{e['error']['at'] - crashed:.3f} s after rank {last} "
                  f"began the backward it crashed in ('{e['error']['reason']}'"
                  f"); {len(e['losses'])} steps' losses kept, commits "
                  f"accepted {e['commits']}, last commit step "
                  f"{e['last_commit']}; steps before it "
                  f"{[round(x * 1e3, 2) for x in before]} ms, median after "
                  f"the first {1e3 * statistics.median(before[1:]):.2f} ms "
                  f"with heartbeats every {FT_HEARTBEAT_S} s (phase 5: "
                  f"{phase5_step_ms:.2f} ms); {e['heartbeats']} heartbeats,"
                  f" round trip {e['heartbeat_ms_median']:.3f} ms; shutdown "
                  f"{e['shutdown_s']:.3f} s; on {smi}", flush=True)
        wall["a"] = time.time() - t0
        print(f"fault (a): the launcher exited {code} naming rank {last}; "
              f"no rank alive ({wall['a']:.1f} s)", flush=True)
        out["crash"] = {"code": code, "crashed_at": crashed, "ranks": res}

    # (b) and (c) side by side, after (a) has timed its crash
    jobs = _jobs(_ft_job, {
        "stall": ("stall", world, "fault_stall", 0,
                  _ft_flags(f"rank{last}:allreduce:1:drop", FT_STALL_S,
                            30.0), env),
        "user": ("user", world, "fault_user", 0,
                 _ft_flags(liveness=30.0), env)}, True)

    t0 = time.time()
    code, text, res, alive = jobs["stall"]()
    if code != 0 or alive:
        raise AssertionError(f"phase 13 (b): exit {code}, alive {alive}:"
                             f"\n{text[-4000:]}")
    _ft_expect("(b)", res, range(world), last, FT_STALL_S + FT_ABORT_S)
    wall["b"] = time.time() - t0
    for e in res:
        print(f"fault (b) rank {e['rank']} of {world}: "
              f"{e['error']['type']}(origin={e['error']['origin']}) after "
              f"{e['error']['elapsed_s']:.3f} s ('{e['error']['reason']}')"
              f"; shutdown {e['shutdown_s']:.3f} s"
              + (" on the CPU" if env else f" on {smi}"), flush=True)
    out["stall"] = res

    t0 = time.time()
    code, text, res, alive = jobs["user"]()
    if code != 0 or alive:
        raise AssertionError(f"phase 13 (c): exit {code}, alive {alive}:"
                             f"\n{text[-4000:]}")
    _ft_expect("(c)", res, range(world), 0, FT_USER_DELAY_S + FT_ABORT_S)
    wall["c"] = time.time() - t0
    for e in res:
        print(f"fault (c) rank {e['rank']} of {world}: "
              f"{e['error']['type']}(origin={e['error']['origin']}) "
              f"{e['error']['at'] - res[0]['abort_at']:.3f} s after rank 0's "
              f"hvd.abort() ('{e['error']['reason']}'); shutdown "
              f"{e['shutdown_s']:.3f} s"
              + (" on the CPU" if env else f" on {smi}"), flush=True)
    out["user"] = res

    if env is None:
        t0 = time.time()
        code, text, res, alive = _ft_job(
            "cross", world, "fault_cross", LAYERS,
            _ft_flags(stall=FT_STALL_S, liveness=30.0))
        if code != 0 or alive:
            raise AssertionError(f"phase 13 (d): exit {code}, alive "
                                 f"{alive}:\n{text[-4000:]}")
        _ft_expect("(d)", res, range(world), 1, FT_STALL_S + FT_ABORT_S)
        wall["d"] = time.time() - t0
        for e in res:
            print(f"fault (d) rank {e['rank']} of {world}: C.7's order ended "
                  f"in {e['error']['type']}(origin={e['error']['origin']}) "
                  f"out of {e['error']['where']} after "
                  f"{e['error']['elapsed_s']:.3f} s "
                  f"('{e['error']['reason']}'); shutdown "
                  f"{e['shutdown_s']:.3f} s on {smi}", flush=True)
        out["cross"] = res
    print(f"fault: wall s { {k: round(v, 2) for k, v in wall.items()} }"
          + " ((c) the rest of its wait beside (b))",
          flush=True)
    out["wall_s"] = wall
    return out


# phase 14: elastic membership.  The control plane's windows are phase
# 13's; the jobs take EL_STEPS steps, the last rank's (or rank 0's)
# crash lands in the first gradient bucket of step EL_CRASH_STEP, after
# which the survivors roll back to the commit of the step before it and
# take the rest again; the integer schedule (the JAX elastic test's: each
# step allreduces a vector of step + 1 and subtracts the average) rides
# every step on the eager plane
EL_STEPS, EL_CRASH_STEP, EL_INT_ELEMS = 8, 4, 1000
EL_RECONFIG_S = 120.0
# (b)-(d) run the main path's model cut to this depth: what they show is
# membership, and (a) has the full depth
EL_SMALL_LAYERS = 2


def _do_buckets(layers):
    """``DistributedOptimizer``'s buckets a step of the main path's model
    at ``layers`` (the plan depends only on the parameters' sizes)."""
    from horovod_tpu_torch.common.compression import Compression
    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.optimizer import _fusion_threshold, _plan

    params = list(Transformer(main_config(layers), device="cpu")
                  .parameters())[::-1]
    return len(_plan(params, Compression.none, _fusion_threshold()))


def _el_crash_hit(buckets):
    """The fault spec's hit of the first gradient bucket of step
    ``EL_CRASH_STEP`` (of its integer allreduce without buckets): one
    eager allreduce and ``buckets`` buckets a step."""
    return EL_CRASH_STEP * (1 + buckets) + (2 if buckets else 1)


def _el_flags(spec=None, extra=()):
    """The launcher flags of a phase 14 job."""
    flags = ["--elastic", "--heartbeat-interval", str(FT_HEARTBEAT_S),
             "--liveness-timeout", str(FT_LIVENESS_S), "--abort-timeout",
             str(FT_ABORT_S), "--term-grace", str(FT_TERM_GRACE_S),
             "--reconfig-timeout", str(EL_RECONFIG_S)]
    if spec:
        flags += ["--fault-spec", spec]
    return tuple(flags) + tuple(extra)


def _el_digest(tensors):
    """sha1 of the tensors' bytes on the host, in order."""
    import hashlib

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def elastic_rank(layers):
    """Phase 14 on one launched rank: ``hvd.init()`` (a late joiner,
    ``P14_JOINER``, ``elastic.wait_for_membership()`` instead), then
    ``elastic.run`` over an ``elastic.State`` committed every step: the
    integer schedule on the eager plane and, on the card, a step of phase
    5's main path (the full-width transformer at ``layers``,
    ``DistributedOptimizer(AdamW(1e-4, wd 1e-4))``, ``[8, 2048]`` tokens,
    the same on every rank at a step, so that the step computes the same
    at any world size).  The crash's rank writes when its crash step's
    backward (on the CPU: its integer allreduce) starts.  -> the rank's
    numbers: each step's epoch and
    seconds, the parameters' digests after each (re-)sync and at the
    end, the reconfiguration's parts, the launches."""
    import signal

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import cuda as kernels

    wid = int(os.environ["HVD_RANK"])
    dev = os.environ.get("P14_DEVICE")
    on_card = dev != "cpu"
    terms = []
    if os.environ.get("P14_KEEP_RUNNING"):
        # the launcher's kill fan-out must not end this rank before it
        # has shown its typed abort (the drain handler is then not set)
        signal.signal(signal.SIGTERM, lambda *_: terms.append(time.time()))
    print(f"PID {os.getpid()}", flush=True)
    joiner = os.environ.get("P14_JOINER")
    t0 = time.time()
    if joiner is not None and wid == int(joiner):
        hvd.elastic.wait_for_membership(timeout=600, device=dev)
    else:
        if joiner is not None:
            # the joiner is past the initial gang
            os.environ["HVD_SIZE"] = str(int(os.environ["HVD_SIZE"]) - 1)
        hvd.init(device=dev)
    init_s = time.time() - t0
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    w = torch.zeros(EL_INT_ELEMS, device=hvd.device())
    params, model, opt = {"int.w": w}, None, None
    if on_card:
        from horovod_tpu_torch.models import Transformer, lm_loss

        model = Transformer(main_config(layers), seed=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())
        params.update(model.state_dict())
    state = hvd.elastic.State(params=params, optimizer_state=opt)
    crash = os.environ.get("P14_CRASH_WID")
    mark = os.path.join(_out_dir(), "elastic",
                        f"crash_backward_start.w{wid}")
    out = {"wid": wid, "init_s": init_s, "steps": [], "losses": [],
           "synced": [], "reconfig": None, "ckpt": None}
    kernels.reset_launch_counts()

    def epoch():
        return basics._get_state().epoch

    def train(state):
        if state._ckpt is not None:
            out["ckpt_manager"] = state._ckpt
        # the state was just synced from rank 0: its digest
        out["synced"].append({"epoch": epoch(), "step": state.step,
                              "digest": _el_digest(params.values())})
        while state.step < EL_STEPS:
            s = state.step
            sync()
            start = time.perf_counter()
            if crash is not None and wid == int(crash) \
                    and s == EL_CRASH_STEP and model is None:
                with open(mark, "w") as f:
                    f.write(repr(time.time()))
            avg = hvd.allreduce(torch.full_like(w, float(s + 1)),
                                op=hvd.Average, name=f"p14.int.{s}")
            w.sub_(avg)
            if model is not None:
                tokens = torch.from_numpy(np.random.RandomState(
                    1000 + s).randint(0, VOCAB, (MAIN_BATCH, MAIN_SEQ))
                ).to(hvd.device())
                opt.zero_grad(set_to_none=True)
                loss = lm_loss(model(tokens), tokens)
                if crash is not None and wid == int(crash) \
                        and s == EL_CRASH_STEP:
                    with open(mark, "w") as f:
                        f.write(repr(time.time()))
                loss.backward()
                opt.step()
                out["losses"].append((epoch(), s, loss.item()))
            sync()
            out["steps"].append((epoch(), s,
                                 time.perf_counter() - start))
            state.step = s + 1
            state.commit()

    run_start = time.perf_counter()
    try:
        result = hvd.elastic.run(train, state)
    except hvd.HvdAbortedError as exc:
        out["error"] = {"type": type(exc).__name__,
                        "origin": exc.origin_rank, "reason": exc.reason,
                        "at": time.time()}
        out["sigterms"] = terms
        hvd.shutdown()
        return out
    mgr = out.pop("ckpt_manager", None)
    if mgr is not None:
        out["ckpt"] = {"writes": len(mgr.writes), "errors": mgr.errors,
                       "flushed": mgr._snapshot is None
                       and not mgr._writing}
    if result is hvd.elastic.DRAINED:
        out["drained"] = True
        return out
    out["reconfig"] = dict(hvd.elastic.last_reconfig) or None
    st = basics._get_state()
    out.update(rank=st.rank, size=st.size, epoch=st.epoch,
               members=list(st.members), device=str(st.device),
               coordinator=st.plane._coordinator is not None,
               int_w=float(w[0]), int_exact=bool(torch.equal(
                   w.cpu(), torch.full((EL_INT_ELEMS,), -float(
                       sum(range(1, EL_STEPS + 1)))))),
               digest=_el_digest(params.values()),
               counts=kernels.launch_counts() if on_card else None,
               **_heartbeat_stats(time.perf_counter() - run_start))
    save = os.environ.get("P14_SAVE")
    if save and st.rank == 0 and model is not None:
        torch.save({k: v.detach().cpu() for k, v in
                    model.state_dict().items()}, save)
    t1 = time.perf_counter()
    hvd.shutdown()
    out["shutdown_s"] = time.perf_counter() - t1
    return out


def _el_job(name, world, layers, flags, env=None):
    """One phase 14 job through ``python -m horovod_tpu_torch.run``
    (rank logs in ``chiprun_out/elastic/<name>/``): -> (the launcher's
    exit code and output, each rank's result or None, the pids still
    alive)."""
    logs = os.path.join(_out_dir(), "elastic", name)
    code, text = _launcher_cli(world, logs, "elastic_rank", layers, flags,
                               timeout=600, env=env)
    results, pids = [], []
    for r in range(world):
        out, _ = _rank_log(logs, r, world)
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("RANK_RESULT ")]
        results.append(json.loads(lines[-1].split(" ", 1)[1])
                       if lines else None)
        pids += [int(ln.split()[1]) for ln in out.splitlines()
                 if ln.startswith("PID ")]
    return code, text, results, [p for p in pids if _alive(p)]


def _el_fail(what, code, text, res):
    raise AssertionError(f"phase 14 {what}: launcher exit {code}; "
                         f"results {json.dumps(res)[-3000:]}\n"
                         f"{text[-3000:]}")


def _el_reformed(what, res, survivors, members, code, text):
    """Every survivor finished at the next epoch with ``members`` and
    the same parameters; -> the survivors' results."""
    got = [res[w] for w in survivors]
    for w, e in zip(survivors, got):
        if (code != 0 or e is None or e.get("error")
                or e.get("epoch") != 1 or e.get("members") != members
                or not e.get("int_exact")):
            _el_fail(f"{what}: worker {w}", code, text, res)
    if len({e["digest"] for e in got}) != 1:
        _el_fail(f"{what}: the survivors' parameters differ", code, text,
                 res)
    return got


def _el_epoch_steps(e, epoch):
    return [sec for ep, _, sec in e["steps"] if ep == epoch]


def elastic_phase(smi, buckets):
    """Phase 14 at ``min(cards, 4)`` ranks, each job started through
    ``python -m horovod_tpu_torch.run --elastic`` with phase 13's
    windows: (a) the last rank crashes in the first gradient bucket of
    step ``EL_CRASH_STEP``; the survivors re-form, roll back and finish,
    against an uninterrupted run at one rank fewer on the survivors'
    cards; (b)-(d) at ``EL_SMALL_LAYERS``: (b) a late joiner on the last card takes the crashed rank's
    place; (c) a drain (the ``preempt`` action's SIGTERM); (d) rank 0's
    crash under ``--coord-failover``, and without it.  At one card the
    phase runs at four ranks on the CPU (gloo), the integer schedule
    only: NCCL takes no two ranks of a communicator on one card.
    ``buckets``: ``DistributedOptimizer``'s buckets of the model a step.
    -> every job's results."""
    world = _world()
    env, layers, small, out, wall = {}, LAYERS, EL_SMALL_LAYERS, {}, {}
    if world == 1:
        env, world, layers, small = {"P14_DEVICE": "cpu"}, 4, 0, 0
        buckets = 0
        print("elastic: one card, and NCCL puts no two ranks of one "
              "communicator on it: (a)-(d) run at four ranks on the CPU "
              "(gloo; the integer schedule on the eager plane, no "
              "transformer)", flush=True)
    where = "on the CPU" if env else f"on {smi}"
    if world < 3:
        print(f"elastic: {world} cards: phase 14 needs three ranks or "
              f"more; skipped", flush=True)
        return out
    last = world - 1
    scratch = os.path.join(_scratch_dir(), "p14")
    os.makedirs(scratch, exist_ok=True)
    os.makedirs(os.path.join(_out_dir(), "elastic"), exist_ok=True)
    k = _el_crash_hit(buckets)
    k_small = _el_crash_hit(_do_buckets(small) if small else 0)
    survivors = list(range(last))
    saved = os.path.join(scratch, "a_params.pt")
    ref_saved = os.path.join(scratch, "a_ref_params.pt")
    cards = ",".join(str(c) for c in survivors)
    victim = last - 1
    ckpt = os.path.join(scratch, "drain_ckpt")
    small_jobs = {
        "joiner": ("joiner", world, small,
                   _el_flags(f"rank{victim}:allreduce:{k_small}:crash"),
                   {**env, "P14_JOINER": str(last)}),
        "drain": ("drain", world, small,
                  _el_flags(f"rank{last}:allreduce:{k_small}:preempt",
                            ("--ckpt-dir", ckpt, "--ckpt-interval", "2")),
                  env),
        "failover": ("failover", world, small,
                     _el_flags(f"rank0:allreduce:{k_small}:crash",
                               ("--coord-failover",)),
                     {**env, "P14_CRASH_WID": "0"}),
        "no_failover": ("no_failover", world, small,
                        _el_flags(f"rank0:allreduce:{k_small}:crash"),
                        {**env, "P14_CRASH_WID": "0",
                         "P14_KEEP_RUNNING": "1"})}
    # at one card all six CPU jobs side by side from here; on the cards
    # (a)'s two timed runs go alone, then (b)-(d) side by side
    jobs = _jobs(_el_job, {
        "loss": ("loss", world, layers,
                 _el_flags(f"rank{last}:allreduce:{k}:crash"),
                 {**env, "P14_CRASH_WID": str(last), "P14_SAVE": saved}),
        "uninterrupted": ("uninterrupted", world - 1, layers, _el_flags(),
                          {**env, "CUDA_VISIBLE_DEVICES": cards,
                           "P14_SAVE": ref_saved})}, bool(env))
    if env:
        jobs.update(_jobs(_el_job, small_jobs, True))

    # (a) rank loss, against the uninterrupted run on the same cards
    t0 = time.time()
    code, text, res, alive = jobs["loss"]()
    if res[last] is not None or alive:
        _el_fail("(a): the crash", code, text, res)
    got = _el_reformed("(a)", res, survivors, survivors, code, text)
    code_u, text_u, ref, alive_u = jobs["uninterrupted"]()
    if code_u != 0 or alive_u or any(e is None or e.get("error")
                                     for e in ref):
        _el_fail("(a): the uninterrupted run", code_u, text_u, ref)
    gap = None
    if layers:
        import torch

        a = torch.load(saved)
        b = torch.load(ref_saved)
        gap = max(float((a[n].double() - b[n].double()).abs().max())
                  for n in a)
    crashed = None
    mark = os.path.join(_out_dir(), "elastic",
                        f"crash_backward_start.w{last}")
    if os.path.exists(mark):
        with open(mark) as f:
            crashed = float(f.read())
    ref_steady = [x for e in ref for x in _el_epoch_steps(e, 0)[1:]]
    for e in got:
        rc = e["reconfig"]
        new = _el_epoch_steps(e, 1)
        detect = (rc["caught_at"] - crashed) if crashed else None
        print(f"elastic (a) worker {e['wid']} -> rank {e['rank']} of "
              f"{e['size']} at epoch {e['epoch']} on {e['device']}: crash "
              f"to its typed error "
              + (f"{detect:.3f} s" if detect is not None else "n/a")
              + f" (from worker {last}'s crash step), teardown "
              f"{rc['teardown_s']:.3f} s, rendezvous + groups + planes "
              f"{rc['rendezvous_s']:.3f} s, restore + sync (its "
              f"collectives open the new communicators) "
              f"{rc['restore_sync_s']:.3f} s, first step at epoch 1 "
              f"{1e3 * new[0]:.2f} ms, steady {e['size']}-rank steps "
              f"median {1e3 * statistics.median(new[1:]):.2f} ms against "
              f"the uninterrupted run's "
              f"{1e3 * statistics.median(ref_steady):.2f} ms; integer "
              f"schedule exact ({e['int_w']}); {where}", flush=True)
    print(f"elastic (a): the survivors agree bitwise "
          f"({got[0]['digest'][:12]}); largest gap to the uninterrupted "
          f"run on the same "
          f"cards {gap}; launcher exit {code}, no rank alive", flush=True)
    wall["a"] = time.time() - t0
    out["loss"] = {"ranks": res, "uninterrupted": ref, "gap": gap,
                   "crashed_at": crashed, "code": code}
    if not env:
        jobs.update(_jobs(_el_job, small_jobs, True))

    # (b) a late joiner on the last card takes the crashed rank's place
    t0 = time.time()
    code, text, res, alive = jobs["joiner"]()
    members = [w for w in range(world) if w != victim]
    got = _el_reformed("(b)", res, members, members, code, text)
    joiner = res[last]
    synced = {tuple((s["epoch"], s["digest"]) for s in e["synced"]
                    if s["epoch"] == 1) for e in got}
    if len(synced) != 1 or alive:
        _el_fail("(b): the joiner's synced parameters", code, text, res)
    print(f"elastic (b): worker {last} joined at epoch 1 as rank "
          f"{joiner['rank']} on {joiner['device']}, after "
          f"{joiner['init_s']:.1f} s of waiting; members {members}, its "
          f"parameters after the sync bitwise the incumbents' "
          f"({joiner['synced'][0]['digest'][:12]}); {where}", flush=True)
    wall["b"] = time.time() - t0
    out["joiner"] = res

    # (c) a drain: the preempt action's SIGTERM to one rank
    t0 = time.time()
    code, text, res, alive = jobs["drain"]()
    drained = res[last]
    if not (drained and drained.get("drained") and drained["ckpt"]
            and drained["ckpt"]["flushed"]) or alive:
        _el_fail("(c): the drained rank", code, text, res)
    got = _el_reformed("(c)", res, survivors, survivors, code, text)
    logs = os.path.join(_out_dir(), "elastic", "drain")
    for r in range(world):
        if "HvdAbortedError" in "".join(_rank_log(logs, r, world)):
            _el_fail(f"(c): an abort on rank {r}", code, text, res)
    print(f"elastic (c): worker {last}'s run returned DRAINED, exit 0, "
          f"its checkpoint writer flushed ({drained['ckpt']['writes']} "
          f"writes); the others re-formed at {got[0]['size']} with no "
          f"HvdAbortedError anywhere; {where}", flush=True)
    wall["c"] = time.time() - t0
    out["drain"] = res
    import shutil

    shutil.rmtree(ckpt, ignore_errors=True)

    # (d) rank 0's crash: fail-over armed, then not
    t0 = time.time()
    code, text, res, alive = jobs["failover"]()
    if res[0] is not None or alive:
        _el_fail("(d): rank 0's crash", code, text, res)
    got = _el_reformed("(d)", res, list(range(1, world)),
                       list(range(1, world)), code, text)
    if got[0]["rank"] != 0 or not got[0]["coordinator"]:
        _el_fail("(d): worker 1 is not rank 0 with the coordinator", code,
                 text, res)
    won = [r for r in range(1, world) if "won the epoch-0 election"
           in _rank_log(os.path.join(_out_dir(), "elastic", "failover"),
                        r, world)[1]]
    print(f"elastic (d): rank 0 lost; worker(s) {won} won the election; "
          f"worker 1 is rank 0 and hosts the coordinator and the store; "
          f"the survivors finished at epoch 1, launcher exit {code}; "
          f"{where}", flush=True)
    out["failover"] = res
    code, text, res, alive = jobs["no_failover"]()
    for r in range(1, world):
        e = res[r]
        if not (e and e.get("error")
                and e["error"]["type"] == "HvdAbortedError"
                and e["error"]["origin"] == 0):
            _el_fail(f"(d) without fail-over: rank {r}", code, text, res)
    if code == 0 or "rank 0 failed first" not in text or alive:
        _el_fail("(d) without fail-over: the launcher", code, text, res)
    print(f"elastic (d): without --coord-failover the same crash is a "
          f"typed HvdAbortedError(origin=0) on every survivor, launcher "
          f"exit {code} naming rank 0; {where}", flush=True)
    wall["d"] = time.time() - t0
    out["no_failover"] = res
    shutil.rmtree(scratch, ignore_errors=True)
    print(f"elastic: wall s { {k: round(v, 2) for k, v in wall.items()} }"
          + (" ((b)-(d) the rest of their waits beside (a))" if env else
             " ((b)-(d) side by side after (a): (c) and (d) the rest of "
             "their waits)"),
          flush=True)
    out["wall_s"] = wall
    return out


# phase 15: the estimator's steps of 8 rows a rank and its SGD learning
# rate (momentum 0.9, the estimator's); the validation share of the rows
CL_STEPS, CL_BATCH, CL_LR, CL_VALIDATION = 10, 8, 0.05, 0.125
# the shapes of (b) and (c) on the CPU at one card (two gloo ranks: NCCL
# takes no two ranks of a communicator on one card)
CL_CPU = {"vocab_size": 512, "d_model": 128, "n_layers": 2, "seq": 64}
# the models each call of _cl_factory built in this process, in order
_CL_MODELS = []


def _cl_config(cpu, layers=LAYERS):
    import torch

    if cpu:
        from horovod_tpu_torch.models import TransformerConfig

        return TransformerConfig(
            vocab_size=CL_CPU["vocab_size"], n_layers=CL_CPU["n_layers"],
            d_model=CL_CPU["d_model"], n_heads=CL_CPU["d_model"] // 64,
            d_ff=4 * CL_CPU["d_model"], max_len=CL_CPU["seq"],
            dtype=torch.float32)
    return main_config(layers)


def _cl_factory(cpu, layers=LAYERS):
    """Phase 15's ``model_factory``: phase 5's transformer at ``layers``
    on this rank's card (``cpu``: the small fp32 one), seed 0; each model
    is kept in ``_CL_MODELS``."""
    from horovod_tpu_torch.models import Transformer

    model = Transformer(_cl_config(cpu, layers), seed=0,
                        device="cpu" if cpu else None)
    _CL_MODELS.append(model)
    return model


def _cl_digest(model):
    import hashlib

    import torch

    h = hashlib.sha256()
    for name, p in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _cl_check_counts(what, counts, xent_val):
    """A phase-15 fit's launches: ``CL_STEPS`` of phase 5's steps and one
    validation forward (its loss's cross-entropy when ``xent_val``)."""
    val = {"layer_norm_fwd": 2 * LAYERS + 1, "flash_attention_fwd": LAYERS,
           "softmax_xent_fwd": int(xent_val)}
    want = {k: v * CL_STEPS + val.get(k, 0)
            for k, v in per_step_launches(LAYERS).items()}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want} "
                             f"({CL_STEPS} steps and the validation "
                             f"forward)")


class _ClLoss:
    """Phase 15's ``loss``: ``lm_loss``, with a record of its calls.  A
    call under autograd is a training step's: it synchronises the card
    and stamps the host clock (the step is the time between stamps) and
    keeps the loss.  The call without autograd is the validation
    forward's, after training and rank 0's checkpoint: it writes this
    rank's record (rank, card, stamps, losses, each kernel's launches so
    far, the trained parameters' sha256) to ``<out>/rank.<r>.json``.
    Module-level, so plain pickle sends it to ``ProcessBackend``'s
    workers by name."""

    def __init__(self, out):
        self.out = out
        self.stamps, self.losses = [], []

    def __call__(self, logits, tokens):
        import torch

        from horovod_tpu_torch.common import basics
        from horovod_tpu_torch.models import lm_loss
        from horovod_tpu_torch.ops import cuda as kernels

        if logits.is_cuda:
            torch.cuda.synchronize()
        if not torch.is_grad_enabled():
            rec = {"rank": basics.rank(), "device": str(basics.device()),
                   "card": (torch.cuda.current_device()
                            if logits.is_cuda else None),
                   "stamps": self.stamps, "losses": self.losses,
                   "counts": kernels.launch_counts(),
                   "digest": _cl_digest(_CL_MODELS[0])}
            os.makedirs(self.out, exist_ok=True)
            with open(os.path.join(self.out,
                                   f"rank.{rec['rank']}.json"), "w") as f:
                json.dump(rec, f)
            return lm_loss(logits, tokens)
        self.stamps.append(time.perf_counter())
        loss = lm_loss(logits, tokens)
        self.losses.append(loss.item())
        return loss


def _cl_tokens(world, cpu, validation=CL_VALIDATION, seed=0):
    """The fit's token rows: phase 5's batch (``RandomState(seed)``, 8
    rows) over and over, enough for ``CL_STEPS`` steps of ``CL_BATCH``
    rows on each of ``world`` ranks after the validation split, so that
    every step of every rank sees phase 5's batch (the loss must fall)."""
    import numpy as np

    vocab = CL_CPU["vocab_size"] if cpu else VOCAB
    seq = CL_CPU["seq"] if cpu else MAIN_SEQ
    batch = np.random.RandomState(seed).randint(0, vocab, (CL_BATCH, seq))
    need = world * CL_STEPS * CL_BATCH
    n = need
    while validation and n - max(1, int(n * validation)) < need:
        n += 1
    return np.ascontiguousarray(batch[np.arange(n) % CL_BATCH])


def _cl_steps_ms(stamps):
    """The steady step of a stamped fit: the median of the intervals
    between the training calls of its loss, the first left out."""
    gaps = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    return statistics.median(gaps[1:] if len(gaps) > 1 else gaps), gaps


def _cl_records(out, world):
    recs = []
    for r in range(world):
        with open(os.path.join(out, f"rank.{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def _cl_fit(cs, store_dir, backend, world, cpu, validation, out):
    """One phase-15 fit through ``backend``: -> (estimator, the fitted
    model, the metrics, the loss object)."""
    import shutil

    from horovod_tpu_torch.cluster import LocalStore, TorchEstimator

    shutil.rmtree(store_dir, ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)
    tokens = _cl_tokens(world, cpu, validation)
    loss = cs._ClLoss(out)
    est = TorchEstimator(
        functools.partial(cs._cl_factory, cpu), loss=loss, epochs=1,
        batch_size=CL_BATCH, learning_rate=CL_LR,
        store=LocalStore(store_dir), backend=backend,
        validation=validation, seed=0, device="cpu" if cpu else None)
    fitted, metrics = est.fit(tokens, tokens)
    return est, fitted, metrics, loss, tokens


def _cl_split(est):
    t = est.timings
    ranks = t["ranks"]
    return {"materialize_s": t["materialize_s"], "run_s": t["run_s"],
            "reload_s": t["reload_s"],
            "launch_to_rank_s": [r["start"] - t["run_start"]
                                 for r in ranks],
            "build_s": [r["build_s"] for r in ranks],
            "sync_s": [r["sync_s"] for r in ranks],
            "train_s": [r["train_s"] for r in ranks],
            "checkpoint_s": ranks[0]["checkpoint_s"],
            "val_s": [r.get("val_s") for r in ranks]}


def _cl_print_split(what, split, smi):
    def r3(key):
        return [round(v, 3) for v in split[key]]

    print(f"cluster {what}: fit {split['materialize_s']:.3f} s "
          f"materialize, {split['run_s']:.3f} s through the backend "
          f"(launch to each rank's start {r3('launch_to_rank_s')} s, then "
          f"the model and its optimizer built {r3('build_s')} s, rank "
          f"0's parameters taken {r3('sync_s')} s, {CL_STEPS} steps and "
          f"the metric "
          f"{r3('train_s')} s, rank 0's "
          f"checkpoint {split['checkpoint_s']:.3f} s, validation "
          f"{[round(v, 3) for v in split['val_s'] if v is not None]} s), "
          f"reload {split['reload_s']:.3f} s on {smi}", flush=True)


def _cl_metrics_ok(what, metrics, world):
    if len(metrics) != world:
        raise AssertionError(f"{what}: {len(metrics)} metrics for "
                             f"{world} ranks")
    if any(m != metrics[0] for m in metrics):
        raise AssertionError(f"{what}: the ranks' metrics differ: "
                             f"{metrics}")
    if not all(map(math.isfinite, metrics[0].values())):
        raise AssertionError(f"{what}: non-finite metrics {metrics[0]}")


def cluster_in_process(cs, smi, phase5_ms):
    """Phase 15 (a): ``TorchEstimator`` + ``InProcessBackend`` on this
    card, phase 5's transformer at full width and depth, ``lm_loss``,
    ``validation=CL_VALIDATION``; then phase 5's step and the estimator's
    in turns (a second fit without validation).  -> the record."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.cluster import InProcessBackend
    from horovod_tpu_torch.ops import cuda as kernels

    store = os.path.join(_scratch_dir(), "cluster_a")
    out = os.path.join(_scratch_dir(), "cluster_a_rec")
    hvd.init()
    try:
        cs._CL_MODELS.clear()
        kernels.reset_launch_counts()
        est, fitted, metrics, loss, tokens = _cl_fit(
            cs, store, InProcessBackend(), 1, False, CL_VALIDATION, out)
        counts = kernels.launch_counts()
        _cl_metrics_ok("(a)", metrics, 1)
        losses = loss.losses
        if len(losses) != CL_STEPS or not all(map(math.isfinite, losses)) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"(a): step losses {losses}")
        _cl_check_counts("(a)", counts, True)
        trained = cs._CL_MODELS[0]
        if fitted.model is not cs._CL_MODELS[-1] or trained is fitted.model:
            raise AssertionError("(a): the fitted model is not the "
                                 "reloaded one")
        if str(next(fitted.model.parameters()).device) != str(hvd.device()):
            raise AssertionError("(a): the fitted model is not on the card")
        probe = torch.from_numpy(tokens[:2]).to(hvd.device())
        with torch.no_grad():
            want_logits = trained(probe)
        got_logits = fitted.predict(tokens[:2])
        if not torch.equal(got_logits, want_logits):
            raise AssertionError(
                f"(a): the fitted model's logits differ from the trained "
                f"rank's by {max_err(got_logits, want_logits):.3e}")
        del trained, fitted, probe, want_logits, got_logits
        cs._CL_MODELS.clear()
        _release()
        split = _cl_split(est)
        steady, gaps = _cl_steps_ms(loss.stamps)
        # phase 5's step and the estimator's in turns
        turns = {"estimator_ms": [steady], "phase5_ms": []}
        for turn in range(2):
            model = cs._cl_factory(False)
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW(model.parameters(), lr=1e-4,
                                  weight_decay=1e-4),
                named_parameters=model.named_parameters())
            batch = torch.from_numpy(tokens[:CL_BATCH]).to(hvd.device())
            _, _, times = _timed_steps(model, opt, batch, CL_STEPS)
            turns["phase5_ms"].append(1e3 * statistics.median(times[1:]))
            del model, opt, batch
            cs._CL_MODELS.clear()
            _release()
            if turn == 0:
                _, _, _, again, _ = _cl_fit(cs, store, InProcessBackend(),
                                            1, False, None, out)
                turns["estimator_ms"].append(_cl_steps_ms(again.stamps)[0])
                cs._CL_MODELS.clear()
                _release()
    finally:
        hvd.shutdown()
    print(f"cluster (a): TorchEstimator(InProcessBackend) fit phase 5's "
          f"transformer ({LAYERS} layers, bf16, lm_loss, SGD lr {CL_LR} "
          f"momentum 0.9) on {len(tokens)} rows: {CL_STEPS} steps of "
          f"{CL_BATCH}, losses {[round(v, 4) for v in losses]}, metrics "
          f"{metrics[0]}; the fitted model's logits bitwise the trained "
          f"rank's; launches {counts}", flush=True)
    _cl_print_split("(a)", split, smi)
    print(f"cluster (a): step ms in turns: estimator "
          f"{[round(v, 3) for v in turns['estimator_ms']]} (SGD, the loss's "
          f"stamps; gaps of the first fit {[round(g, 3) for g in gaps]}), "
          f"phase 5's {[round(v, 3) for v in turns['phase5_ms']]} "
          f"(AdamW; phase 5 itself {phase5_ms:.3f}) on {smi}", flush=True)
    return {"metrics": metrics[0], "losses": losses, "counts": counts,
            "split": split, "step_gaps_ms": gaps, "turns": turns}


def cluster_processes(cs, smi, world, phase6_ms):
    """Phase 15 (b): the same fit through ``ProcessBackend(world)``, a
    rank a card (at one card: two gloo ranks on the CPU at ``CL_CPU``).
    -> the record."""
    from horovod_tpu_torch.cluster import ProcessBackend

    cpu = world == 1
    ranks = 2 if cpu else world
    store = os.path.join(_scratch_dir(), "cluster_b")
    out = os.path.join(_scratch_dir(), "cluster_b_rec")
    backend = ProcessBackend(ranks, device="cpu" if cpu else None,
                             extra_env={"PYTHONPATH": os.path.dirname(
                                 os.path.abspath(__file__))})
    cs._CL_MODELS.clear()
    est, fitted, metrics, _, tokens = _cl_fit(
        cs, store, backend, ranks, cpu, CL_VALIDATION, out)
    del fitted
    cs._CL_MODELS.clear()
    _release()
    _cl_metrics_ok("(b)", metrics, ranks)
    recs = _cl_records(out, ranks)
    if len({r["digest"] for r in recs}) != 1:
        raise AssertionError(f"(b): the ranks' parameters differ: "
                             f"{[r['digest'][:12] for r in recs]}")
    for r in recs:
        if len(r["losses"]) != CL_STEPS or not all(
                map(math.isfinite, r["losses"])) \
                or not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"(b) rank {r['rank']}: losses "
                                 f"{r['losses']}")
    if not cpu:
        cards = [r["card"] for r in recs]
        if sorted(cards) != list(range(world)):
            raise AssertionError(f"(b): the ranks' cards {cards}")
        for r in recs:
            # recorded at the validation loss: its cross-entropy not yet
            _cl_check_counts(f"(b) rank {r['rank']}", r["counts"], False)
    split = _cl_split(est)
    steps = [_cl_steps_ms(r["stamps"])[0] for r in recs]
    where = ("on the CPU, two gloo ranks at "
             f"{CL_CPU} (NCCL takes no two ranks on one card)" if cpu else
             f"a rank a card, cards {[r['card'] for r in recs]}")
    print(f"cluster (b): TorchEstimator(ProcessBackend({ranks})) {where}: "
          f"losses {[round(v, 4) for v in recs[0]['losses']]}, metrics "
          f"{metrics[0]} on every rank, parameters bitwise equal on every "
          f"rank (sha256 {recs[0]['digest'][:16]})", flush=True)
    _cl_print_split("(b)", split, smi)
    if not cpu:
        print(f"cluster (b): step ms a rank {[round(s, 3) for s in steps]} "
              f"(SGD) against phase 6's DO step {phase6_ms:.3f} (AdamW) at "
              f"{world} GPUs; launches a rank {recs[0]['counts']} on {smi}",
              flush=True)
    return {"metrics": metrics[0], "split": split, "steps_ms": steps,
            "records": recs, "cpu": cpu,
            "counts": None if cpu else recs[0]["counts"]}


def spark_task_result():
    """What phase 15 (c)'s Spark tasks run: the rank's placement and card,
    and an allreduce of ``rank + 1`` (integer-valued fp32: exact)."""
    import torch

    import horovod_tpu_torch as hvd

    t = torch.full((1 << 20,), float(hvd.rank() + 1), device=hvd.device())
    total = hvd.allreduce(t, op=hvd.Sum, name="p15.spark")
    if not torch.equal(total, torch.full_like(t, total[0].item())):
        raise AssertionError("allreduce result not uniform")
    return {"rank": hvd.rank(), "local_rank": hvd.local_rank(),
            "local_size": hvd.local_size(), "cross_rank": hvd.cross_rank(),
            "cross_size": hvd.cross_size(), "device": str(hvd.device()),
            "card": (torch.cuda.current_device()
                     if hvd.device().type == "cuda" else None),
            "sum": total[0].item()}


def _spark_task(index, world):
    """One of phase 15 (c)'s task processes (``--spark-task INDEX
    WORLD``): the rendezvous, the job key and the device on stdin."""
    import chip_smoke as cs
    from horovod_tpu_torch.spark import runner

    addr, port, key, device = sys.stdin.readline().split()
    res = runner._task_fn(index, world, cs.spark_task_result, (), {}, addr,
                          port, key, None,
                          None if device == "cuda" else device, 120.0)
    print("SPARK_RESULT " + json.dumps(res), flush=True)
    return 0


def cluster_spark(smi, world):
    """Phase 15 (c): ``spark/runner.py``'s task function in ``world``
    processes against a rendezvous this phase hosts, as Spark executors
    on one host run it (at one card: two on the CPU).  -> the results."""
    import base64

    from horovod_tpu_torch.run.http_server import RendezvousServer
    from horovod_tpu_torch.run.service import secret

    cpu = world == 1
    ranks = 2 if cpu else world
    env = {k: v for k, v in os.environ.items() if not k.startswith("HVD_")}
    server = RendezvousServer()
    port = server.start()
    key = base64.b64encode(secret.make_secret_key()).decode()
    t0 = time.time()
    procs = []
    try:
        for i in range(ranks):
            p = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--spark-task",
                 str(i), str(ranks)], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=os.path.dirname(os.path.abspath(__file__)))
            p.stdin.write(f"127.0.0.1 {port} {key} "
                          f"{'cpu' if cpu else 'cuda'}\n")
            p.stdin.close()
            p.stdin = None   # communicate() below reads only
            procs.append(p)
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        server.stop()
    wall = time.time() - t0
    res = []
    for i, (code, out, err) in enumerate(outs):
        lines = [x for x in out.splitlines() if x.startswith("SPARK_RESULT ")]
        if code != 0 or not lines:
            raise AssertionError(f"(c) task {i} exited {code}:\n"
                                 f"{out[-3000:]}\n{err[-3000:]}")
        res.append(json.loads(lines[-1].split(" ", 1)[1]))
    want_sum = float(ranks * (ranks + 1) // 2)
    if [r["rank"] for r in res] != list(range(ranks)) \
            or sorted(r["local_rank"] for r in res) != list(range(ranks)) \
            or any(r["local_size"] != ranks or r["cross_size"] != 1
                   for r in res) \
            or any(r["sum"] != want_sum for r in res):
        raise AssertionError(f"(c): {res}")
    if not cpu and sorted(r["card"] for r in res) != list(range(ranks)):
        raise AssertionError(f"(c): the tasks' cards {res}")
    print(f"cluster (c): spark/runner.py's task function in {ranks} "
          f"processes against this phase's rendezvous, without Spark (this "
          f"machine has no pyspark)"
          + (", on the CPU (one card)" if cpu else "")
          + f": local ranks {[r['local_rank'] for r in res]} of "
          f"{ranks} on one host, devices {[r['device'] for r in res]}, the "
          f"allreduce {want_sum} exact on every rank, {wall:.2f} s on "
          f"{smi}", flush=True)
    return {"results": res, "wall_s": wall, "cpu": cpu}


def cluster_discovery(smi):
    """Phase 15 (d): NIC discovery with two task servers started as
    processes on this machine.  -> the interfaces and the seconds."""
    from horovod_tpu_torch.run.driver_discovery import (
        discover_common_interfaces)
    from horovod_tpu_torch.run.service.network import local_interfaces

    t0 = time.time()
    ifaces, ip = discover_common_interfaces(["localhost", "localhost"],
                                            timeout=120)
    wall = time.time() - t0
    if not ifaces or ip.count(".") != 3:
        raise AssertionError(f"(d): discovery found {ifaces}, {ip}")
    print(f"cluster (d): NIC discovery with 2 task servers: interfaces "
          f"{sorted(ifaces)} (this host's: {local_interfaces()}), "
          f"rendezvous address {ip}, {wall:.2f} s on {smi}", flush=True)
    return {"interfaces": sorted(ifaces), "ip": ip, "wall_s": wall}


def cluster_phase(smi, phase5_ms, phase6_ms):
    """Phase 15: the cluster layer.  (a) :func:`cluster_in_process`; (b)
    :func:`cluster_processes` at ``min(cards, 4)`` ranks; (c)
    :func:`cluster_spark`; (d) :func:`cluster_discovery`.  At one card
    (b) and (c) run two ranks on the CPU.  -> the record."""
    import shutil

    import chip_smoke as cs

    world = _world()
    wall, out = {}, {}
    for part, fn, args in (
            ("a", cluster_in_process, (cs, smi, phase5_ms)),
            ("b", cluster_processes, (cs, smi, world, phase6_ms)),
            ("c", cluster_spark, (smi, world)),
            ("d", cluster_discovery, (smi,))):
        t0 = time.time()
        out[part] = fn(*args)
        wall[part] = time.time() - t0
    shutil.rmtree(_scratch_dir(), ignore_errors=True)
    print(f"cluster: wall s { {k: round(v, 2) for k, v in wall.items()} }",
          flush=True)
    out["wall_s"] = wall
    return out


# phase 16: the timeline (a), the hierarchical allreduce and allgather
# (b) and autotune (c).  (a): timed steps of each model after one warm
# step each, in turns; (b): rounds of the hierarchical and the flat
# collective in turns; (c): steps of the LM whose gradients go through
# the plane (enough for the walk below to pin), then steps after it
TL_PAIRS = 6
HIER_ROUNDS = 5
TUNE_WARMUP, TUNE_STEADY, TUNE_MAX = 1, 1, 4
TUNE_STEPS, TUNE_AFTER = 90, 10
# (b)'s allgather: rank r's rows of 4096 fp32 (uneven first dims)
HIER_GATHER_ROWS, HIER_GATHER_COLS = 2048, 4096


def _p16_device():
    """``P16_DEVICE`` (``cpu`` for the gloo rehearsal at one card), else
    the card."""
    return os.environ.get("P16_DEVICE") or None


def _p16_sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _timeline_off():
    """Steps inside run as with ``HVD_TIMELINE`` unset: the buckets see
    no timeline (``basics.timeline()`` is None)."""
    import dataclasses

    from horovod_tpu_torch.common import basics

    state = basics._state
    basics._state = dataclasses.replace(state, timeline=None)
    try:
        yield
    finally:
        basics._state = state


class _BackwardEnd:
    """A ``backward.end`` span a step on the timeline: from the host's
    return from ``loss.backward()`` to the moment the card reaches it
    (every gradient computed), stamped by a thread of its own so that no
    bucket's completion delays the stamp."""

    def __init__(self, tl):
        import queue
        import threading

        self.tl = tl
        self.q = queue.Queue()
        # lifecycle: close() puts the None sentinel and joins it
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def mark(self, dev):
        import torch

        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event(blocking=True)
            event.record()
        self.q.put((self.tl.now(), event))

    def _run(self):
        while True:
            item = self.q.get()  # wakeable: close()'s None sentinel
            if item is None:
                return
            begin, event = item
            if event is not None:
                event.synchronize()
            self.tl.begin("backward.end", "BACKWARD", ts=begin)
            self.tl.end("backward.end", ts=self.tl.now())

    def close(self):
        self.q.put(None)
        self.thread.join(timeout=30)


def timeline_train(layers):
    """Phase 16 (a) on one rank that ``python -m horovod_tpu_torch.run
    --timeline-filename ... --timeline-mark-cycles`` started: phase 5's
    LM twice from the same seed under ``DistributedOptimizer(AdamW)``,
    each rank its own batch, the one with the timeline and the other
    without (``_timeline_off``), a step each in turns.  The losses and
    parameters of the two must be bitwise equal, and bitwise the same on
    every rank.  -> the step times, the launches, the bucket count."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import Transformer, lm_loss
    from horovod_tpu_torch.ops import cuda as kernels

    cpu = _p16_device() == "cpu"
    hvd.init(device=_p16_device())
    try:
        r, n, dev = hvd.rank(), hvd.size(), hvd.device()
        tl = basics.timeline()
        if tl is None or not tl.enabled:
            raise AssertionError("HVD_TIMELINE did not turn the timeline on")
        cfg = _cl_config(cpu, layers)
        models, opts = {}, {}
        for k in ("on", "off"):
            models[k] = Transformer(cfg, seed=0,
                                    device="cpu" if cpu else None)
            opts[k] = hvd.DistributedOptimizer(
                torch.optim.AdamW(models[k].parameters(), lr=1e-4,
                                  weight_decay=1e-4),
                named_parameters=models[k].named_parameters())
            hvd.broadcast_parameters(models[k].state_dict(), root_rank=0)
        batch, seq = ((2, cfg.max_len) if cpu else (MAIN_BATCH, MAIN_SEQ))
        tokens = torch.from_numpy(np.random.RandomState(r).randint(
            0, cfg.vocab_size, (batch, seq))).to(dev)
        # the plane's spans and cycle marks, before and after the steps
        ones = torch.ones(1 << 20, device=dev)
        hvd.allreduce(ones, op=hvd.Sum, name="p16.plane")
        marker = _BackwardEnd(tl)
        losses = {"on": [], "off": []}
        times = {"on": [], "off": []}
        kernels.reset_launch_counts()
        for i in range(1 + TL_PAIRS):
            for k in ("on", "off"):
                with contextlib.ExitStack() as stack:
                    if k == "off":
                        stack.enter_context(_timeline_off())
                    _p16_sync(dev)
                    t0 = time.perf_counter()
                    opts[k].zero_grad(set_to_none=True)
                    loss = lm_loss(models[k](tokens), tokens)
                    loss.backward()
                    if k == "on":
                        marker.mark(dev)
                    opts[k].step()
                    _p16_sync(dev)
                    dt = time.perf_counter() - t0
                losses[k].append(loss.item())
                if i:
                    times[k].append(dt)
        counts = kernels.launch_counts()
        marker.close()
        if hvd.allreduce(ones, op=hvd.Sum, name="p16.plane")[0].item() != n:
            raise AssertionError("the plane's allreduce is wrong")
        if losses["on"] != losses["off"]:
            raise AssertionError(f"rank {r}: the losses differ with and "
                                 f"without the timeline: {losses}")
        if not torch.equal(_flat_params(models["on"]),
                           _flat_params(models["off"])):
            raise AssertionError(f"rank {r}: the parameters differ with "
                                 f"and without the timeline")
        _same_on_every_rank("phase 16 (a) parameters",
                            _flat_params(models["on"]))
        if not all(np.isfinite(losses["on"])) \
                or not losses["on"][-1] < losses["on"][0]:
            raise AssertionError(f"rank {r}: loss not finite or not "
                                 f"falling: {losses['on']}")
        buckets = len(opts["on"]._buckets)
    finally:
        hvd.shutdown()
    if not cpu:
        expect_launches(f"phase 16 (a) rank {r}", counts,
                        per_step_launches(layers), 2 * (1 + TL_PAIRS))
    return {"rank": r, "world": n, "losses": losses["on"],
            "step_s": times, "counts": counts, "buckets": buckets,
            "steps": 1 + TL_PAIRS}


def _spans(events, row):
    """The ``(B ts, E ts, E args, name)`` spans of the merged trace's
    ``row``, in the order written; each ``B`` must be closed by the next
    record of the row, an ``E`` no earlier than it."""
    pids = [e["pid"] for e in events if e.get("name") == "process_name"
            and e["args"]["name"] == row]
    if len(pids) != 1:
        raise AssertionError(f"phase 16 (a): {len(pids)} rows {row!r} in "
                             f"the merged trace")
    # in the order written: a span's B and E are written together, and
    # a completion stamped late still follows its B
    recs = [e for e in events if e.get("pid") == pids[0]
            and e.get("ph") in ("B", "E")]
    spans = []
    for b, e in zip(recs[::2], recs[1::2]):
        if (b["ph"], e["ph"]) != ("B", "E") or e["ts"] < b["ts"]:
            raise AssertionError(f"phase 16 (a): row {row!r} is not a "
                                 f"sequence of balanced spans: {b} {e}")
        spans.append((b["ts"], e["ts"], e.get("args", {}), b["name"]))
    if len(recs) % 2:
        raise AssertionError(f"phase 16 (a): row {row!r} has an open span")
    return spans


def _check_trace(path, world, buckets, steps):
    """The merged trace of (a): it parses, every rank's rows are in it
    (the cycle marks, the plane's two allreduces with their negotiation),
    and every bucket has ``steps`` balanced ``ALLREDUCE`` spans on every
    rank.  -> a step's bucket span time and how much of it lies before
    the card reached the end of the backward (ROADMAP B.9), a rank."""
    with open(path) as f:
        events = json.load(f)
    rows = {e["args"]["name"] for e in events
            if e.get("name") == "process_name"}
    out = []
    for r in range(world):
        if f"rank {r}: CYCLE" not in rows:
            raise AssertionError(f"phase 16 (a): no CYCLE row of rank {r}")
        plane = [x[3] for x in _spans(events, f"rank {r}: p16.plane")]
        if sorted(plane) != ["ALLREDUCE"] * 2 + ["NEGOTIATE_ALLREDUCE"] * 2:
            raise AssertionError(f"phase 16 (a): rank {r}'s plane spans "
                                 f"{plane}")
        ends = [x[1] for x in _spans(events, f"rank {r}: backward.end")]
        per_bucket = []
        for b in range(buckets):
            spans = _spans(events, f"rank {r}: DistributedOptimizer."
                                   f"bucket.{b}")
            if len(spans) != steps or not all(x[2].get("bytes")
                                              for x in spans):
                raise AssertionError(f"phase 16 (a): rank {r} bucket {b}: "
                                     f"{len(spans)} spans of {steps}")
            per_bucket.append(spans)
        if len(ends) != steps:
            raise AssertionError(f"phase 16 (a): rank {r}: {len(ends)} "
                                 f"backward marks of {steps}")
        total, hidden, before = [], [], []
        for s in range(1, steps):     # the first step warms up
            spans = [pb[s] for pb in per_bucket]
            total.append(sum(e - b for b, e, *_ in spans) / 1e3)
            hidden.append(sum(max(0, min(e, ends[s]) - b)
                              for b, e, *_ in spans) / 1e3)
            before.append(sum(e <= ends[s] for _, e, *_ in spans))
        out.append({"bucket_span_ms": statistics.median(total),
                    "before_backward_end_ms": statistics.median(hidden),
                    "buckets_done_before": statistics.median(before)})
    return out


def _p16_job(name, world, phase, layers=LAYERS, extra=(), env=None):
    """One phase 16 job through ``python -m horovod_tpu_torch.run`` (rank
    logs in ``chiprun_out/p16/<name>/``) with ``env`` added; -> each
    rank's ``RANK_RESULT``."""
    logs = os.path.join(_out_dir(), "p16", name)
    code, _ = _launcher_cli(world, logs, phase, layers, extra, timeout=600,
                            env=env)
    return _rank_results(f"phase 16 {name}", logs, world, code)


def hier_rank(layers):
    """Phase 16 (b) on one rank, ``HVD_HIERARCHICAL_ALLREDUCE=1
    HVD_HIERARCHICAL_ALLGATHER=1 HVD_HIER_LOCAL_SIZE=2``: the plane's
    ``grouped_allreduce`` of fp32 gradients of phase 5's shapes (each
    rank its own), an int32 allreduce and an allgather of uneven first
    dimensions, hierarchical and flat in turns (every rank switches the
    executor before its next submission).  Floats within the test's
    tolerance of the flat result, integers exact, every rank the same
    bytes.  -> the times."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    cpu = _p16_device() == "cpu"
    hvd.init(device=_p16_device())
    try:
        r, n, dev = hvd.rank(), hvd.size(), hvd.device()
        ex = basics._get_state().controller._executor
        if ex.hier is None or ex.hier[2] != HIER_LOCAL \
                or not ex.hierarchical_allreduce:
            raise AssertionError(f"no {HIER_LOCAL}-rank hierarchy: "
                                 f"{ex.hier}")
        from horovod_tpu_torch.models import Transformer
        shapes = [p.shape for p in Transformer(
            _cl_config(cpu, layers), seed=0,
            device="cpu" if cpu else None).parameters()]
        gen = torch.Generator(device=dev).manual_seed(100 + r)
        grads = [torch.randn(s, generator=gen, device=dev) for s in shapes]
        ints = torch.randint(-1000, 1000, (1 << (12 if cpu else 22),),
                             generator=gen, device=dev, dtype=torch.int32)
        rows = (HIER_GATHER_ROWS // 64 if cpu else HIER_GATHER_ROWS)
        gath = torch.randn(rows * (r + 1), HIER_GATHER_COLS // (
            64 if cpu else 1), generator=gen, device=dev)
        total = sum(g.numel() for g in grads)
        out, times = {}, {"allreduce": {}, "allgather": {}}
        for i in range(1 + HIER_ROUNDS):
            for mode in ("hier", "flat"):
                ex.hierarchical_allreduce = ex.hierarchical_allgather = \
                    mode == "hier"
                _p16_sync(dev)
                t0 = time.perf_counter()
                red = hvd.grouped_allreduce(grads, op=hvd.Sum,
                                            name=f"p16.grads.{mode}")
                _p16_sync(dev)
                t1 = time.perf_counter()
                gathered = hvd.allgather(gath, name=f"p16.gather.{mode}")
                _p16_sync(dev)
                t2 = time.perf_counter()
                if i:
                    times["allreduce"].setdefault(mode, []).append(t1 - t0)
                    times["allgather"].setdefault(mode, []).append(t2 - t1)
                if i == 0:
                    out[mode] = (torch.cat([x.reshape(-1) for x in red]),
                                 hvd.allreduce(ints, op=hvd.Sum,
                                               name=f"p16.ints.{mode}"),
                                 gathered)
                del red, gathered
        (fh, ih, gh), (ff, if_, gf) = out["hier"], out["flat"]
        err = max_err(fh, ff)
        if not torch.allclose(fh, ff, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"rank {r}: the hierarchical allreduce is "
                                 f"{err:.3e} from the flat one")
        if not torch.equal(ih, if_) or not torch.equal(gh, gf):
            raise AssertionError(f"rank {r}: integers or the allgather "
                                 f"differ between hierarchical and flat")
        if gh.shape[0] != rows * n * (n + 1) // 2:
            raise AssertionError(f"allgather rows {gh.shape[0]}")
        for what, t in (("allreduce", fh), ("ints", ih), ("gather", gh)):
            _same_on_every_rank(f"phase 16 (b) hierarchical {what}", t)
        wires = dict(ex.wires)
    finally:
        hvd.shutdown()
    return {"rank": r, "world": n, "elements": total,
            "gather_bytes": gh.numel() * 4, "max_abs_err": err,
            "wires": wires, "ms": {
                op: {m: 1e3 * statistics.median(v) for m, v in d.items()}
                for op, d in times.items()}}


def tune_train(layers):
    """Phase 16 (c) on one rank, ``HVD_AUTOTUNE=1`` with small sample
    counts and ``HVD_HIER_LOCAL_SIZE=2``: phase 5's LM whose gradients
    go through the plane (``grouped_allreduce``, op Average, then
    AdamW), ``TUNE_STEPS + TUNE_AFTER`` steps.  -> the tuner's
    applications, the final values, the steps' times and the
    negotiation of each step's cycles."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import Transformer, lm_loss
    from horovod_tpu_torch.ops import cuda as kernels

    cpu = _p16_device() == "cpu"
    hvd.init(device=_p16_device())
    try:
        r, n, dev = hvd.rank(), hvd.size(), hvd.device()
        controller = basics._get_state().controller
        cfg = _cl_config(cpu, layers)
        model = Transformer(cfg, seed=0, device="cpu" if cpu else None)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        params = list(model.parameters())
        opt = torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4)
        batch, seq = ((2, cfg.max_len) if cpu else (MAIN_BATCH, MAIN_SEQ))
        tokens = torch.from_numpy(np.random.RandomState(r).randint(
            0, cfg.vocab_size, (batch, seq))).to(dev)
        losses, steps = [], []
        kernels.reset_launch_counts()
        for _ in range(TUNE_STEPS + TUNE_AFTER):
            _p16_sync(dev)
            c0 = controller.cycles
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = lm_loss(model(tokens), tokens)
            loss.backward()
            red = hvd.grouped_allreduce([p.grad for p in params],
                                        op=hvd.Average, name="p16.tune")
            for p, g in zip(params, red):
                p.grad.copy_(g)
            opt.step()
            losses.append(loss.item())
            _p16_sync(dev)
            cycles = controller.cycles - c0
            neg = list(controller._negotiation_s)[-cycles:] if cycles else []
            steps.append({"s": time.perf_counter() - t0,
                          "end_cycle": controller.cycles,
                          "negotiation_ms": [1e3 * x for x in neg]})
        counts = kernels.launch_counts()
        apps = controller.tuned_applications()
        final = controller.tuned_params()
        _same_on_every_rank("phase 16 (c) parameters", _flat_params(model))
    finally:
        hvd.shutdown()
    if not cpu:
        expect_launches(f"phase 16 (c) rank {r}", counts,
                        per_step_launches(layers), TUNE_STEPS + TUNE_AFTER)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"rank {r}: loss not finite or not falling")
    return {"rank": r, "world": n, "applications": apps, "params": final,
            "steps": steps, "counts": counts}


def _tune_split(res):
    """Rank ``res``'s steps before and after the cycle the pinned values
    were applied at: the median step ms and negotiation ms of each."""
    pin = res["applications"][-1][0]
    split = {"before": [], "after": []}
    for st in res["steps"][1:]:
        split["before" if st["end_cycle"] <= pin else "after"].append(st)
    return {k: {"steps": len(v),
                "step_ms": (1e3 * statistics.median(x["s"] for x in v)
                            if v else None),
                "negotiation_ms": (statistics.median(
                    y for x in v for y in x["negotiation_ms"])
                    if any(x["negotiation_ms"] for x in v) else None)}
            for k, v in split.items()}


def _card_memory(where):
    """Print this process's card memory (phase 16 (a)'s launched rank
    shares the card with it at one card); above 8 GB allocated, the
    largest live tensors and what holds them."""
    import gc

    import torch

    free, total = torch.cuda.mem_get_info()
    alloc = torch.cuda.memory_allocated()
    print(f"{where}: this process holds {alloc / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; the "
          f"card has {free / 2**30:.2f} of {total / 2**30:.2f} GiB free",
          flush=True)
    if alloc < 8 * 2**30:
        return
    live = sorted((o for o in gc.get_objects() if torch.is_tensor(o)
                   and o.is_cuda), key=lambda t: -t.numel()
                  * t.element_size())[:10]
    for t in live:
        holders = {type(h).__name__ for h in gc.get_referrers(t)}
        print(f"  {tuple(t.shape)} {t.dtype} held by {sorted(holders)}",
              flush=True)


def timeline_phase(smi, phase5_ms):
    """Phase 16: (a) the timeline around phase 5's LM at ``min(cards,
    4)`` ranks through the launcher's ``--timeline-filename`` and
    ``--timeline-mark-cycles``, a step with it and a step without in
    turns; the merged trace checked in this process.  (b) the
    hierarchical allreduce and allgather (2 x 2) against flat in turns
    and (c) autotune on the LM whose gradients go through the plane,
    both at four ranks: on the cards above one card, else four gloo
    ranks on the CPU at ``CL_CPU``'s width, which the phase says.  ->
    the results, with the launches of (a) and (c)."""
    import shutil

    world = _world()
    head = f"phase 16 ({world} rank{'s' if world > 1 else ''})"
    res = {}
    trace_dir = os.path.join(_out_dir(), "p16", "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    os.makedirs(trace_dir)
    trace = os.path.join(trace_dir, "timeline.json")
    ranks = _p16_job("timeline", world, "timeline_train", LAYERS,
                     ("--timeline-filename", trace,
                      "--timeline-mark-cycles"))
    b9 = _check_trace(trace, world, ranks[0]["buckets"], ranks[0]["steps"])
    on = [1e3 * statistics.median(x["step_s"]["on"]) for x in ranks]
    off = [1e3 * statistics.median(x["step_s"]["off"]) for x in ranks]
    res["a"] = {"ranks": ranks, "b9": b9, "step_ms_on": on,
                "step_ms_off": off,
                "trace_bytes": os.path.getsize(trace)}
    print(f"{head} (a): timeline on/off, DistributedOptimizer step ms "
          f"(median of {ranks[0]['steps'] - 1}, in turns) a rank: on "
          f"{[round(x, 3) for x in on]}, off {[round(x, 3) for x in off]} "
          f"(phase 5: {phase5_ms:.3f}); losses and parameters bitwise "
          f"equal; merged trace {res['a']['trace_bytes']} bytes, "
          f"{ranks[0]['buckets']} buckets x {ranks[0]['steps']} balanced "
          f"ALLREDUCE spans a rank; on {smi}", flush=True)
    print(f"{head} (a): B.9, a step's bucket spans (host issue to card "
          f"completion) ms a rank: "
          f"{[round(x['bucket_span_ms'], 3) for x in b9]}, of it before "
          f"the card ended the backward "
          f"{[round(x['before_backward_end_ms'], 3) for x in b9]}, buckets "
          f"done by then {[x['buckets_done_before'] for x in b9]} of "
          f"{ranks[0]['buckets']}", flush=True)

    cpu = world < 4
    four = {"P16_DEVICE": "cpu"} if cpu else {}
    where = "4 gloo ranks on the CPU at CL_CPU's width" if cpu else \
        "four cards"
    hier_env = dict(four, HVD_HIERARCHICAL_ALLREDUCE="1",
                    HVD_HIERARCHICAL_ALLGATHER="1",
                    HVD_HIER_LOCAL_SIZE=str(HIER_LOCAL))
    tune_env = dict(four, HVD_AUTOTUNE="1",
                    HVD_AUTOTUNE_LOG=os.path.join(_out_dir(), "p16",
                                                  "autotune.csv"),
                    HVD_AUTOTUNE_WARMUP_SAMPLES=str(TUNE_WARMUP),
                    HVD_AUTOTUNE_STEADY_STATE_SAMPLES=str(TUNE_STEADY),
                    HVD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES=str(TUNE_MAX),
                    HVD_HIER_LOCAL_SIZE=str(HIER_LOCAL))
    # on the CPU (b) and (c) run side by side
    jobs = _jobs(_p16_job, {
        "hier": ("hier", 4, "hier_rank", LAYERS, (), hier_env),
        "tune": ("tune", 4, "tune_train", LAYERS, (), tune_env)}, cpu)
    hier = jobs["hier"]()
    res["b"] = hier
    ms = hier[0]["ms"]
    gb = hier[0]["elements"] * 4 / 1e9
    print(f"{head} (b) on {where}: the plane's grouped_allreduce of "
          f"{hier[0]['elements']} fp32 gradients, hierarchical (2 x 2) "
          f"{ms['allreduce']['hier']:.3f} ms ({gb / ms['allreduce']['hier'] * 1e3:.1f} GB/s "
          f"algorithmic) vs flat {ms['allreduce']['flat']:.3f} ms; "
          f"allgather of {hier[0]['gather_bytes']} bytes a rank at most, "
          f"hierarchical {ms['allgather']['hier']:.3f} ms vs flat "
          f"{ms['allgather']['flat']:.3f} ms (median of {HIER_ROUNDS}, in "
          f"turns); max abs err vs flat "
          f"{max(x['max_abs_err'] for x in hier):.3e}, integers and the "
          f"gather exact, every rank the same bytes; on "
          f"{smi if not cpu else 'the CPU beside (c)'}", flush=True)

    tune = jobs["tune"]()
    res["c"] = tune
    first = tune[0]
    for x in tune[1:]:
        if x["applications"] != first["applications"] \
                or x["params"] != first["params"]:
            raise AssertionError(f"phase 16 (c): rank {x['rank']} applied "
                                 f"other tuned values than rank 0")
    if first["params"]["tuning"] or len(first["applications"]) < 2:
        raise AssertionError(f"phase 16 (c): the walk did not pin: "
                             f"{first['params']}")
    with open(tune_env["HVD_AUTOTUNE_LOG"]) as f:
        rows = f.read().strip().splitlines()
    samples = 5 * TUNE_MAX    # five categoricals, no compressor
    if len(rows) != 1 + samples:
        raise AssertionError(f"phase 16 (c): {len(rows) - 1} CSV rows for "
                             f"{samples} samples")
    split = _tune_split(first)
    res["c_split"] = split
    print(f"{head} (c) on {where}: autotune walked {samples} samples in "
          f"{len(first['applications'])} publications (the same cycles on "
          f"every rank), pinned {first['params']}; rank 0's step ms "
          f"before/after pinning {split['before']['step_ms']} / "
          f"{split['after']['step_ms']} over {split['before']['steps']} / "
          f"{split['after']['steps']} steps, negotiation median ms "
          f"{split['before']['negotiation_ms']} / "
          f"{split['after']['negotiation_ms']}; on {smi}", flush=True)
    res["counts"] = {"phase16a": ranks[0]["counts"]}
    if not cpu:
        res["counts"]["phase16c"] = first["counts"]
    return res


# phase 17: the session layer.  Phase 13's windows; each job takes
# SE_STEPS steps of phase 5's main path under DistributedOptimizer, each
# step ending with a plane allgather of every rank's loss, in which the
# last rank's fault spec is armed at step SE_FAULT_STEP.  (a)'s blip
# (SE_BLIP_MS) lies well inside its budget (SE_BUDGET_S); (b)'s reset cuts
# every frame the rank writes for SE_RESET_S, past its budget
# (SE_RESET_BUDGET_S), which is shorter than the liveness window, so that
# the rank whose link broke is the first to raise
SE_STEPS, SE_FAULT_STEP = 8, 4
SE_BLIP_MS, SE_BUDGET_S = 1000, 5.0
SE_RESET_S, SE_RESET_BUDGET_S = 4.0, 1.0


def session_train(layers):
    """Phase 17 on one launched rank: phase 5's main path (the
    full-width transformer, ``DistributedOptimizer(AdamW(1e-4, wd
    1e-4))``, ``[8, 2048]`` tokens a GPU, each rank its own; on the CPU
    at one card phase 15's small width), each step ending with
    ``hvd.allgather`` of every rank's loss on the eager plane, over the
    coordinator link that the last rank's fault spec breaks at step
    ``SE_FAULT_STEP``.  -> the rank's numbers: every rank's losses, the
    step and allgather times, the parameters' digest, the session
    counters and the launches, or the typed error and when."""
    import hashlib

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer, lm_loss
    from horovod_tpu_torch.ops import cuda as kernels
    from horovod_tpu_torch.run.service import network

    cpu = os.environ.get("P13_DEVICE") == "cpu"
    if cpu:
        # one intra-op thread: the CPU's multi-threaded kernels do not
        # give the same bits twice, and (a) compares two runs bitwise
        torch.set_num_threads(1)
    terms = _ft_init()
    r, n = hvd.rank(), hvd.size()
    model = Transformer(_cl_config(cpu, layers), device=hvd.device(),
                        seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    shape = (CL_BATCH, CL_CPU["seq"]) if cpu else (MAIN_BATCH, MAIN_SEQ)
    vocab = CL_CPU["vocab_size"] if cpu else VOCAB
    tokens = torch.from_numpy(np.random.RandomState(r).randint(
        0, vocab, shape)).to(hvd.device())
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    kernels.reset_launch_counts()
    losses, step_s, gather_s, error, fault_at = [], [], [], None, None
    start = time.perf_counter()
    try:
        for step in range(1, SE_STEPS + 1):
            sync()
            start = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = lm_loss(model(tokens), tokens)
            loss.backward()
            opt.step()
            sync()
            t0 = time.perf_counter()
            if step == SE_FAULT_STEP:
                fault_at = time.time()
            everyone = hvd.allgather(loss.detach().float().view(1),
                                     name="p17.loss")
            gather_s.append(time.perf_counter() - t0)
            losses.append([float(x) for x in everyone])
            step_s.append(time.perf_counter() - start)
    except hvd.HvdAbortedError as exc:
        error = _ft_error(exc, start, f"step {len(step_s) + 1}")
    digest = hashlib.sha256(b"".join(
        p.detach().float().cpu().numpy().tobytes()
        for p in model.parameters())).hexdigest()
    return _ft_done({"rank": r, "world": n, "losses": losses,
                     "step_s": step_s, "gather_s": gather_s,
                     "fault_at": fault_at, "error": error, "digest": digest,
                     "session": network.session_stats(),
                     "counts": kernels.launch_counts()}, terms)


def session_phase(smi, phase5_step_ms):
    """Phase 17 at ``min(cards, 4)`` ranks, each job started through
    ``python -m horovod_tpu_torch.run`` with phase 13's windows: (a)
    ``session_train`` under ``--reconnect-budget SE_BUDGET_S``, without a
    fault and then with ``rank{W-1}:allgather:K:blip:SE_BLIP_MS``: both
    finish, the loss falls, every kernel at its count a step, and every
    rank's parameters and losses are bitwise the unblipped run's; (b)
    ``rank{W-1}:allgather:K:reset:1.0:SE_RESET_S`` under
    ``--reconnect-budget SE_RESET_BUDGET_S``: the last rank raises the
    typed abort naming the coordinator (its heal ran out), every other
    rank raises it naming the last rank, and no worker is left.  At one
    card there is no control plane (size 1), so both run at two ranks on
    the CPU, which the phase says.  -> the jobs' results."""
    world = _world()
    env = None
    if world == 1:
        env, world = {"P13_DEVICE": "cpu"}, 2
        print("session: one card, and a world of one has no control "
              "plane: (a) and (b) run at two ranks on the CPU (gloo; the "
              "control plane is the same host code) at phase 15's small "
              "width", flush=True)
    last, k = world - 1, SE_FAULT_STEP
    on = " on the CPU" if env else f" on {smi}"

    def job(name, budget, spec=None):
        code, text, res, alive = _ft_job(
            name, world, "session_train", LAYERS,
            _ft_flags(spec) + ("--reconnect-budget", str(budget)), env,
            where="session")
        if code != 0 or alive or None in res:
            raise AssertionError(f"phase 17 {name}: exit {code}, alive "
                                 f"{alive}:\n{text[-4000:]}")
        return res

    specs = {
        "clean": ("clean", SE_BUDGET_S),
        "blip": ("blip", SE_BUDGET_S,
                 f"rank{last}:allgather:{k}:blip:{SE_BLIP_MS}"),
        "reset": ("reset", SE_RESET_BUDGET_S,
                  f"rank{last}:allgather:{k}:reset:1.0:{SE_RESET_S:g}")}
    # at one card the three CPU jobs side by side; on the cards (b)'s
    # reset beside the clean run, then the blip that (a) times alone
    jobs = _jobs(job, specs if env else
                 {n: specs[n] for n in ("clean", "reset")}, True)
    out, wall = {}, {}
    t0 = time.time()
    clean = jobs["clean"]()
    if "blip" not in jobs:
        jobs["reset"]()
        jobs["blip"] = functools.partial(job, *specs["blip"])
    blip = jobs["blip"]()
    for r in range(world):
        c, b = clean[r], blip[r]
        if c["error"] or b["error"] or len(b["losses"]) != SE_STEPS:
            raise AssertionError(f"phase 17 (a): rank {r}: {c} {b}")
        if b["digest"] != c["digest"] or b["losses"] != c["losses"] \
                or b["digest"] != blip[0]["digest"]:
            raise AssertionError(
                f"phase 17 (a): rank {r}'s parameters or losses differ "
                f"from the unblipped run's or rank 0's: {c} {b}")
        own = [step[r] for step in b["losses"]]
        if not (all(math.isfinite(x) for x in own) and own[-1] < own[0]):
            raise AssertionError(f"phase 17 (a): rank {r}'s loss did not "
                                 f"fall: {own}")
        if env is None:
            expect_launches(f"phase 17 (a) rank {r}", b["counts"],
                            per_step_launches(LAYERS), SE_STEPS)
    stats = blip[last]["session"]
    if stats["reconnects_healed"] < 1 or stats["reconnects_failed"]:
        raise AssertionError(f"phase 17 (a): rank {last}'s session "
                             f"counters {stats}")
    wall["a"] = time.time() - t0
    e = blip[last]
    steps_else = e["step_s"][1:k - 1] + e["step_s"][k:]
    gathers_else = e["gather_s"][1:k - 1] + e["gather_s"][k:]
    print(f"session (a) rank {last} of {world}: the {SE_BLIP_MS} ms blip "
          f"at step {k} healed inside the {SE_BUDGET_S:g} s budget: the "
          f"allgather it cut returned {e['gather_s'][k - 1]:.3f} s after "
          f"its submit (the others' median "
          f"{1e3 * statistics.median(gathers_else):.3f} ms), "
          f"{stats['frames_replayed']} frame(s) replayed, "
          f"{stats['reconnects_healed']} heal(s); step {k} "
          f"{1e3 * e['step_s'][k - 1]:.2f} ms, the others' median "
          f"{1e3 * statistics.median(steps_else):.2f} ms (phase 5: "
          f"{phase5_step_ms:.2f} ms); every rank's parameters and losses "
          f"bitwise the unblipped run's; loss {e['losses'][0][last]:.4f} "
          f"-> {e['losses'][-1][last]:.4f}{on} ({wall['a']:.1f} s)",
          flush=True)
    out["clean"], out["blip"] = clean, blip

    t0 = time.time()
    res = jobs["reset"]()
    reset_at = res[last]["fault_at"]
    for r, e in enumerate(res):
        err, origin = e["error"], 0 if r == last else last
        if not err or err["type"] != "HvdAbortedError" \
                or err["origin"] != origin or reset_at is None \
                or err["at"] - reset_at >= FT_ABORT_S:
            raise AssertionError(f"phase 17 (b): rank {r}: {e}")
    wall["b"] = time.time() - t0
    for r, e in enumerate(res):
        err = e["error"]
        print(f"session (b) rank {r} of {world}: {err['type']}(origin="
              f"{err['origin']}) out of {err['where']} "
              f"{err['at'] - reset_at:.3f} s after the reset of rank "
              f"{last}'s link ('{err['reason']}'); session {e['session']}; "
              f"shutdown {e['shutdown_s']:.3f} s{on}", flush=True)
    print(f"session (b): the {SE_RESET_S:g} s reset outlasted the "
          f"{SE_RESET_BUDGET_S:g} s budget: every rank raised the typed "
          f"abort, no rank alive ({wall['b']:.1f} s)", flush=True)
    out["reset"] = res
    print(f"session: wall s { {k: round(v, 2) for k, v in wall.items()} }"
          + " ((b) ran beside (a))",
          flush=True)
    out["wall_s"] = wall
    return out


# phase 18: the framework bindings' host bridge.  The MXNet binding
# drives it (the machine has no TensorFlow, Keras or MXNet; the repo's
# numpy stand-in takes MXNet's place): (a)-(c) one SGD step of rate
# BR_LR and a broadcast, (d) the exchange of phase 5's gradients in
# BR_ROUNDS rounds.  (a) and (b) hold the host's parameters to the card's
# DistributedOptimizer step within BR_RTOL, plus BR_ATOL_SHARE of that
# tensor's largest update (the sums' order differs between the two)
BR_LR, BR_ROUNDS = 1e-2, 5
BR_RTOL, BR_ATOL_SHARE = 1e-6, 1e-5


def _mx_shim():
    """The repo's MXNet stand-in (``tests/_mxnet_shim``), first on
    ``sys.path``; -> the module.  No fallback: without it the phase
    fails."""
    shim = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "_mxnet_shim")
    if shim not in sys.path:
        sys.path.insert(0, shim)
    import mxnet

    if getattr(mxnet, "__version__", None) != "0.0-shim":
        raise AssertionError(f"phase 18: mxnet is {mxnet!r}, not the "
                             f"repo's stand-in at {shim}")
    return mxnet


def _br_digest(arrays):
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


def _br_against(what, host, ref, w0):
    """``host`` (numpy) against the card's step ``ref`` from ``w0``:
    -> (the largest error, the elements past BR_RTOL alone); raises past
    BR_RTOL plus BR_ATOL_SHARE of the tensor's largest update."""
    import numpy as np

    worst, past = 0.0, 0
    for i, (h, r, w) in enumerate(zip(host, ref, w0)):
        err = np.abs(h - r)
        atol = BR_ATOL_SHARE * float(np.max(np.abs(w - r)))
        if not np.all(err <= BR_RTOL * np.abs(r) + atol):
            raise AssertionError(
                f"phase 18 {what}: tensor {i} differs from "
                f"hvd.DistributedOptimizer's step by up to "
                f"{float(err.max()):.3e} "
                f"(rtol {BR_RTOL}, atol {atol:.3e})")
        worst = max(worst, float(err.max()))
        past += int(np.sum(err > BR_RTOL * np.abs(r)))
    return worst, past


def bridge_train(layers):
    """Phase 18 on one launched rank (``P13_DEVICE=cpu``: on the CPU):
    ``bridge_rank`` between ``hvd.init()`` and the timed shutdown."""
    terms = _ft_init()
    return _ft_done(bridge_rank(layers, os.environ.get("P13_DEVICE") ==
                                "cpu"), terms)


def bridge_rank(layers, cpu, before_d=None):
    """Phase 18 on this rank, ``hvd.init()`` done: phase 5's LM (on the
    CPU phase 15's small width) takes one forward and backward on the
    rank's own batch; its parameters and gradients in fp32 go to the
    host as NDArrays of the MXNet stand-in, and the MXNet binding's
    (a) ``DistributedOptimizer(SGD(BR_LR))`` (``update`` per index for
    the first half, the tuple index for the rest), (b)
    ``DistributedTrainer`` over gluon Parameters and (c)
    ``broadcast_parameters`` from the last rank run above one rank,
    (a)-(b) beside the card's ``DistributedOptimizer(SGD(BR_LR))`` on the
    same gradients; on the card (d) times the binding's exchange of the
    gradients (``DistributedTrainer._allreduce_grads``: every gradient
    submitted, then waited for), the per-tensor synchronous exchange and
    the plane's ``grouped_allreduce`` of the gradients on the card, in
    turns, after ``before_d()`` returns.  -> the rank's numbers."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import host_bridge
    from horovod_tpu_torch.models import Transformer, lm_loss
    from horovod_tpu_torch.ops import cuda as kernels

    mx = _mx_shim()
    import horovod_tpu_torch.mxnet as hvd_mx

    r, n = hvd.rank(), hvd.size()
    dev = hvd.device()
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    model = Transformer(_cl_config(cpu, layers), device=dev, seed=0)
    shape = (CL_BATCH, CL_CPU["seq"]) if cpu else (MAIN_BATCH, MAIN_SEQ)
    vocab = CL_CPU["vocab_size"] if cpu else VOCAB
    tokens = torch.from_numpy(np.random.RandomState(r).randint(
        0, vocab, shape)).to(dev)
    kernels.reset_launch_counts()
    lm_loss(model(tokens), tokens).backward()
    sync()
    res = {"rank": r, "world": n, "counts": kernels.launch_counts()}
    params = [p.detach().float() for p in model.parameters()]
    grads = [p.grad.detach().float() for p in model.parameters()]
    del model
    w0 = [p.cpu().numpy() for p in params]
    g0 = [g.cpu().numpy() for g in grads]
    res["tensors"] = len(g0)
    res["elements"] = int(sum(g.size for g in g0))

    if n > 1:
        # the card's step on the same gradients: the reference
        ref = [torch.nn.Parameter(p.clone()) for p in params]
        for p, g in zip(ref, grads):
            p.grad = g.clone()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(ref, lr=BR_LR),
            named_parameters=[(f"p{i}", p) for i, p in enumerate(ref)])
        opt.step()
        want = [p.detach().cpu().numpy() for p in ref]
        del opt, ref

        # (a) the optimizer: update per index, then the tuple index
        dopt = hvd_mx.DistributedOptimizer(
            mx.optimizer.SGD(learning_rate=BR_LR))
        ws = [mx.nd.array(w.copy()) for w in w0]
        gs = [mx.nd.array(g.copy()) for g in g0]
        half = len(ws) // 2
        t0 = time.perf_counter()
        for i in range(half):
            dopt.update(i, ws[i], gs[i], None)
        dopt.update(tuple(range(half, len(ws))), ws[half:], gs[half:],
                    [None] * (len(ws) - half))
        res["a_s"] = time.perf_counter() - t0
        host = [w.asnumpy() for w in ws]
        res["a_err"], res["a_past_rtol"] = _br_against(
            "(a) DistributedOptimizer", host, want, w0)
        res["a_digest"] = _br_digest(host)
        del ws, gs, host

        # (b) the trainer over gluon Parameters holding the gradients
        gparams = [mx.gluon.Parameter(f"p{i}", data=mx.nd.array(w.copy()))
                   for i, w in enumerate(w0)]
        for p, g in zip(gparams, g0):
            p.grad[:] = g
        trainer = hvd_mx.DistributedTrainer(
            gparams, mx.optimizer.SGD(learning_rate=BR_LR))
        if trainer._kvstore is not None:
            raise AssertionError("phase 18 (b): kvstore is not None")
        t0 = time.perf_counter()
        trainer.step(batch_size=1)
        res["b_s"] = time.perf_counter() - t0
        host = [p.data().asnumpy() for p in gparams]
        res["b_err"], res["b_past_rtol"] = _br_against(
            "(b) DistributedTrainer", host, want, w0)
        res["b_digest"] = _br_digest(host)
        del gparams, trainer, host, want

        # (c) every tensor from the last rank
        own = {f"p{i:03d}": mx.nd.array(g.copy()) for i, g in enumerate(g0)}
        res["c_own_digest"] = _br_digest(g0)
        t0 = time.perf_counter()
        hvd_mx.broadcast_parameters(own, root_rank=n - 1)
        res["c_s"] = time.perf_counter() - t0
        res["c_digest"] = _br_digest(
            [own[k].asnumpy() for k in sorted(own)])
        del own

    if not cpu:
        if before_d is not None:
            before_d()
        # (d) the exchange of the gradients, in turns: the binding's
        # (all submitted, then waited for), the binding's one tensor at a
        # time (as the JAX binding exchanges), the plane's on the card
        gparams = [mx.gluon.Parameter(f"d{i}", data=mx.nd.array(g.copy()))
                   for i, g in enumerate(g0)]
        for p, g in zip(gparams, g0):
            p.grad[:] = g
        trainer = hvd_mx.DistributedTrainer(
            gparams, mx.optimizer.SGD(learning_rate=BR_LR))
        rounds = {k: [] for k in ("async", "sync", "resident", "to_device",
                                  "to_host", "copies", "sync_to_device",
                                  "sync_to_host")}
        for _ in range(BR_ROUNDS + 1):   # the first round warms up
            sync()
            host_bridge.reset_stats()
            t0 = time.perf_counter()
            trainer._allreduce_grads()
            rounds["async"].append(time.perf_counter() - t0)
            st = host_bridge.stats()
            rounds["to_device"].append(st["to_device"]["seconds"])
            rounds["to_host"].append(st["to_host"]["seconds"])
            # the stand-in's own copies (asnumpy, then the write back)
            t0 = time.perf_counter()
            for p in gparams:
                p.grad[:] = p.grad.asnumpy()
            rounds["copies"].append(time.perf_counter() - t0)
            host_bridge.reset_stats()
            t0 = time.perf_counter()
            for i, p in enumerate(gparams):
                hvd_mx.allreduce_(p.grad, average=False, name=str(i))
            rounds["sync"].append(time.perf_counter() - t0)
            st = host_bridge.stats()
            rounds["sync_to_device"].append(st["to_device"]["seconds"])
            rounds["sync_to_host"].append(st["to_host"]["seconds"])
            sync()
            t0 = time.perf_counter()
            hvd.grouped_allreduce(grads, op=hvd.Sum, name="p18.resident")
            sync()
            rounds["resident"].append(time.perf_counter() - t0)
        res["d_ms"] = {k: 1e3 * statistics.median(v[1:])
                       for k, v in rounds.items()}
        res["d_rounds_ms"] = {k: [1e3 * x for x in v]
                              for k, v in rounds.items()}
        res["d_bytes"] = int(sum(g.nbytes for g in g0))
        del gparams, trainer
    return res


def bridge_phase(smi):
    """Phase 18: ``bridge_train`` at ``min(cards, 4)`` ranks through
    ``python -m horovod_tpu_torch.run`` with phase 13's windows (rank
    logs in ``chiprun_out/bridge/<job>/``).  (a)-(b): every rank's host
    parameters bitwise the same and within BR_RTOL of the card's step;
    (c): every rank holds the last rank's tensors bitwise; (d): the
    exchange's milliseconds.  At one card a world of one exchanges
    nothing (the reference's ``_do_allreduce`` returns at size 1): (a)-
    (c) run at two ranks on the CPU at phase 15's small width, started
    first, while this process takes the card's one rank, whose (d) waits
    for them to end, which the phase says.  -> the jobs' results and the
    card's rank 0's launches."""
    _mx_shim()
    print("bridge: MXNet here is the repo's numpy stand-in "
          "tests/_mxnet_shim (this machine has no MXNet, TensorFlow or "
          "Keras); the binding is horovod_tpu_torch.mxnet over "
          "common/host_bridge.py", flush=True)
    world = _world()

    def job(name, ranks, env=None):
        code, text, res, alive = _ft_job(
            name, ranks, "bridge_train", LAYERS, _ft_flags(), env,
            where="bridge")
        if code != 0 or alive or None in res:
            raise AssertionError(f"phase 18 {name}: exit {code}, alive "
                                 f"{alive}:\n{text[-4000:]}")
        return res

    out, wall = {}, {}
    t0 = time.time()
    if world > 1:
        card = exchanged = job("card", world)
        on = f" on {smi}"
        wall["card"] = time.time() - t0
    else:
        import concurrent.futures

        import horovod_tpu_torch as hvd

        print("bridge: one card, and a world of one exchanges nothing: "
              "(a)-(c) run at two ranks on the CPU (gloo) at phase 15's "
              "small width, started first, while this process takes the "
              "card's rank, whose (d) waits for them", flush=True)

        def cpu_job():
            res = job("cpu", 2, {"P13_DEVICE": "cpu"})
            wall["cpu"] = time.time() - t0
            return res

        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            exchanged, on = pool.submit(cpu_job), " on the CPU"
            hvd.init()
            try:
                card = [bridge_rank(LAYERS, False,
                                    before_d=exchanged.exception)]
            finally:
                hvd.shutdown()
            exchanged = exchanged.result()
        wall["card"] = time.time() - t0
    out["card"], out["exchanged"] = card, exchanged

    e0 = exchanged[0]
    for what in ("a", "b"):
        if len({e[f"{what}_digest"] for e in exchanged}) != 1:
            raise AssertionError(f"phase 18 ({what}): the ranks' host "
                                 f"parameters differ")
        print(f"bridge ({what}) {len(exchanged)} ranks{on}: "
              f"{'DistributedOptimizer' if what == 'a' else 'DistributedTrainer'}"
              f" over {e0['tensors']} tensors, {e0['elements']:,} fp32: "
              f"every rank's host parameters bitwise the same, within "
              f"{max(e[f'{what}_err'] for e in exchanged):.3e} of "
              f"hvd.DistributedOptimizer(SGD({BR_LR:g}))'s step ("
              f"{max(e[f'{what}_past_rtol'] for e in exchanged)} elements "
              f"past rtol {BR_RTOL:g} alone); the step "
              f"{1e3 * max(e[f'{what}_s'] for e in exchanged):.1f} ms",
              flush=True)
    root = exchanged[-1]["c_own_digest"]
    if any(e["c_digest"] != root for e in exchanged):
        raise AssertionError("phase 18 (c): a rank does not hold the last "
                             "rank's tensors bitwise")
    print(f"bridge (c) {len(exchanged)} ranks{on}: broadcast_parameters of "
          f"{e0['tensors']} tensors from rank {len(exchanged) - 1}: every "
          f"rank holds its bytes ({1e3 * max(e['c_s'] for e in exchanged):.1f}"
          f" ms)", flush=True)

    for e in card:
        d = e["d_ms"]
        plane = d["async"] - d["to_device"] - d["to_host"]
        print(f"bridge (d) rank {e['rank']} of {e['world']} on {smi}: the "
              f"binding's exchange of {e['tensors']} gradients "
              f"({e['d_bytes'] / 1e6:.1f} MB fp32), median of {BR_ROUNDS} "
              f"in turns: all submitted, then waited for "
              f"{d['async']:.2f} ms = host->card {d['to_device']:.2f} + the "
              f"plane and the stand-in's copies {plane:.2f} + card->host "
              f"{d['to_host']:.2f} (the stand-in's asnumpy and write-back "
              f"alone {d['copies']:.2f}); one tensor at a time "
              f"{d['sync']:.2f} ms (host->card {d['sync_to_device']:.2f}, "
              f"card->host {d['sync_to_host']:.2f}); the plane's "
              f"grouped_allreduce of the gradients on the card "
              f"{d['resident']:.2f} ms", flush=True)
    expect_launches("phase 18 rank 0", card[0]["counts"],
                    per_step_launches(LAYERS), 1)
    print(f"bridge: wall s { {k: round(v, 2) for k, v in wall.items()} }",
          flush=True)
    out["wall_s"] = wall
    out["counts"] = card[0]["counts"]
    return out


RANK_PHASES = {"eager": eager_checks, "zero": zero_checks,
               "sequence": sequence_checks, "model": model_parallel_checks,
               "adasum": adasum_checks, "adasum_hier": adasum_hier_checks,
               "launcher_train": launcher_train,
               "launcher_fail": launcher_fail, "launcher_key": launcher_key,
               "fault_crash": fault_crash, "fault_stall": fault_stall,
               "fault_user": fault_user, "fault_cross": fault_cross,
               "elastic_rank": elastic_rank,
               "timeline_train": timeline_train, "hier_rank": hier_rank,
               "tune_train": tune_train, "session_train": session_train,
               "bridge_train": bridge_train}
# the ranks of these phases make their own hvd.init() and shutdown
LAUNCHER_PHASES = ("launcher_train", "launcher_fail", "launcher_key",
                   "fault_crash", "fault_stall", "fault_user", "fault_cross",
                   "elastic_rank", "timeline_train", "hier_rank",
                   "tune_train", "session_train", "bridge_train")


def _profile_step(model, opt, tokens):
    from horovod_tpu_torch.models import lm_loss

    def step():
        opt.zero_grad(set_to_none=True)
        lm_loss(model(tokens), tokens).backward()
        opt.step()

    return _profile(step, "profile_step.txt")


def _profile(step, filename):
    """Run ``step`` once under ``torch.profiler``; write its device time
    by operator to ``chiprun_out/<filename>``, print the top rows; -> the
    device time in ms."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
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
    with open(os.path.join(_out_dir(), filename), "w") as f:
        f.write(f"device time {total:.3f} ms\n{table}\n")
    print(f"profile: device time {total:.3f} ms in one step ({filename}); "
          f"top kernels:", flush=True)
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}", flush=True)
    return total


def check_cnn_cpu_vs_cuda():
    """Phase 7, first: the CNNs on the card against the same weights on
    the CPU, at narrow sizes.  In fp32 with TF32 off, eval logits of
    ResNet-18 (16 filters, 32x32, batch 8), VGG-16 (32x32, classifier
    64) and Inception V3 (96x96): rtol 1e-4 with an absolute floor of
    1e-5 of the largest entry (convolutions sum in another order).  In
    float64 (its fp32 head too), ResNet-18's training step: logits,
    loss, every gradient and the updated batch statistics, rtol 1e-6
    with a floor of 1e-9 of each tensor's largest entry.  Its gradients
    are not held in fp32: a BatchNorm bias's gradient sums terms that
    cancel, and the two devices' fp32 sums differ by 8.7e-8 there, far
    above such a leaf's share of its entries."""
    import torch

    from horovod_tpu_torch import train_cnn
    from horovod_tpu_torch.models import InceptionV3, ResNet18, VGG16

    def close(what, got, want, rtol, share):
        want = want.double()
        atol = share * max(float(want.abs().max()), 1e-30)
        if not torch.allclose(got.double(), want, rtol=rtol, atol=atol):
            raise AssertionError(f"cnn cuda vs cpu {what}: max abs err "
                                 f"{max_err(got, want):.3e}")

    cases = [
        ("resnet18", lambda dev, dt: ResNet18(
            num_classes=10, num_filters=16, dtype=dt, device=dev, seed=1),
         8, 32),
        ("vgg16", lambda dev, dt: VGG16(
            num_classes=10, dtype=dt, classifier_width=64, image=32,
            device=dev, seed=1), 4, 32),
        ("inception_v3", lambda dev, dt: InceptionV3(
            num_classes=10, dtype=dt, device=dev, seed=1), 2, 96)]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, make, batch, image in cases:
            train = name == "resnet18"
            x, y = train_cnn.synthetic_batch(batch, image, 10, "cpu")
            out = {}
            for dev in ("cpu", "cuda"):
                model = make(dev, torch.float32).eval()
                with torch.no_grad():
                    res = {"eval logits": model(x.to(dev)).cpu()}
                if train:
                    model = make(dev, torch.float64).double().train()
                    model.Dense_0.dtype = torch.float64   # fp32 by design
                    logits = model(x.to(dev, torch.float64))
                    loss = train_cnn.cross_entropy(logits, y.to(dev))
                    loss.backward()
                    res["f64 logits"] = logits.detach().cpu()
                    res["f64 loss"] = loss.detach().cpu()
                    res.update({f"f64 grad {k}": p.grad.cpu()
                                for k, p in model.named_parameters()})
                    res.update({f"f64 buffer {k}": b.cpu()
                                for k, b in model.named_buffers()})
                out[dev] = res
            want, got = out["cpu"], out["cuda"]
            for k in want:
                f64 = k.startswith("f64")
                close(f"{name} {k}", got[k], want[k], 1e-6 if f64 else 1e-4,
                      1e-9 if f64 else 1e-5)
            peak = float(want["eval logits"].abs().max())
            print(f"cnn {name}: card and CPU agree on {len(want)} tensors "
                  f"(eval logits max {peak:.4f})", flush=True)
    finally:   # the later steps run as the caller set them
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32


def cnn_phase(smi, profile=False):
    """Phase 7: :func:`check_cnn_cpu_vs_cuda`, then ResNet-50 training at
    full width and depth as ``bench.py::_bench_resnet`` runs it (1000
    classes, 224x224x3, bf16 compute, fp32 parameters, batch 64, SGD 0.1
    with momentum 0.9 under ``DistributedOptimizer``, batch statistics
    averaged over the ranks) at world size 1: ``CNN_WARMUP`` steps, then
    a window of ``CNN_STEPS`` steps timed as bench.py times it (images/s
    = batch * steps / the window's seconds, no synchronisation inside
    it); the loss must be finite and fall.  Then one training step each
    of VGG-16 at 224 and Inception V3 at 299, full width, batch 16
    (``CNN_SIZES``).  ``torch.backends.cudnn.benchmark``
    is on (cuDNN picks each convolution's algorithm by timing it, as XLA
    autotunes).  -> the numbers."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import train_cnn
    from horovod_tpu_torch.models import InceptionV3, ResNet50, VGG16

    check_cnn_cpu_vs_cuda()
    torch.backends.cudnn.benchmark = True
    hvd.init()
    try:
        dev = hvd.device()
        torch.cuda.reset_peak_memory_stats()
        batch, image = CNN_SIZES["resnet50"]
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
        opt = train_cnn.make_optimizer(model)
        x, y = train_cnn.synthetic_batch(batch, image, 1000, dev)
        warm, _, _ = train_cnn.timed_steps(model, opt, x, y, CNN_WARMUP)
        timed, window_s, gaps = train_cnn.timed_steps(model, opt, x, y,
                                                      CNN_STEPS)
        losses = warm + timed
        profiled_ms = _profile(
            lambda: train_cnn.train_step(model, opt, x, y),
            "profile_resnet50.txt") if profile else None
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_params = sum(p.numel() for p in model.parameters())
        del model, opt, x, y
        others = {}
        for name, make in [
                ("vgg16", lambda image: VGG16(dtype=torch.bfloat16,
                                              image=image, seed=0)),
                ("inception_v3",
                 lambda image: InceptionV3(dtype=torch.bfloat16, seed=0))]:
            other_batch, other_image = CNN_SIZES[name]
            model = make(other_image)
            opt = train_cnn.make_optimizer(model)
            xb, yb = train_cnn.synthetic_batch(other_batch, other_image,
                                               1000, dev)
            loss, secs, _ = train_cnn.timed_steps(model, opt, xb, yb, 1)
            if not all(map(math.isfinite, loss)):
                raise AssertionError(f"{name}: non-finite loss {loss}")
            others[name] = {"loss": loss[0], "step_s": secs,
                            "batch": other_batch, "image": other_image,
                            "params": sum(p.numel()
                                          for p in model.parameters())}
            print(f"cnn {name}: one step at {other_image}x{other_image}, "
                  f"batch {other_batch}, "
                  f"{others[name]['params']} parameters: loss {loss[0]:.4f}"
                  f", {secs * 1e3:.1f} ms (first step, cuDNN choosing "
                  f"its algorithms) on {smi}", flush=True)
            del model, opt, xb, yb
    finally:
        hvd.shutdown()
        torch.backends.cudnn.benchmark = False

    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"resnet50: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"resnet50: the loss did not fall: {losses}")
    step = window_s / CNN_STEPS
    ips = batch * CNN_STEPS / window_s
    print(f"cnn resnet50: {n_params} parameters, batch {batch} x "
          f"{image}x{image}x3 bf16; losses {[round(v, 4) for v in losses]}",
          flush=True)
    print(f"cnn resnet50: ms between step ends on the card "
          f"{[round(g, 3) for g in gaps]}", flush=True)
    print(f"cnn resnet50: {CNN_STEPS} steps after {CNN_WARMUP} in "
          f"{window_s * 1e3:.2f} ms, {step * 1e3:.2f} ms a step, {ips:.1f} "
          f"images/s per GPU (spread between step ends {min(gaps):.3f}-"
          f"{max(gaps):.3f} ms), peak memory {peak:.2f} GiB on {smi}",
          flush=True)
    if profiled_ms is not None:
        print(f"cnn resnet50: device busy {profiled_ms:.3f} ms of a "
              f"{step * 1e3:.3f} ms step", flush=True)
    return {"resnet50": {"losses": losses, "window_s": window_s,
                         "step_gaps_ms": gaps, "images_per_s": ips,
                         "step_ms": step * 1e3,
                         "params": n_params, "peak_gib": peak,
                         "profiled_device_ms": profiled_ms},
            **others}


def _out_dir():
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra training step of phases 5, 7, "
                    "9 and each run of 10")
    ap.add_argument("--rank-of", nargs=2, metavar=("PHASE", "LAYERS"),
                    help=argparse.SUPPRESS)  # one rank of phase 6, 8-12
    ap.add_argument("--spark-task", nargs=2, metavar=("INDEX", "WORLD"),
                    type=int, help=argparse.SUPPRESS)  # phase 15 (c)
    args = ap.parse_args(argv)
    if args.rank_of is not None:
        return _rank_of(args.rank_of[0], int(args.rank_of[1]), args.profile)
    if args.spark_task is not None:
        return _spark_task(*args.spark_task)

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

    def timed(phase, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s wall",
              flush=True)
        return out

    kernels = timed(3, check_kernels)
    timed(4, check_models)
    counts, run = timed(5, train, LAYERS, STEPS, smi, args.profile)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    eager = timed(6, eager_phase, smi, LAYERS)
    cnn = timed(7, cnn_phase, smi, args.profile)
    zero = timed(8, zero_phase, smi)
    sequence = timed(9, sequence_phase, smi, args.profile)
    model = timed(10, model_parallel_phase, smi, args.profile)
    adasum, adasum_hier = timed(11, adasum_phase, smi)
    _release()
    phase5_ms = 1e3 * statistics.median(run["step_s"][1:])
    launcher = timed(12, launcher_phase, smi, phase5_ms,
                     eager[0]["negotiation_ms_median"])
    fault = timed(13, fault_phase, smi, phase5_ms, run["buckets"])
    elastic = timed(14, elastic_phase, smi, run["buckets"])
    cluster = timed(15, cluster_phase, smi, phase5_ms,
                    eager[0]["step_ms_plane_on"])
    _release()
    _card_memory("before phase 16")
    p16 = timed(16, timeline_phase, smi, phase5_ms)
    session = timed(17, session_phase, smi, phase5_ms)
    bridge = timed(18, bridge_phase, smi)
    paths = {"phase10_tp": model[0]["tp_dp2"]["counts"],
             "phase10_moe": model[0]["moe"]["counts"],
             "phase10_pp": model[0]["pipeline"]["counts"],
             "phase11": adasum[0]["training"]["do_adasum"]["counts"],
             "phase12": launcher["ranks"][0]["counts"]}
    if "crash" in fault:
        # phase 13 (a): the steps before the crash, and the crash's own
        paths["phase13"] = fault["crash"]["ranks"][0]["counts"]
    if elastic.get("loss") and elastic["loss"]["ranks"][0]["counts"]:
        # phase 14 (a): a survivor's steps at both epochs
        paths["phase14"] = elastic["loss"]["ranks"][0]["counts"]
    # phase 15 (a), and (b) above one card: the fit's steps and its
    # validation forward (rank 0's, up to its validation loss)
    paths["phase15a"] = cluster["a"]["counts"]
    if cluster["b"]["counts"] is not None:
        paths["phase15b"] = cluster["b"]["counts"]
    # phase 16 (a), and (c) above one card: rank 0's steps
    paths.update(p16.pop("counts"))
    if _world() > 1:
        # phase 17 (a): rank 0's steps across the blip
        paths["phase17"] = session["blip"][0]["counts"]
    # phase 18: the card's rank 0, one forward and backward
    paths["phase18"] = bridge.pop("counts")
    for k in kernels:
        k["launches_by_path"] = {"phase5": k["launches"], **{
            path: c[k["name"]] for path, c in paths.items()}}
        if not all(k["launches_by_path"].values()):
            raise AssertionError(f"{k['name']}: not launched on every "
                                 f"path: {k['launches_by_path']}")

    with open(os.path.join(_out_dir(), "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "kernels": kernels, "train": run,
                   "eager": eager, "cnn": cnn, "zero": zero,
                   "sequence": sequence, "model": model, "adasum": adasum,
                   "adasum_hierarchical": adasum_hier,
                   "launcher": launcher, "fault": fault,
                   "elastic": elastic, "cluster": cluster,
                   "timeline_hier_autotune": p16, "session": session,
                   "bridge": bridge},
                  f, indent=1)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
