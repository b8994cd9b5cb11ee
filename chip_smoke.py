#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases; any failure exits non-zero before the final line:

1. device  — needs CUDA; prints the card's name and power limit.
2. build   — compiles the kernels from mxnet_tpu_torch/csrc with nvcc
             (sm_90a) and prints the build seconds, the ptxas reports, the
             number of tensor-core (HMMA) instructions in the
             flash-attention library (and their share of the D = 64
             kernels' instructions), and the wgmma (HGMMA) and TMA
             (UTMALDG, UTMASTG) instructions of the conv1x1 library; no
             HMMA, HGMMA or UTMALDG fails.
3. kernels — holds each kernel against its plain PyTorch version on the
             card, in fp32 and bf16, at the shapes the GPT and ResNet-50
             paths give it (flash attention at every prefill bucket of
             the serve phase, on strided views, and once without the
             causal mask and once at batch 8 to see what holds it back;
             the momentum update over ResNet-50's whole parameter list,
             once through the one-off function and over 3 steps of an
             update plan with fresh gradients; the 1x1 convolution at
             each of a ResNet-50 forward's 15 shapes with the weight as
             the train path passes it, on its unaligned fallback path in
             both weight layouts, with a check that the profiler saw the
             path's own kernel, and that two calls give identical bits),
             and times the kernel, the plain version and one PyTorch
             library call (by CUDA events, the kernel and the library
             call in turns, and by the profiler's device time), beside
             the least time the card could take for the math the kernel
             runs; for the update, where a call's host time goes.
4. small   — a narrow GPT on the card (through the kernels) against the
             same GPT on the CPU (plain versions): logits and greedy
             tokens.
5. serve   — GPT-2-small width (124M parameters, seeded random weights)
             served in fp32 through DecodeEngine(max_slots=8) and
             ContinuousBatchScheduler: 8 prompts, 32 new tokens each.
             The tokens must equal those of the same prompts submitted
             one at a time to a second engine of the same shapes, and the
             launch counters must show that every prefill attention ran
             on flash_attention and every LayerNorm on layer_norm.
6. train_small — a narrow NHWC ResNetV1 (BottleneckV1, [1, 1],
             [16, 32, 64], 10 classes) trains 3 fp32 steps through
             ShardedTrainer on the card (its CUDA-graph step, through the
             kernels) and on the CPU (plain versions) from the same
             seeded weights: per-step losses and final parameters must
             agree.
7. train   — ResNet-50 v1 at full width, NHWC, batch 128 at 224x224,
             bf16 compute over fp32 master parameters, SGD momentum 0.9
             through ShardedTrainer.step_many, as bench.py's _train_tput
             sets it up, on its CUDA-graph step and on the eager step
             (MXTPU_CUDA_GRAPH=0) from the same weights: the first window
             of 10 steps of each must leave bit-identical losses, weights,
             momenta and BatchNorm statistics (cuDNN deterministic); then
             a timed window of each. Losses finite and falling, no step
             skipped, exactly 36 conv1x1_bn_stats and 1 fused_sgd_momentum
             launches and 1 train.step.dispatches per step, every conv1x1
             of a profiled step on the wgmma kernel; for each mode img/s,
             step ms, the host's enqueue against the device ms of one
             step, the busy share, peak memory, MFU and a torch.profiler
             breakdown.
7b. sharded_api — ShardedTrainer's API on the card, each case on the
             graph step against the eager step from the same seeded
             weights (the narrow ResNetV1, b16 at 32 px, fp32): Adam,
             remat (full and dots_with_no_batch_dims_saveable),
             aux_mode="predict" and fit over an NDArrayIter through
             prefetched, 3 steps each, within 1e-5; and a Dropout MLP
             whose graph replays draw new masks (the mean loss within 5
             standard errors of the eager steps'), and a NaN in the
             batch of a graph step (SGD and Adam) leaves every tensor
             bit-identical and counts one skipped step. A failed capture
             fails the phase.
8. gluon_small — the same narrow NHWC ResNetV1 trains 3 fp32 steps
             through the Gluon loop (autograd.record, backward,
             gluon.Trainer.step; SGD momentum 0.9, wd 1e-4, lr 0.1 halved
             every step by a FactorScheduler) on the card and on the CPU
             from the same seeded weights: losses, parameters and running
             statistics must agree.
9. gluon_train — ResNet-50 v1, NHWC, batch 128 at 224x224,
             net.cast("bfloat16"), SGD momentum 0.9, wd 1e-4, lr 0.1 with
             multi_precision and FactorScheduler(step=5, factor=0.5),
             kvstore "device": MXNet's mixed-precision recipe through the
             Gluon loop. 2 warm-up steps, then 10 timed, fenced by reading
             the losses back. Losses finite and falling, no step skipped,
             36 conv1x1_bn_stats launches a step (all wgmma in the
             profiled step), fused_sgd_momentum launches equal to the SGD
             groups the FusedUpdater formed, and a record()-free net(x)
             after training that leaves the running statistics
             bit-identical; img/s, step ms and a one-step profile.

10. nd_sweep — every operator of the registry (mx.nd) on the card
             against the same operator on the CPU, from the case table of
             tools/torch_op_cases.py: outputs, aux write-backs and the
             gradients of one record() -> backward; random operators by
             the mean and variance of their draws. Counts the operators
             run and passed.
11. nd_flash — nd.contrib.flash_attention under record() with a backward
             at (8, 12, 1024, 64) causal, fp32 and bf16: one kernel launch
             a call, the output and the gradients against attention_plain,
             and the times of the forward and of forward + backward
             beside the plain version and SDPA.
12. nd_save — arrays of five dtypes written by nd.save from the card and
             read by nd.load on the CPU, bit for bit.
13. nd_gpt — GPT-2-small trained through mx.nd: GPTDecoder.hybrid_forward
             on registry operators under record(), a cross entropy of
             nd.log_softmax and nd.pick, backward, and nd.sgd_mom_update
             of each of the 148 weights in place; batch 8 x 1024, fp32,
             seeded weights and tokens. A narrow twin (2 layers, width
             64) first runs 3 steps on the card and the CPU (losses and
             weights within 1e-4). Exactly 25 layer_norm and 148
             fused_sgd_momentum launches a step and no flash_attention,
             finite losses; step ms, host against device ms, tokens/s,
             peak memory, device ms by kernel class, the host cost of one
             invoke, the kernels at these call sites, and backward's host
             ms with a ResNet-50's parameters alive as well.

14. gluon_cifar — example/gluon/train_cifar10.py as published, through
             its port copy tools/torch_train_cifar10.py (imports
             swapped): resnet18_v1, NCHW fp32, SGD lr 0.1 momentum 0.9
             wd 1e-4, batch 128, 2 epochs over 2048 synthetic images (32
             steps). The script's own assert, one fused_sgd_momentum
             launch a step in MXNet's form, and a shuffled DataLoader's
             batches at 2 workers equal to those at 0 under one seed;
             img/s, step ms, peak memory.
15. zoo_train — get_model("mobilenet1.0", layout="NHWC") at 224x224,
             batch 128, net.cast("bfloat16"), multi_precision SGD (the
             gluon_train recipe), batches from a seeded ArrayDataset
             through DataLoader(num_workers=4, pin_memory=True): 1 warm
             and 10 timed steps, finite falling losses, 13
             conv1x1_bn_stats launches a forward and one SGD launch a
             step; a narrow twin (mobilenet0.25, 64 px, batch 4, fp32, 2
             steps) card against CPU; the kernel held against its plain
             version and timed at MobileNet's 13 pointwise calls; img/s,
             step ms, host against device ms, device ms by class.
16. gluon_layers — every gluon.nn class of the port (both layouts
             where they exist) and every loss, forward and backward,
             card against CPU; gluon.nn.LayerNorm at (8192, 768) fp32,
             one layer_norm launch a forward, held against the plain
             version and timed; one forward of each zoo family's
             smallest member (Inception V3 at 299 px), card against CPU.

17. module_small — a narrow NHWC ResNet V1 symbol
             (tools/torch_resnet_symbol.py, units [1, 1], widths [16, 32,
             64]) through Module.fit, b8 at 32 px, fp32, 3 SGD steps, on
             the card and on the CPU from the same seeded parameters:
             per-step losses (1e-4), parameters and aux states (1e-3); 6
             conv1x1_bn_stats launches a step and one fused_sgd_momentum
             launch per SGD group.
18. module_train — resnet50_v1(classes=1000, layout="NHWC") traced to a
             Symbol plus SoftmaxOutput, trained through Module.fit at b128
             and 224 px in fp32 (TF32 off), SGD lr 0.1 momentum 0.9 wd
             1e-4, over a seeded synthetic NDArrayIter: 2 warm and 10
             timed steps, finite losses, exactly 36 conv1x1_bn_stats and 1
             fused_sgd_momentum launches a step; img/s, step ms, peak
             memory and a profile of one step (host against device ms,
             device ms by kind); then, after the counts are read, the
             step with the executor's conv1x1+BN rewrite against the
             same graph unfused, in turns: host and device ms of each.
19. hybrid_train — gluon_train's net and recipe, eager against
             hybridized (the CachedOp) from the same weights: equal
             first-step losses, then interleaved windows of steps; the
             step ms of both.
20. sym_score — bench.py's b32 scoring pass through the port's graph
             function: the ResNet-50 predict graph at b32 in bf16 (weights
             of 2 or more dims bf16, the rest fp32): img/s, and device ms
             against the call's ms (the busy share); in fp32 the
             graph equals the eager net (1e-5), and export then
             SymbolBlock.imports is bit-identical.
21. mnist   — tools/torch_train_mnist.py (the port's copy of
             example/image_classification/train_mnist.py), 10 epochs, on
             the card: its own accuracy assert, one fused_sgd_momentum
             launch per SGD group.
22. gluon_layers_hybridized — the gluon_layers cases that are
             HybridBlocks, hybridized, card against CPU (1e-4), and a user
             HybridBlock calling F.contrib.flash_attention: LayerNorm and
             flash attention launch their kernels inside the graphs.

23. dist_small — tools/torch_launch.py -n 2 starts tests/torch_dist_worker.py
             --device cuda on the one card, over gloo (MXTPU_DIST_BACKEND,
             CUDA tensors staged through the host; NCCL refuses two ranks
             on one device): each rank checks the distributed store's
             exact sums, then trains a narrow NHWC ResNet V1 (b8 at 32 px,
             fp32, 3 fused then 3 staged steps), an MLP (also 2-bit
             compressed) and Module.fit(kvstore="dist_sync"). Gates: the
             ranks' weights bit-identical, fused equal to staged, the
             ResNet within 1e-5 of a one-process card oracle that sums the
             ranks' gradients in rank order, the compressed MLP equal to
             its exact oracle, 6 conv1x1_bn_stats launches a forward and
             one fused_sgd_momentum launch a step.
24. dist_train — gluon_train's net and recipe through
             gluon.Trainer(kvstore="dist_device_sync") after
             init_distributed() at world size 1 over NCCL (no collective
             runs at one process): from one saved state 10 fused steps,
             then 10 staged (MXTPU_FUSED_STEP=0), with cuDNN's
             deterministic algorithms; their weights and optimizer states
             must be bit-identical. For each: img/s, step ms, a profiled
             step (host against device ms, busy share, device ms by kind),
             the host's ms to enqueue trainer.step, peak memory, and
             conv1x1_bn_stats, fused_sgd_momentum and
             train.step.dispatches a step; beside gluon_train's img/s.
25. dist_sharded, 26. dist_sharded_small — ShardedTrainer across
             processes (their functions say what they hold).

27. record_train — train_imagenet.py's composition at full width: 1536
             seeded synthetic 500x375 images in a .rec (JPEG q90 through
             PIL, else NPY records) -> mx.io.ImageRecordIter (224 px
             random crops and mirrors, b128, NHWC, shuffled,
             preprocess_threads=8, round_batch=False; the native record
             reader built from src/ under its file lock) ->
             ShardedTrainer.prefetched -> ShardedTrainer.step on its CUDA
             graph (train's ResNet-50 bf16 recipe). The reader and the
             decoder, the host's CPU count, the loader alone and end to
             end in img/s beside train's, io.batch_wait.seconds a step,
             the busy share and io.record.queue_depth at each pull. Gates:
             every record once an epoch (by the ids in its label and its
             corner blocks), finite losses, 360 conv1x1_wgmma_kernel and
             10 sgd_momentum_kernel launches over 10 profiled replays, and
             the native reader wherever the native library builds.
28. record_module — Module.fit (its prefetch loop) over an
             ImageRecordIter: the narrow NHWC ResNet V1 symbol at 32 px,
             b16, fp32, 2 epochs: finite losses, the second epoch's below
             the first's, 6 conv1x1_bn_stats launches a step (the
             executor's rewrite, conv1x1_simt_kernel) and one
             fused_sgd_momentum launch a SGD group.

29. planes — the training planes, right after model_server. (a) At full
             width, gluon_train's recipe (ResNet-50 v1, NHWC, b128 at 224
             px, bf16 over fp32 masters, multi-precision SGD through
             gluon.Trainer) under MXTPU_TELEMETRY, cuDNN deterministic: 2
             warm-up steps, saved; then from that state 10 steps with the
             numerics guard on, twice, and 10 with a trainer made under
             MXTPU_NUMERICS=0. Gates: losses,
             weights, momenta and BatchNorm statistics of the three
             windows bit-identical; one source "gluon.trainer" record a
             step in the JAX package's schema (numerics_time when the
             guard is on, step_dispatches 1), read by
             tools/telemetry_report.py and tools/perf_gate.py
             --max-skipped-steps 0 --max-dispatches-per-step 1 as
             subprocesses (rc 0); 36 conv1x1_bn_stats and 1
             fused_sgd_momentum launches a step. Then, loss-scaled
             (trainer.scale_loss) with MXTPU_CHAOS="grad.post:kind=nan,
             after=3,n=1": step 3 leaves weights and momenta bit-identical
             while steps 2 and 4 update (the running statistics move with
             the clean forward, as in the JAX package), the loss scale
             halves, that step's record carries skipped_steps 1, one
             numerics_skip event, and perf_gate --max-skipped-steps 0
             now exits 1. mx.profiler over 2 steps: its chrome trace holds
             conv1x1_wgmma_kernel and sgd_momentum_kernel events and the
             step/step and step/numerics spans. img/s with the guard on
             and off, and the numerics phase's host ms. (b) The recovery
             drills on train_small's net (fp32, b8 at 32 px, 6 steps,
             tests/torch_gang_worker.py, a checkpoint a step), all started
             together: a child that SIGTERMs itself after step 3 saves at
             the next boundary and exits 75, and its relaunch ends
             bit-identical to an uninterrupted child; a 2-rank gloo gang
             under tools/torch_launch.py --supervise whose rank 1
             MXTPU_CHAOS_RANK_1 kills mid-run: the survivor raises
             PeerLost (76) well inside the collective's 60 s budget, one
             restart, rank chaos stripped, bit-identical to an
             uninterrupted gang; and MXTPU_DIVERGE_PATIENCE=2 NaN steps
             roll the checkpoints back (exit 77) and the relaunch ends
             bit-identical. Bit-identical: the trained weights and
             momenta of every rank, and rank 0's BatchNorm statistics
             (each rank keeps its own batch's; the checkpoint holds rank
             0's). The seconds of each, and of the phase.

The kernel phase also times conv1x1_bn_stats in fp32 at ResNet-50's 15
shapes as module_train calls it (the CUDA-core kernel), and in bf16 at
MobileNet-1.0's 9 pointwise shapes as zoo_train calls it, beside its
bound and matmul + var_mean.

The kernel phase also holds the SGD kernel's MXNet form (the update of
Gluon's SGD) against its plain version over ResNet-50's tensor list, in
fp32 and in multi-precision bf16 with clipping, over 3 calls with a new
lr each, beside fused torch.optim.SGD on fp32 tensors of the same shapes.

It ends with a JSON line of the kernels, the card's nvidia-smi line, and
``{"ok": true, "device": {...}}``. Float32 matrix products run in full
fp32: TF32 is switched off for matmuls and cuDNN.
"""
import faulthandler
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12          # CUDA-core fp32, no tensor cores
TF32_FLOP_S = 494.7e12       # dense TF32 tensor cores
BF16_FLOP_S = 989e12         # dense bf16 tensor cores
PEAKS = ("HBM 3.35 TB/s, fp32 67 TFLOP/s, TF32 494.7 TFLOP/s, bf16 989 "
         "TFLOP/s (H100 SXM)")

GPT2_SMALL = dict(vocab_size=50257, max_seq_len=1024, num_layers=12,
                  num_heads=12, embed_dim=768, mlp_ratio=4)
PROMPT_LENS = (17, 64, 130, 255, 300, 511, 700, 990)
# the prefill lengths the serve phase launches flash attention at (its
# power-of-two buckets, serving/engine.py), and a ragged one
FLASH_T = (32, 64, 256, 512, 1000, 1024)
NEW_TOKENS = 32
SLOTS = 8
TOL = {("flash_attention", torch.float32): 1e-4,
       ("flash_attention", torch.bfloat16): 2e-2,
       ("layer_norm", torch.float32): 1e-4,
       ("layer_norm", torch.bfloat16): 2e-2,
       # w and m after one update; bf16 w: as tests/test_pallas.py:82-98
       ("fused_sgd_momentum", torch.float32): 1e-5,
       ("fused_sgd_momentum", torch.bfloat16): 2e-2,
       # MXNet's form: each product and sum rounded on its own on both
       # sides (fp32: the same bits but for the device's last place),
       # relative to max(1, |w|); the bf16 weight of multi-precision must
       # be the plain master's bf16 rounding, bit for bit
       ("sgd_mxnet", torch.float32): 1e-6,
       # y (in units of max|y| for bf16: one bf16 ulp), mean, var; the
       # statistics are fp32 sums in another order on both sides
       ("conv1x1_bn_stats", torch.float32): (1e-4, 1e-5, 1e-4),
       ("conv1x1_bn_stats", torch.bfloat16): (2 ** -7, 1e-4, 1e-3)}
SGD_HP = dict(lr=0.1, momentum=0.9, wd=1e-4)
# ResNet-50's 1x1 convolutions at batch 128 (M, Cin, Cout), and a ragged M
CONV1X1_SHAPES = [(401408, 64, 256), (401408, 256, 64), (100352, 512, 128),
                  (6272, 2048, 512), (300, 64, 256)]
BATCH, IMG, TRAIN_STEPS = 128, 224, 10
GLUON_WARM = 2
# the update of Gluon's SGD in the kernel phase (lr changes every call;
# rescale is 1 / batch, as Trainer.step(128) sets it)
SGD_MXNET = dict(momentum=0.9, wd=1e-4, rescale=1.0 / 128)
SGD_MXNET_LRS = (0.1, 0.05, 0.025)
FLOPS_PER_IMG = 3 * 4.089e9     # fwd + bwd, as bench.py:784 counts them


def emit(**rec):
    print(json.dumps(rec), flush=True)


def fail(msg):
    print("chip_smoke: FAIL: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def guard_counts():
    """The numerics guard's counters now (the trainers read their
    verdicts at every step boundary, so a window's guard is the counters'
    difference across it)."""
    from mxnet_tpu_torch.resilience import numerics
    return numerics.SKIPPED.total(), numerics.ANOMALIES.total()


def guard_since(before):
    skipped, anomalies = guard_counts()
    return {"skipped_steps": skipped - before[0],
            "anomalies": anomalies - before[1]}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=30, warmup=3):
    """Mean milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(fn, other, iters=30, rounds=5):
    """cuda_ms of fn() and of other(), taken in turns (fn, other, other,
    fn, ...) so that the host's noise falls on both; the median round of
    each."""
    a, b = [], []
    for i in range(rounds):
        for f, out in ((fn, a), (other, b))[::1 if i % 2 == 0 else -1]:
            out.append(cuda_ms(f, iters))
    return float(np.median(a)), float(np.median(b))


def kernel_of(mangled):
    """'name<args>' of an Itanium-mangled kernel symbol: the
    length-prefixed name in it that ends in _kernel, then its template
    arguments (e.g. IfLi64E -> <fp32,64>), if any."""
    i = 3 if mangled.startswith("_ZN") else 2
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
        if not name.endswith("_kernel"):
            continue
        rest = mangled[i:]
        if not rest.startswith("I"):
            return name
        args = re.sub(r"Li(\d+)E?", r"\1,", rest[1:rest.find("EEv")])
        args = args.replace("13__nv_bfloat16", "bf16,")
        if args.startswith("f"):
            args = "fp32," + args[1:]
        return "%s<%s>" % (name, args.strip(","))
    return mangled


def sass_mix(sass, which):
    """{kernel: {"instructions": n, "hmma": n}} of the kernels in a
    cuobjdump --dump-sass listing whose names contain `which`: the
    static share of tensor-core instructions in each."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_of(m.group(1))
            name = name if which in name else None
            if name:
                out[name] = {"instructions": 0, "hmma": 0}
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            out[name]["instructions"] += 1
            out[name]["hmma"] += "HMMA" in line
    return out


def print_ptxas(log):
    """One line per compiled kernel from nvcc's -Xptxas -v report:
    template arguments, registers, shared memory, spills."""
    kernel = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+?)'", line)
        if m:
            kernel = kernel_of(m.group(1))
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and kernel:
            print("ptxas %s: %s; %s" % (kernel, line.split(":", 1)[1].strip(),
                                        spills), flush=True)
            kernel = None


def percentile(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q))


def warm_profile(fn, n, activities):
    """torch.profiler over n runs of fn(), after a warm-up step in which
    the tracer is on, sees one small launch and keeps nothing: without
    it the tracer can miss the first launch of its window."""
    from torch.profiler import profile, schedule
    torch.cuda.synchronize()
    with profile(activities=activities, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return prof


def on_device(e):
    """A profiler event of device time that a kernel or copy took (not
    the schedule's ProfilerStep range, which spans its whole step)."""
    from torch.autograd import DeviceType
    return (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep"))


def device_events(fn, n):
    """Run fn() n times under torch.profiler (device activity only);
    returns {kernel or copy name: (device microseconds, launches)} over
    the n runs. Empty when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity
    prof = warm_profile(fn, n, [ProfilerActivity.CUDA])
    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages() if on_device(e)}


def kernels_seen(fn, part, expect, n=3, tries=10):
    """Names of the kernels containing `part` that the profiler saw over
    n calls of fn(). The profiler can drop the record of a launch, so
    while no name contains `expect` it profiles again, up to `tries`
    times, and returns every name it saw."""
    seen = set()
    for _ in range(tries):
        seen |= {k for k in device_events(fn, n) if part in k}
        if any(expect in k for k in seen):
            break
        print("chip_smoke: the profiler saw %s of %d calls, no %s"
              % (sorted(seen), n, expect), file=sys.stderr, flush=True)
    return sorted(seen)


def profiled(fn, n):
    """{kernel or copy name: device microseconds over n runs of fn()}."""
    return {k: us for k, (us, _) in device_events(fn, n).items()}


def kernel_device_ms(fn, kernel, n=10, launches=1, tries=10):
    """Device milliseconds per call of fn() in the kernels whose names
    contain `kernel` (a string or a tuple of strings), each call making
    `launches` launches of them. The profiler can drop records of a
    large launch, so a count short of n * launches is measured again, up
    to `tries` times; None when it never comes out whole."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    for _ in range(tries):
        seen = [v for k, v in device_events(fn, n).items()
                if any(name in k for name in names)]
        if sum(c for _, c in seen) == n * launches:
            return sum(us for us, _ in seen) / n / 1e3
        print("chip_smoke: the profiler saw %d of %d launches of %s"
              % (sum(c for _, c in seen), n * launches, names),
              file=sys.stderr, flush=True)
    return None


# the device names of each wrapper's kernels (one launch a wrapper call)
KERNEL_NAMES = {"flash_attention": ("flash_fwd_kernel",),
                "layer_norm": ("layer_norm_kernel",),
                "fused_sgd_momentum": ("sgd_momentum_kernel",),
                "conv1x1_bn_stats": ("conv1x1_wgmma_kernel",
                                     "conv1x1_wmma_kernel",
                                     "conv1x1_simt_kernel")}


def device_launches(fn, n, expect, tries=10):
    """{kernel: launches the profiler saw over n calls of fn()}, by the
    names of KERNEL_NAMES. A CUDA graph's replay calls no wrapper, so
    this is how its launches are counted. The profiler can drop records,
    so while a count is short of `expect` ({kernel: launches over the n
    calls}) it profiles again, up to `tries` times; returns the last
    counts."""
    for _ in range(tries):
        events = device_events(fn, n)
        seen = {k: sum(c for name, (_, c) in events.items()
                       if any(part in name for part in parts))
                for k, parts in KERNEL_NAMES.items()}
        if all(seen[k] >= v for k, v in expect.items()):
            return seen
        print("chip_smoke: the profiler saw %s over %d calls, want %s"
              % (seen, n, expect), file=sys.stderr, flush=True)
    return seen


_KINDS = (("conv1x1_bn_stats", ("conv1x1_", "bn_stats_finalize")),
          ("fused_sgd_momentum", ("sgd_momentum_kernel",)),
          ("GEMM / convolution (cuBLAS, cuDNN)",
           ("gemm", "xmma", "cutlass", "conv", "wgrad", "dgrad", "sm90_",
            "sm80_", "cudnn")),
          ("copies and casts", ("copy",)),
          ("reductions", ("reduce",)),
          ("elementwise", ("elementwise", "pool", "Memset")))


def by_kind(dev_us, n, kinds=_KINDS):
    """Device milliseconds per call of the profiled items, summed into
    the classes of `kinds` (first match wins) and "other"."""
    out = {}
    for name, us in dev_us.items():
        kind = next((k for k, keys in kinds
                     if any(key in name for key in keys)), "other")
        out[kind] = out.get(kind, 0.0) + us / n / 1e3
    return out


def breakdown(dev_us, n, host_ms, top_n=6):
    """Where n calls' device time went, against their host wall time."""
    device_ms = sum(dev_us.values()) / n / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:top_n]
    return dict(host_ms=host_ms, device_ms=device_ms or None,
                device_busy_share=device_ms / host_ms if device_ms else None,
                top_device_ms=[[k[:90], t / n / 1e3] for k, t in top])


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def device_ms(fn, n=10, tries=10):
    """Device milliseconds per call of fn(), every kernel and copy it
    runs (a library call's yardstick). The profiler can drop records, so
    a profile counts only when its launches are a whole number per call
    and another profile saw as many; None when no two agree."""
    counts = set()
    for _ in range(tries):
        events = device_events(fn, n).values()
        count = sum(c for _, c in events)
        if count and count % n == 0:
            if count in counts:
                return sum(us for us, _ in events) / n / 1e3
            counts.add(count)
        print("chip_smoke: the profiler saw %d launches over %d calls"
              % (count, n), file=sys.stderr, flush=True)
    return None


def check_flash(ops, dev, T, dtype, gen, strided=False, causal=True,
                batch=1):
    """flash_attention at (batch, 12, T, 64) against attention_plain,
    causal as the serve phase calls it. Two diagnostic rows leave the
    serve phase's shape: `causal=False` (twice the work on an even grid)
    and batch 8 (a grid that fills the card several times over).
    `strided` takes q, k, v as transpose(1, 2) views of a fused
    (1, T, 3, 12, 64) projection and writes through out= into a
    (1, T, 12, 64) buffer, as the GPT prefill calls it."""
    import torch.nn.functional as F
    shape = (batch, 12, T, 64)
    if strided:
        qkv = torch.randn((1, T, 3, 12, 64), generator=gen, device=dev) \
            .to(dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        dst = torch.empty((1, T, 12, 64), device=dev,
                          dtype=dtype).transpose(1, 2)
    else:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        dst = None
    kernel = lambda: ops.flash_attention(  # noqa: E731
        q, k, v, causal, out=dst)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=causal)
    out = kernel()
    torch.cuda.synchronize()
    ref = ops.attention_plain(q, k, v, causal=causal)
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[("flash_attention", dtype)]
    if not np.isfinite(err) or err > tol:
        fail("flash_attention %s %s%s%s: max abs err %g > %g"
             % (shape, dtype, " strided" if strided else "",
                "" if causal else " full", err, tol))
    elem = q.element_size()
    B, H, _, D = shape
    nbytes = 4 * B * H * T * D * elem
    # q.k and p.v over the pairs j <= i when causal, all pairs when not
    flops = (2 * B * H * T * (T + 1) * D if causal
             else 4 * B * H * T * T * D)
    # the math the kernel runs: bf16 tensor cores, or fp32 as 3xTF32
    if dtype == torch.float32:
        work, peak = 3 * flops, TF32_FLOP_S
    else:
        work, peak = flops, BF16_FLOP_S
    kernel_ms, library_ms = paired_ms(kernel, library)
    row = dict(
        name="flash_attention", shape=list(shape), dtype=str(dtype),
        causal=causal, strided=strided, max_abs_err=err, tol=tol,
        kernel_ms=kernel_ms, plain_ms=cuda_ms(
            lambda: ops.attention_plain(q, k, v, causal)),
        library_ms=library_ms,
        device_ms=kernel_device_ms(kernel, "flash_fwd_kernel"),
        library_device_ms=device_ms(library),
        bytes=nbytes, flops=flops, peak_flop_s=peak,
        **bound(nbytes, work, peak))
    if dtype == torch.float32:
        # the earlier yardstick: the same operations on the CUDA cores
        row["bound_cuda_cores_us"] = bound(nbytes, flops,
                                           FP32_FLOP_S)["bound_us"]
    return row


def check_layer_norm(ops, dev, rows, dtype, gen):
    import torch.nn.functional as F
    D = 768
    x = (torch.randn(rows, D, generator=gen, device=dev) * 3 + 1).to(dtype)
    g = (torch.rand(D, generator=gen, device=dev) + 0.5).to(dtype)
    b = torch.randn(D, generator=gen, device=dev).to(dtype)
    out = ops.layer_norm(x, g, b, 1e-5)
    torch.cuda.synchronize()
    ref = ops.layer_norm_plain(x, g, b, 1e-5)
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[("layer_norm", dtype)]
    if not np.isfinite(err) or err > tol:
        fail("layer_norm (%d, %d) %s: max abs err %g > %g"
             % (rows, D, dtype, err, tol))
    elem = x.element_size()
    nbytes = (2 * rows * D + 2 * D) * elem
    flops = 8 * rows * D        # sum, centre, square, scale, affine
    kernel = lambda: ops.layer_norm(x, g, b, 1e-5)  # noqa: E731
    library = lambda: F.layer_norm(x, (D,), g, b, 1e-5)  # noqa: E731
    # microsecond calls whose events time is mostly the host's: more
    # iterations, in turns with the library call
    kernel_ms, library_ms = paired_ms(kernel, library, iters=200)
    return dict(
        name="layer_norm", shape=[rows, D], dtype=str(dtype),
        max_abs_err=err, tol=tol, kernel_ms=kernel_ms,
        plain_ms=cuda_ms(lambda: ops.layer_norm_plain(x, g, b, 1e-5)),
        library_ms=library_ms,
        device_ms=kernel_device_ms(kernel, "layer_norm_kernel"),
        library_device_ms=device_ms(library),
        bytes=nbytes, flops=flops, peak_flop_s=FP32_FLOP_S,
        **bound(nbytes, flops, FP32_FLOP_S))


def check_sgd(ops, dev, shapes, wdtype, gen):
    """fused_sgd_momentum over every tensor of `shapes` (w, g in `wdtype`,
    m fp32) against sgd_momentum_plain per tensor: once through the
    one-off function, then through an SGDMomentumPlan over 3 steps with
    fresh gradient tensors each step, as ShardedTrainer runs it. The plan
    call is what is timed, in turns with PyTorch's fused SGD (fp32)."""
    ws = [(torch.randn(s, generator=gen, device=dev) * 0.05).to(wdtype)
          for s in shapes]
    ms = [torch.randn(s, generator=gen, device=dev) * 0.01 for s in shapes]
    tol = TOL[("fused_sgd_momentum", wdtype)]

    def grads():
        return [(torch.randn(s, generator=gen, device=dev) * 0.01)
                .to(wdtype) for s in shapes]

    def err_of(want):
        return max(max((w.float() - a.float()).abs().max().item(),
                       (m - b).abs().max().item())
                   for w, m, (a, b) in zip(ws, ms, want))

    errs = []
    gs = grads()
    want = [ops.sgd_momentum_plain(w, g, m, **SGD_HP)
            for w, g, m in zip(ws, gs, ms)]
    ops.fused_sgd_momentum(ws, gs, ms, **SGD_HP)
    torch.cuda.synchronize()
    errs.append(err_of(want))
    plan = ops.SGDMomentumPlan(ws, ms)
    for _ in range(3):
        gs = grads()
        want = [ops.sgd_momentum_plain(w, g, m, **SGD_HP)
                for w, g, m in zip(ws, gs, ms)]
        plan(gs, **SGD_HP)
        torch.cuda.synchronize()
        errs.append(err_of(want))
    if not np.isfinite(errs).all() or max(errs) > tol:
        fail("fused_sgd_momentum %d tensors, w %s: max abs err %s (one-off, "
             "then 3 plan steps) > %g" % (len(shapes), wdtype, errs, tol))
    n = sum(w.numel() for w in ws)
    welem = ws[0].element_size()
    nbytes = n * (3 * welem + 2 * 4)       # w, g, m read; w, m written
    flops = 7 * n
    kernel = lambda: plan(gs, **SGD_HP)  # noqa: E731
    row = dict(
        name="fused_sgd_momentum", shape=[len(shapes), n], dtype=str(wdtype),
        max_abs_err=max(errs), errs_one_off_then_plan_steps=errs, tol=tol,
        plain_ms=cuda_ms(lambda: [ops.sgd_momentum_plain(w, g, m, **SGD_HP)
                                  for w, g, m in zip(ws, gs, ms)]),
        one_off_ms=cuda_ms(lambda: ops.fused_sgd_momentum(ws, gs, ms,
                                                          **SGD_HP)),
        device_ms=kernel_device_ms(kernel, "MomentumForm"),
        library_ms=None, library_device_ms=None,
        bytes=nbytes, flops=flops, peak_flop_s=FP32_FLOP_S,
        **bound(nbytes, flops, FP32_FLOP_S))
    if wdtype == torch.float32:
        # the same update by PyTorch's fused SGD (its momentum buffers
        # start from the first step's gradient; the time is what counts)
        params = [torch.nn.Parameter(w.clone()) for w in ws]
        for p, g in zip(params, gs):
            p.grad = g
        opt = torch.optim.SGD(params, lr=SGD_HP["lr"],
                              momentum=SGD_HP["momentum"], dampening=0,
                              weight_decay=SGD_HP["wd"], fused=True)
        row["kernel_ms"], row["library_ms"] = paired_ms(kernel, opt.step)
        row["library_device_ms"] = device_ms(opt.step)
        row["host_us"] = sgd_host_breakdown(ops, plan, ws, gs, ms)
    else:
        row["kernel_ms"] = cuda_ms(kernel)
    return row


def sgd_host_breakdown(ops, plan, ws, gs, ms, n=50):
    """Host microseconds of the pieces of one update call, each alone in a
    loop of n (the clock stops before the closing synchronise, so launches
    count as their enqueue): what a call that sets everything up anew pays
    (the one-off function: validate the three lists, build and upload the
    table, launch) against the plan's per-step call (check the gradients,
    fill the pointer array, launch)."""
    from mxnet_tpu_torch.ops import sgd_momentum as mod

    def us(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        return dt / n * 1e6

    shapes = [w.shape for w in ws]
    return dict(
        one_off_call=us(lambda: ops.fused_sgd_momentum(ws, gs, ms,
                                                       **SGD_HP)),
        validate_w_m=us(lambda: mod._check_state(ws, ms)),
        validate_g=us(lambda: mod._check_grads(gs, shapes, ws[0].dtype,
                                               ws[0].device)),
        build_and_upload_table=us(lambda: ops.SGDMomentumPlan(ws, ms)),
        plan_call=us(lambda: plan(gs, **SGD_HP)))


def check_sgd_mxnet(ops, dev, shapes, mp, gen):
    """The kernel's MXNet form over every tensor of `shapes` through an
    SGDMomentumPlan, against sgd_mxnet_plain per tensor, over 3 calls
    with a new lr each: fp32 (w, g, v fp32), or multi-precision (bf16
    weights and gradients, fp32 masters and velocities, clipping set).
    Timed by events, in turns with fused torch.optim.SGD over fp32
    tensors of the same shapes (the same 20 bytes an element), and by
    the profiler."""
    low = torch.bfloat16 if mp else torch.float32
    clip = 0.02 if mp else None
    weights = [(torch.randn(s, generator=gen, device=dev) * 0.05).to(low)
               for s in shapes]
    ws = [w.float() for w in weights] if mp else weights
    vs = [torch.randn(s, generator=gen, device=dev) * 0.01 for s in shapes]
    plan = ops.SGDMomentumPlan(ws, vs, form="mxnet",
                               weights=weights if mp else None)
    tol = TOL[("sgd_mxnet", torch.float32)]
    errs = []
    for lr in SGD_MXNET_LRS:
        gs = [(torch.randn(s, generator=gen, device=dev) * 2.0).to(low)
              for s in shapes]
        want = [ops.sgd_mxnet_plain(w, g, v, lr, clip=clip, **SGD_MXNET)
                for w, g, v in zip(ws, gs, vs)]
        plan(gs, lr, clip=clip, **SGD_MXNET)
        torch.cuda.synchronize()
        err = 0.0
        for i, (w_new, v_new) in enumerate(want):
            scale = max(1.0, w_new.abs().max().item())
            err = max(err, (ws[i] - w_new).abs().max().item() / scale,
                      (vs[i] - v_new).abs().max().item())
            if mp and not torch.equal(weights[i], w_new.to(low)):
                fail("fused_sgd_momentum MXNet form, mp: bf16 weight %d is "
                     "not the plain master's bf16 rounding (off by %g)"
                     % (i, (weights[i].float() - w_new.to(low).float())
                        .abs().max().item()))
        errs.append(err)
    if not np.isfinite(errs).all() or max(errs) > tol:
        fail("fused_sgd_momentum MXNet form %d tensors, %s: max err %s over "
             "3 calls > %g" % (len(shapes), "mp bf16" if mp else "fp32",
                               errs, tol))
    n = sum(w.numel() for w in ws)
    # read w (or master), g, v; write w (or master), v, and the bf16
    # weight: 20 bytes an element in both
    nbytes = 20 * n
    # rescale, 2 clamp compares, wd's product and sum, momentum's and
    # lr's products, their difference, the weight's sum
    flops = 9 * n
    lr = SGD_MXNET_LRS[-1]
    kernel = lambda: plan(gs, lr, clip=clip, **SGD_MXNET)  # noqa: E731
    params = [torch.nn.Parameter(torch.randn(s, generator=gen, device=dev))
              for s in shapes]
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen, device=dev)
    opt = torch.optim.SGD(params, lr=lr, momentum=SGD_MXNET["momentum"],
                          dampening=0, weight_decay=SGD_MXNET["wd"],
                          fused=True)
    opt.step()           # its momentum buffers exist from here on
    kernel_ms, library_ms = paired_ms(kernel, opt.step)
    return dict(
        name="fused_sgd_momentum", form="mxnet",
        shape=[len(shapes), n], dtype="mp bf16 (fp32 master)" if mp
        else str(torch.float32), clip=clip, lrs=list(SGD_MXNET_LRS),
        max_abs_err=max(errs), errs_per_call=errs, tol=tol,
        kernel_ms=kernel_ms, library_ms=library_ms,
        library="fused torch.optim.SGD, fp32 tensors of the same shapes",
        plain_ms=cuda_ms(lambda: [
            ops.sgd_mxnet_plain(w, g, v, lr, clip=clip, **SGD_MXNET)
            for w, g, v in zip(ws, gs, vs)], iters=5),
        device_ms=kernel_device_ms(kernel, "MXNetForm"),
        library_device_ms=device_ms(opt.step),
        bytes=nbytes, flops=flops, peak_flop_s=FP32_FLOP_S,
        **bound(nbytes, flops, FP32_FLOP_S))


def check_conv1x1(ops, dev, M, cin, cout, dtype, gen, layout="row",
                  expect=None):
    """conv1x1_bn_stats against conv1x1_bn_stats_plain at (M, Cin, Cout),
    w row-major (Cin, Cout) (`layout="row"`) or the transpose of a
    row-major (Cout, Cin) (`"t"`, a conv weight as the train path passes
    it), and the times of the kernel and the library yardstick
    (torch.matmul + torch.var_mean in x's dtype) in turns, the plain
    version, and both device times. `expect`: the kernel the profiler must
    see (the path the wrapper chose)."""
    x = torch.randn(M, cin, generator=gen, device=dev).to(dtype)
    w = (torch.randn(cin, cout, generator=gen, device=dev)
         / math.sqrt(cin)).to(dtype)
    if layout == "t":
        w = w.t().contiguous().t()
    got = ops.conv1x1_bn_stats(x, w)
    torch.cuda.synchronize()
    want = ops.conv1x1_bn_stats_plain(x, w)
    errs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(got, want)]
    tols = list(TOL[("conv1x1_bn_stats", dtype)])
    if dtype == torch.bfloat16:
        tols[0] *= max(1.0, want[0].float().abs().max().item())
    if not all(np.isfinite(errs)) or any(e > t for e, t in zip(errs, tols)):
        fail("conv1x1_bn_stats (%d, %d, %d) %s w %s: max abs err y/mean/var "
             "%s > %s" % (M, cin, cout, dtype, layout, errs, tols))
    del got, want
    kernel = lambda: ops.conv1x1_bn_stats(x, w)  # noqa: E731
    library = lambda: torch.var_mean(  # noqa: E731
        torch.matmul(x, w), dim=0, correction=0)
    seen = kernels_seen(kernel, "conv1x1_", expect) if expect else []
    if expect and not any(expect in k for k in seen):
        fail("conv1x1_bn_stats (%d, %d, %d) %s w %s ran %s, not %s"
             % (M, cin, cout, dtype, layout, seen, expect))
    elem = x.element_size()
    nbytes = (M * cin + cin * cout + M * cout) * elem + 8 * cout
    flops = 2 * M * cin * cout + 3 * M * cout
    peak = FP32_FLOP_S if dtype == torch.float32 else BF16_FLOP_S
    kernel_ms, library_ms = paired_ms(kernel, library)
    return dict(
        name="conv1x1_bn_stats", shape=[M, cin, cout], dtype=str(dtype),
        w_layout=layout, kernels=[k[:60] for k in seen],
        max_abs_err=max(errs), errs_y_mean_var=errs, tols_y_mean_var=tols,
        kernel_ms=kernel_ms, library_ms=library_ms,
        plain_ms=cuda_ms(lambda: ops.conv1x1_bn_stats_plain(x, w)),
        device_ms=kernel_device_ms(kernel,
                                   ("conv1x1_", "bn_stats_finalize_kernel"),
                                   launches=2),
        library_device_ms=device_ms(library),
        bytes=nbytes, flops=flops, peak_flop_s=peak,
        **bound(nbytes, flops, peak))


def conv1x1_paths(ops, dev, gen, card):
    """The conv1x1 kernel's paths and properties at their own shapes:
    the unaligned fallback (WMMA) in both weight layouts, a transposed
    weight at a main shape, and bit-identical results from two calls."""
    rows = [check_conv1x1(ops, dev, 300, 20, 36, torch.bfloat16, gen,
                          layout, expect="conv1x1_wmma_kernel")
            for layout in ("row", "t")]
    rows.append(check_conv1x1(ops, dev, 100352, 512, 128, torch.bfloat16,
                              gen, "t", expect="conv1x1_wgmma_kernel"))
    M, cin, cout = 401408, 64, 256
    x = torch.randn(M, cin, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(cout, cin, generator=gen, device=dev)
         / math.sqrt(cin)).to(torch.bfloat16).t()
    a, b = ops.conv1x1_bn_stats(x, w), ops.conv1x1_bn_stats(x, w)
    torch.cuda.synchronize()
    same = [torch.equal(u, v) for u, v in zip(a, b)]
    if not all(same):
        fail("conv1x1_bn_stats (%d, %d, %d): two calls differ (y, mean, "
             "var identical: %s)" % (M, cin, cout, same))
    for r in rows:
        emit(phase="kernel_path", card=card, **r)
    emit(phase="conv1x1_bits", card=card, shape=[M, cin, cout],
         bit_identical_y_mean_var=same)
    return rows


def resnet50_conv1x1_calls(batch=BATCH):
    """{(M, Cin, Cout): calls} of conv1x1_bn_stats in one ResNet-50 v1
    training forward at `batch` (224x224): per bottleneck its first and
    last 1x1 convolution, plus each stage's downsample; 36 in all."""
    calls = {}
    in_ch = 64
    for (blocks, ch, side) in ((3, 256, 56), (4, 512, 28), (6, 1024, 14),
                               (3, 2048, 7)):
        M = batch * side * side
        for b in range(blocks):
            cin = in_ch if b == 0 else ch
            for shape in [(M, cin, ch // 4), (M, ch // 4, ch)] + \
                    ([(M, in_ch, ch)] if b == 0 else []):
                calls[shape] = calls.get(shape, 0) + 1
        in_ch = ch
    assert sum(calls.values()) == 36
    return calls


def mobilenet_conv1x1_calls(batch=BATCH, img=IMG):
    """{(M, Cin, Cout): calls} of conv1x1_bn_stats in one MobileNet-1.0
    training forward at `batch` (img x img, NHWC): the pointwise
    convolution of each of the 13 depthwise-separable blocks
    (mobilenet.py: channels and strides)."""
    dw = [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024]
    pw = [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2
    strides = [1, 2] * 3 + [1] * 5 + [2, 1]
    side = img // 2
    calls = {}
    for cin, cout, s in zip(dw, pw, strides):
        side = -(-side // s)
        shape = (batch * side * side, cin, cout)
        calls[shape] = calls.get(shape, 0) + 1
    assert sum(calls.values()) == 13
    return calls


def conv1x1_per_forward(ops, dev, gen, card, calls=None,
                        phase="kernel_main_shape",
                        expect="conv1x1_wgmma_kernel",
                        dtype=torch.bfloat16):
    """conv1x1_bn_stats at each shape of one training forward (ResNet-50
    b128 unless `calls` says otherwise), in `dtype` (bf16, or fp32 as the
    Module path runs it) with the weight as a transposed view, checked
    and timed shape by shape, in turns with `matmul` + `var_mean` (each
    row emitted), and summed over the forward's calls. `expect`: the
    kernel the profiler must see at every shape."""
    calls = calls or resnet50_conv1x1_calls()
    per = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
               library_device_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0,
               err=0.0, shapes=len(calls), calls=sum(calls.values()),
               kernels=set())
    for (M, cin, cout), n in calls.items():
        # the weight as the train path passes it: a (Cout, Cin) transposed
        r = check_conv1x1(ops, dev, M, cin, cout, dtype, gen, "t",
                          expect=expect)
        emit(phase=phase, card=card, calls_per_forward=n, **r)
        for key, src in (("ms", "kernel_ms"), ("device_ms", "device_ms"),
                         ("plain_ms", "plain_ms"),
                         ("library_ms", "library_ms"),
                         ("library_device_ms", "library_device_ms")):
            # None (the profiler did not see every launch) stays None
            per[key] = None if per[key] is None or r[src] is None \
                else per[key] + n * r[src]
        per["bound_ms"] += n * r["bound_us"] / 1e3
        per["t_bytes"] += n * r["bytes"] / HBM_BYTES_S
        per["t_ops"] += n * r["flops"] / r["peak_flop_s"]
        per["err"] = max(per["err"], r["max_abs_err"])
        per["kernels"] |= set(r["kernels"])
    per["kernels"] = sorted(per["kernels"])
    return per


def bound(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
    return dict(bound_us=max(t_bytes, t_ops) * 1e6,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                peaks=PEAKS)


# ---------------------------------------------------------------------------
# phase 4/5: the model
# ---------------------------------------------------------------------------
def small_model_check(dev):
    from mxnet_tpu_torch.convert import init_gpt_params
    from mxnet_tpu_torch.gluon.model_zoo import GPTDecoder
    cfg = dict(vocab_size=96, max_seq_len=64, num_layers=2, num_heads=2,
               embed_dim=32, mlp_ratio=4)
    spec = dict(cfg, head_dim=16, mlp_hidden=128)
    params = init_gpt_params(spec, seed=3)
    on_card = GPTDecoder(params=params, device=dev, **cfg)
    on_cpu = GPTDecoder(params=params, device="cpu", **cfg)
    toks = np.random.default_rng(4).integers(0, 96, size=(2, 40))
    a = on_card(torch.from_numpy(toks)).cpu()
    b = on_cpu(torch.from_numpy(toks))
    err = (a - b).abs().max().item()
    if a.shape != (2, 40, 96) or not torch.isfinite(a).all() or err > 1e-4:
        fail("small GPT: card vs CPU logits max abs err %g" % err)
    prompt = toks[0, :7]
    t_card = on_card.generate_reference(prompt, 12)
    t_cpu = on_cpu.generate_reference(prompt, 12)
    if not np.array_equal(t_card, t_cpu):
        fail("small GPT: greedy tokens differ card %s cpu %s"
             % (t_card, t_cpu))
    emit(phase="small", logits_max_abs_err=err, tol=1e-4,
         tokens_identical=True)


def serve(dev, card):
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.convert import init_gpt_params
    from mxnet_tpu_torch.gluon.model_zoo import GPTDecoder
    from mxnet_tpu_torch.serving import (ContinuousBatchScheduler,
                                         DecodeEngine)
    cfg = GPT2_SMALL
    spec = dict(cfg, head_dim=64, mlp_hidden=4 * 768)
    t0 = time.perf_counter()
    blk = GPTDecoder(params=init_gpt_params(spec, seed=0), device=dev,
                     **cfg)
    n_params = sum(p.numel() for p in blk.parameters())
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg["vocab_size"], size=n)
               for n in PROMPT_LENS]
    engine = DecodeEngine(blk, max_slots=SLOTS, device=dev, name="cb")
    buckets = sorted({engine.bucket_for(len(p)) for p in prompts})
    engine.warmup(buckets=buckets)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # the main path, with every launch counter at 0 just before it
    sched = ContinuousBatchScheduler(engine, max_new_tokens=NEW_TOKENS)
    steps0 = engine.steps
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sched.start()
    handles = [sched.submit(p) for p in prompts]
    outs = [h.result(timeout=600) for h in handles]
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = engine.steps - steps0
    if not sched.drain(timeout=60):
        fail("scheduler did not drain")

    if any(len(o) != NEW_TOKENS for o in outs):
        fail("a request resolved with %s tokens, want %d"
             % ([len(o) for o in outs], NEW_TOKENS))
    want_flash = cfg["num_layers"] * len(prompts)
    want_ln = (2 * cfg["num_layers"] + 1) * (len(prompts) + steps)
    if launches["flash_attention"] != want_flash or \
            launches["layer_norm"] != want_ln:
        fail("launch counts %s, want flash_attention %d (12 per prompt) "
             "and layer_norm %d (25 per forward)"
             % (launches, want_flash, want_ln))

    # oracle: the same prompts one at a time on an engine of the same
    # shapes (serve_bench's `parity`)
    seq_engine = DecodeEngine(blk, max_slots=SLOTS, device=dev, name="seq")
    oracle = sequential_tokens(seq_engine, prompts)
    for prompt, got, toks in zip(prompts, outs, oracle):
        if not np.array_equal(toks, got):
            fail("prompt of %d tokens: batched %s != sequential %s"
                 % (len(prompt), list(got), list(toks)))

    # one whole-batch step with every slot active, timed alone
    seq_engine.reset()
    for slot, prompt in enumerate(prompts):
        seq_engine.prefill(prompt, slot)
    step_ms = []
    for _ in range(16):
        t = time.perf_counter()
        seq_engine.step()
        step_ms.append((time.perf_counter() - t) * 1e3)
    # where one step's and one 990-token prefill's time goes on the card
    step_profile = breakdown(profiled(seq_engine.step, 4), 4,
                             percentile(step_ms, 50))
    last = SLOTS - 1
    seq_engine.retire(last)
    t = time.perf_counter()
    seq_engine.prefill(prompts[last], last)
    prefill_ms = (time.perf_counter() - t) * 1e3
    seq_engine.retire(last)
    prefill_profile = breakdown(
        profiled(lambda: seq_engine.prefill(prompts[last], last), 1), 1,
        prefill_ms)
    emit(phase="profile", card=card, decode_step_8_slots=step_profile,
         prefill_990_tokens=prefill_profile)

    ttft = [h.ttft() * 1e3 for h in handles]
    total = sum(len(o) for o in outs)
    emit(phase="serve", card=card, model="GPT-2-small width, seeded random "
         "weights", params=n_params, dtype="fp32", slots=SLOTS,
         prompts=list(PROMPT_LENS), new_tokens=NEW_TOKENS,
         tokens=total, wall_s=wall, tok_s=total / wall,
         ttft_ms_p50=percentile(ttft, 50), ttft_ms_p95=percentile(ttft, 95),
         step_ms_p50=percentile(step_ms, 50), steps=steps,
         setup_s=setup_s, launches=launches,
         tokens_identical_to_sequential=True,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return dict(launches=launches, blk=blk, prompts=prompts, oracle=oracle,
                tok_s=total / wall)


def sequential_tokens(engine, prompts, new_tokens=None):
    """Greedy tokens of each prompt decoded alone in slot 0 of `engine`
    (int32 arrays; NEW_TOKENS of them unless `new_tokens`): the oracle
    of batched decoding."""
    new_tokens = new_tokens or NEW_TOKENS
    out = []
    for prompt in prompts:
        toks = [engine.prefill(prompt, 0)]
        while len(toks) < new_tokens:
            toks.append(int(engine.step()[0]))
        engine.retire(0)
        out.append(np.asarray(toks, np.int32))
    return out


# ---------------------------------------------------------------------------
# phase 6/7: training
# ---------------------------------------------------------------------------
def train_small(dev):
    """3 fp32 steps of a narrow ResNetV1 on the card and on the CPU from
    the same seeded weights: losses and final parameters agree."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.convert import init_resnet_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    from mxnet_tpu_torch.parallel import ShardedTrainer, data_parallel
    rng = np.random.RandomState(2)
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    y = (np.arange(8) % 10).astype(np.float32)
    runs = {}
    for where in (dev, torch.device("cpu")):
        net = ResNetV1(BottleneckV1, [1, 1], [16, 32, 64], classes=10,
                       layout="NHWC", device=where)
        init_resnet_params(net, seed=3)
        st = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9},
                            device=where)
        ops.reset_launch_counts()
        losses = [float(st.step(x, y)) for _ in range(3)]
        # the two nets' top-level prefixes differ: names below them agree
        runs[where.type] = (losses, {k[len(net.prefix):]: v for k, v in
                                     st.params.items()},
                            ops.launch_counts())
    (lc, pc, nc), (lh, ph, nh) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(lc, lh))
    param_err = max((pc[k].cpu() - ph[k]).abs().max().item() for k in ph)
    # fp32 on both; cuDNN and the CPU convolutions sum in other orders and
    # the updates carry that on (8.6e-5 after 3 steps on an H100)
    loss_tol, param_tol = 1e-4, 1e-3
    if not np.isfinite(lc).all() or loss_err > loss_tol or \
            param_err > param_tol:
        fail("train_small: card vs CPU losses %s vs %s, max param err %g "
             "(tol %g, %g)" % (lc, lh, param_err, loss_tol, param_tol))
    # 3 bottlenecks' worth per forward: 2 body + 1 downsample, 2 blocks;
    # on the card the wrappers run in the graph's eager warm-up steps and
    # its capture, and its 3 replays call none
    steps = 1 + data_parallel._WARMUP
    if nc["conv1x1_bn_stats"] != 6 * steps or \
            nc["fused_sgd_momentum"] != steps or any(nh.values()):
        fail("train_small: launches card %s, CPU %s; want %d "
             "conv1x1_bn_stats and %d fused_sgd_momentum on the card (%d "
             "warm-up steps and the capture), none on the CPU"
             % (nc, nh, 6 * steps, steps, data_parallel._WARMUP))
    emit(phase="train_small", losses_card=lc, losses_cpu=lh,
         loss_max_abs_err=loss_err, param_max_abs_err=param_err,
         loss_tol=loss_tol, param_tol=param_tol, launches=nc)


def _trainer_state(st):
    """Every tensor of a ShardedTrainer's state: parameters, optimizer
    state, BatchNorm statistics."""
    def flat(d):
        for v in d.values():
            if isinstance(v, dict):
                yield from flat(v)
            else:
                yield v
    return [*st._params.values(), *flat({"s": st._opt_state}),
            *st._aux.values()]


def _graph_and_eager(make):
    """Two trainers from `make()`: one on the CUDA-graph step, one eager
    (MXTPU_CUDA_GRAPH=0 at construction)."""
    os.environ["MXTPU_CUDA_GRAPH"] = "0"
    try:
        eager = make()
    finally:
        os.environ.pop("MXTPU_CUDA_GRAPH")
    graph = make()
    if eager._graph_on or not graph._graph_on:
        fail("the trainers' step modes are %s and %s, want eager and graph"
             % (eager._graph_on, graph._graph_on))
    return graph, eager


def train(dev, card):
    """ResNet-50 v1 training as bench.py's _train_tput sets it up, through
    the port's ShardedTrainer.step_many, on its CUDA-graph step and on the
    eager step (MXTPU_CUDA_GRAPH=0), both from the same seeded weights:
    the first window of each must leave bit-identical weights, momenta
    and BatchNorm statistics (cuDNN's deterministic algorithms, as in
    dist_train); then a timed window of each. The launch counters are
    zeroed before each first window (the main path) and read after it:
    the eager trainer's wrappers launch 36 conv1x1 and 1 SGD kernel a
    step; the graph trainer's launch them in its warm-up steps and its
    capture, and its replays call no wrapper, so their launches are
    counted by the profiler over TRAIN_STEPS replays. Returns
    {"graph_replays": the profiler's counts, "graph_capture": the graph
    trainer's wrapper counts, "eager": the eager trainer's}."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.convert import init_resnet_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.observability import registry
    from mxnet_tpu_torch.parallel import ShardedTrainer, data_parallel
    from mxnet_tpu_torch.resilience import numerics
    t0 = time.perf_counter()
    net = resnet50_v1(layout="NHWC", device=dev)
    init_resnet_params(net, seed=0)
    graph, eager = _graph_and_eager(lambda: ShardedTrainer(
        net, SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9},
        compute_dtype="bfloat16", device=dev))
    n_params = sum(v.numel() for v in graph.params.values())
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(BATCH, IMG, IMG, 3).astype("float32")) \
        .to(dev)
    y = torch.from_numpy((rng.rand(BATCH) * 1000).astype("float32")).to(dev)
    disp = registry.counter("train.step.dispatches")
    torch.backends.cudnn.deterministic = True
    try:
        # from one state, a window of each: bit for bit. Its peak memory
        # holds a step's working set in both modes (the graph's warm-up
        # and capture allocate it; its replays reuse the graph's pool)
        # and the main path, with every launch counter at 0 just before it
        warm, warm_s, warm_gb, counted = {}, {}, {}, {}
        for mode, st in (("eager", eager), ("graph", graph)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            d0 = disp.get()
            ops.reset_launch_counts()
            t = time.perf_counter()
            warm[mode] = st.step_many(x, y, n_steps=TRAIN_STEPS).cpu()
            warm_s[mode] = time.perf_counter() - t   # graph: + capture
            counted[mode] = ops.launch_counts()
            warm_gb[mode] = torch.cuda.max_memory_allocated() / 1e9
            # wrapper calls: eager, one a step; graph, one a warm-up step
            # and one in the capture
            calls = TRAIN_STEPS if mode == "eager" else \
                data_parallel._WARMUP + 1
            lc = counted[mode]
            if lc["conv1x1_bn_stats"] != 36 * calls or \
                    lc["fused_sgd_momentum"] != calls or \
                    disp.get() - d0 != TRAIN_STEPS:
                fail("train %s: the first window's wrappers launched %s and "
                     "it made %d dispatches; want %d conv1x1_bn_stats, %d "
                     "fused_sgd_momentum and %d dispatches"
                     % (mode, lc, disp.get() - d0, 36 * calls, calls,
                        TRAIN_STEPS))
        numerics.drain_flags()
        first_state = [t.clone() for t in _trainer_state(graph)]
        same = torch.equal(warm["eager"], warm["graph"]) and all(
            torch.equal(a, b) for a, b in zip(_trainer_state(eager),
                                              _trainer_state(graph)))
        if not same:
            fail("train: %d eager and %d graph steps from one state left "
                 "different losses, weights, momenta or statistics"
                 % (TRAIN_STEPS, TRAIN_STEPS))
        setup_s = time.perf_counter() - t0
        runs = {}
        for mode, st in (("graph", graph), ("eager", eager)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            d0 = disp.get()
            ops.reset_launch_counts()
            t = time.perf_counter()
            losses = st.step_many(x, y, n_steps=TRAIN_STEPS).cpu().numpy()
            wall = time.perf_counter() - t
            launches = ops.launch_counts()
            dispatches = disp.get() - d0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            guard = numerics.drain_flags()
            if not np.isfinite(losses).all() or guard["skipped_steps"] or \
                    guard["anomalies"]:
                fail("train %s: losses %s, numerics guard %s"
                     % (mode, losses, guard))
            if not losses[-1] < warm[mode][0]:
                fail("train %s: loss did not fall: first %g, last %g"
                     % (mode, warm[mode][0], losses[-1]))
            # the graph's replays call no wrapper; the eager step's call
            # each one once a step
            calls = 0 if mode == "graph" else TRAIN_STEPS
            if launches["conv1x1_bn_stats"] != 36 * calls or \
                    launches["fused_sgd_momentum"] != calls or \
                    dispatches != TRAIN_STEPS:
                fail("train %s: the wrappers launched %s and %d dispatches "
                     "ran over %d steps, want %d conv1x1_bn_stats, %d "
                     "fused_sgd_momentum and 1 dispatch a step"
                     % (mode, launches, dispatches, TRAIN_STEPS, 36 * calls,
                        calls))
            if mode == "graph":
                # what the replays launched, read on the device
                want = {"conv1x1_bn_stats": 36 * TRAIN_STEPS,
                        "fused_sgd_momentum": TRAIN_STEPS}
                replayed = device_launches(
                    lambda: st.step_many(x, y, n_steps=TRAIN_STEPS), 1, want)
                if any(replayed[k] != v for k, v in want.items()) or \
                        replayed["flash_attention"] or replayed["layer_norm"]:
                    fail("train graph: the profiler saw %s over %d replays, "
                         "want %s" % (replayed, TRAIN_STEPS, want))
                numerics.drain_flags()
            per_step = replayed if mode == "graph" else launches
            # one step: the host's enqueue, the wall to its end, the device
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = st.step_many(x, y, n_steps=1)
            host_ms = (time.perf_counter() - t) * 1e3
            out.cpu()
            one_step_ms = (time.perf_counter() - t) * 1e3
            event_ms = cuda_ms(lambda: st.step_many(x, y, n_steps=1),
                               iters=3, warmup=0)
            events = device_events(lambda: st.step_many(x, y, n_steps=1), 1)
            dev_us = {k: us for k, (us, _) in events.items()}
            # every conv1x1 of the bf16 step must take the wgmma/TMA path:
            # the wrapper picks the WMMA fallback from shapes and pointers
            conv_paths = {k[:90]: c for k, (_, c) in events.items()
                          if "conv1x1_" in k}
            if any("conv1x1_wmma_kernel" in k or "conv1x1_simt_kernel" in k
                   for k in conv_paths) or (events and not any(
                       "conv1x1_wgmma_kernel" in k for k in conv_paths)):
                fail("train %s: the step's conv1x1 launches were %s, want "
                     "only conv1x1_wgmma_kernel" % (mode, conv_paths))
            profile = breakdown(dev_us, 1, one_step_ms, top_n=12)
            profile["host_enqueue_ms"] = host_ms
            profile["cuda_event_ms"] = event_ms
            profile["device_ms_by_kind"] = by_kind(dev_us, 1)
            profile["conv1x1_kernels"] = conv_paths
            img_s = BATCH * TRAIN_STEPS / wall
            runs[mode] = dict(
                img_s=img_s, step_ms=wall / TRAIN_STEPS * 1e3, wall_s=wall,
                mfu=FLOPS_PER_IMG * img_s / BF16_FLOP_S,
                host_enqueue_ms=host_ms, one_step_ms=one_step_ms,
                cuda_event_ms=event_ms, device_ms=profile["device_ms"],
                device_busy_share=profile["device_busy_share"],
                peak_mem_gb=peak_gb, losses=losses.tolist(),
                conv1x1_bn_stats_a_step=per_step["conv1x1_bn_stats"] /
                TRAIN_STEPS,
                fused_sgd_momentum_a_step=per_step["fused_sgd_momentum"] /
                TRAIN_STEPS,
                launches_read_by="profiler over %d replays" % TRAIN_STEPS
                if mode == "graph" else "wrapper counts",
                train_step_dispatches_a_step=dispatches / TRAIN_STEPS,
                wrapper_launches=launches, first_window_wrapper_launches=
                counted[mode], numerics=guard, profile_one_step=profile)
    finally:
        torch.backends.cudnn.deterministic = False
    # the stride-2 subsample copies in front of the kernel (6 a forward:
    # the first block's conv0 and downsample in stages 2-4)
    acts = [torch.empty(BATCH, side, side, ch, device=dev,
                        dtype=torch.bfloat16)
            for side, ch in ((56, 256), (28, 512), (14, 1024))]
    subsample_ms = cuda_ms(lambda: [a[:, ::2, ::2, :].contiguous()
                                    for a in acts for _ in range(2)])
    del acts
    emit(phase="train", card=card, model="ResNet-50 v1, NHWC, seeded "
         "random weights (Uniform 0.07)", params=n_params, batch=BATCH,
         image=IMG, dtype="bf16 compute, fp32 master", steps=TRAIN_STEPS,
         mfu_basis="3 x 4.089 GFLOP/img over %g FLOP/s bf16 dense"
         % BF16_FLOP_S, setup_s=setup_s, cudnn_deterministic=True,
         first_window_s=warm_s, first_window_peak_mem_gb=warm_gb,
         losses_first_window=warm["graph"].tolist(),
         graph_equals_eager_bit_for_bit=same,
         state_tensors_compared=len(_trainer_state(graph)),
         graphs_captured=len(graph._graphs), graph=runs["graph"],
         eager=runs["eager"],
         stride2_subsample_ms_per_forward=subsample_ms)
    return {"graph_replays": replayed, "graph_capture": counted["graph"],
            "eager": counted["eager"],
            # the reference dist_sharded holds its first window to
            "first_window": {"losses": warm["graph"],
                             "state": first_state,
                             "img_s": runs["graph"]["img_s"],
                             "step_ms": runs["graph"]["step_ms"],
                             "device_ms": runs["graph"]["device_ms"]}}


SHARDED_API = dict(batch=16, img=32, steps=3, tol=1e-5, dropout_steps=32,
                   slow_batches=6, slow_s=0.02, replays=3)


def _rel_err(a, b):
    """max |a - b| / max(1, max |b|) over two lists of tensors."""
    return max((float((x.double() - y.double()).abs().max()) /
                max(1.0, float(y.double().abs().max())) if y.numel() else 0.0)
               for x, y in zip(a, b))


class _SlowBatches:
    """(data, label) batches from a source that takes `delay` seconds a
    batch, as a reader of files or a decoder does."""

    def __init__(self, X, Y, batch, delay):
        self._X, self._Y, self._b, self._delay = X, Y, batch, delay

    def __iter__(self):
        for i in range(0, len(self._X), self._b):
            time.sleep(self._delay)
            yield self._X[i:i + self._b], self._Y[i:i + self._b]


class _StageDuringCapture:
    """While on, every CUDA graph capture begins with another thread doing
    what `prefetched`'s worker does between batches, and more: it pins a
    host tensor of a size not seen before, copies it to the card with
    ``non_blocking=True`` on a side stream, and allocates device memory
    of a size not seen before (a fresh cudaHostAlloc and cudaMalloc);
    the capture goes on once that thread has finished. Counts the
    stagings and keeps the thread's errors."""

    def __init__(self, dev):
        self.dev, self.staged, self.errors = dev, 0, []

    def _stage(self):
        from mxnet_tpu_torch.parallel.prefetch import to_device
        try:
            side = torch.cuda.Stream(device=self.dev)
            with torch.cuda.stream(side):
                k = self.staged + 1
                host = torch.full(((1 << 20) + 4096 * k,), float(k))
                staged = to_device(host, self.dev)
                fresh = torch.empty((256 << 20) + (4 << 20) * k,
                                    dtype=torch.uint8, device=self.dev)
                fresh[:1].fill_(1)
                torch.cuda.Event().record(side)
            del staged, fresh
            self.staged += 1
        except Exception as err:   # noqa: BLE001 — reported by the phase
            self.errors.append("%s: %s" % (type(err).__name__, err))

    def __enter__(self):
        import threading
        cls = torch.cuda.CUDAGraph
        self._begin = begin = cls.capture_begin
        outer = self

        def capture_begin(graph, *args, **kwargs):
            begin(graph, *args, **kwargs)
            t = threading.Thread(target=outer._stage)
            t.start()
            t.join()
        cls.capture_begin = capture_begin
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.capture_begin = self._begin


def sharded_api(dev, card):
    """ShardedTrainer's API on the card, each case on its CUDA-graph step
    against the eager step from the same seeded weights: a narrow NHWC
    ResNet V1 (train_small's) at b16, 32 px, fp32 (TF32 off), 3 steps
    each of Adam, remat (full and dots_with_no_batch_dims_saveable),
    aux_mode="predict", and `fit` over an NDArrayIter through
    `prefetched`; then `fit` over a slow source of 6 batches whose
    staging thread runs while the first step is captured, with another
    thread's fresh pinned and device allocations inside the capture
    (`_StageDuringCapture`); then `step`, `step_many(n_steps=2)` and
    `step` on one trainer, two graphs in its one memory pool; losses and
    every state tensor within 1e-5 of max(1, |eager|). The launches of each case's graph replays, read by
    the profiler, must be the eager step's, which its wrappers count.
    Then a net with Dropout(0.5) at lr 0: the graph's replays draw a new
    mask each (the package generator registered with the graph), and
    their mean loss lies within 5 standard errors of the eager steps'.
    Last, a NaN in a graph step's batch must leave every state tensor
    bit-identical (SGD: the kernel's veto flag; Adam: the gated writes).
    Returns {"wrappers": the graph runs' wrapper counts (warm-up steps
    and capture), "replays": the profiler's counts of the replays}."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.convert import init_resnet_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    from mxnet_tpu_torch.observability import registry
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.resilience import numerics
    cfg = SHARDED_API
    rng = np.random.RandomState(11)
    n = cfg["batch"] * cfg["steps"]
    X = rng.randn(n, cfg["img"], cfg["img"], 3).astype(np.float32)
    Y = (np.arange(n) % 10).astype(np.float32)
    n_slow = cfg["batch"] * cfg["slow_batches"]
    XS = rng.randn(n_slow, cfg["img"], cfg["img"], 3).astype(np.float32)
    YS = (np.arange(n_slow) % 10).astype(np.float32)
    x, y = torch.from_numpy(X[:cfg["batch"]]), torch.from_numpy(
        Y[:cfg["batch"]])
    sgd = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    cases = {"adam": ("adam", {"learning_rate": 0.01, "wd": 1e-4}, {}),
             "remat": sgd + ({"remat": True},),
             "remat_dots": sgd + ({"remat":
                                   "dots_with_no_batch_dims_saveable"},),
             "predict": sgd + ({"aux_mode": "predict"},),
             "fit": sgd + ({},),
             "fit_staging": sgd + ({},),
             "two_graphs": sgd + ({},)}
    disp = registry.counter("train.step.dispatches")
    total = {"wrappers": {k: 0 for k in ops.launch_counts()},
             "replays": {k: 0 for k in ops.launch_counts()}}
    out = {}

    def run(name, st):
        """The case's steps on `st`: their losses, on the host."""
        seen = []
        if name == "fit":
            st.fit(mx.io.NDArrayIter(X, Y, batch_size=cfg["batch"]),
                   batch_end_callback=lambda e, i, l: seen.append(l.clone()))
        elif name == "fit_staging":
            st.fit(_SlowBatches(XS, YS, cfg["batch"], cfg["slow_s"]),
                   batch_end_callback=lambda e, i, l: seen.append(l.clone()))
        elif name == "two_graphs":
            # step's guarded graph and step_many's unguarded one, in turns
            # in the trainer's one memory pool
            seen = [st.step(x, y), *st.step_many(x, y, n_steps=2),
                    st.step(x, y)]
        else:
            seen = [st.step(x, y) for _ in range(cfg["steps"])]
        return torch.stack(seen).cpu()

    torch.backends.cudnn.deterministic = True
    try:
        for name, (opt, hp, kw) in cases.items():
            def make():
                net = ResNetV1(BottleneckV1, [1, 1], [16, 32, 64],
                               classes=10, layout="NHWC", device=dev)
                init_resnet_params(net, seed=3)
                return ShardedTrainer(net, SoftmaxCrossEntropyLoss(), opt,
                                      dict(hp), device=dev, **kw)
            graph, eager = _graph_and_eager(make)
            steps = {"fit_staging": cfg["slow_batches"],
                     "two_graphs": 4}.get(name, cfg["steps"])
            n_graphs = 2 if name == "two_graphs" else 1
            losses, counted, dispatches = {}, {}, {}
            stager = _StageDuringCapture(dev)
            numerics.drain_flags()
            for mode, st in (("graph", graph), ("eager", eager)):
                ops.reset_launch_counts()
                d0 = disp.get()
                try:
                    if name == "fit_staging" and mode == "graph":
                        with stager:
                            losses[mode] = run(name, st)
                    else:
                        losses[mode] = run(name, st)
                except Exception as err:   # a failed capture fails here
                    fail("sharded_api %s (%s): %s: %s"
                         % (name, mode, type(err).__name__, err))
                counted[mode] = ops.launch_counts()
                dispatches[mode] = disp.get() - d0
            guard = numerics.drain_flags()
            err = max(_rel_err([losses["graph"]], [losses["eager"]]),
                      _rel_err(_trainer_state(graph), _trainer_state(eager)))
            if not (err <= cfg["tol"] and torch.isfinite(
                    losses["graph"]).all() and
                    len(graph._graphs) == n_graphs and
                    dispatches["graph"] == steps and not guard["anomalies"]):
                fail("sharded_api %s: graph against eager %g (tol %g), "
                     "losses %s / %s, %d graphs, %d dispatches over %d steps, "
                     "guard %s" % (name, err, cfg["tol"],
                                   losses["graph"].tolist(),
                                   losses["eager"].tolist(),
                                   len(graph._graphs), dispatches["graph"],
                                   steps, guard))
            if name == "fit_staging" and (stager.errors or
                                          stager.staged != 1):
                fail("sharded_api fit_staging: %d stagings during the "
                     "capture, errors %s" % (stager.staged, stager.errors))
            # the replays launch what the eager step's wrappers launch
            r = cfg["replays"]
            want = {k: v // steps * r for k, v in counted["eager"].items()}
            if any(v % steps for v in counted["eager"].values()):
                fail("sharded_api %s: the eager wrappers launched %s over "
                     "%d steps" % (name, counted["eager"], steps))
            replayed = device_launches(lambda: graph.step(x, y), r, want)
            numerics.drain_flags()
            if replayed != {k: want.get(k, 0) for k in replayed} or \
                    len(graph._graphs) != n_graphs:
                fail("sharded_api %s: the profiler saw %s over %d replays, "
                     "want the eager step's %s (%d graphs)"
                     % (name, replayed, r, want, len(graph._graphs)))
            for k in total["wrappers"]:
                total["wrappers"][k] += counted["graph"][k]
                total["replays"][k] += replayed[k]
            out[name] = dict(max_rel_err=err, losses=losses["graph"].tolist(),
                             dispatches=dispatches["graph"],
                             wrapper_launches=counted["graph"],
                             eager_wrapper_launches=counted["eager"],
                             replays_profiled=r, replay_launches=replayed)
            if name == "fit_staging":
                out[name]["stagings_during_capture"] = stager.staged
        out["dropout"] = _dropout_under_graph(dev, mx, ShardedTrainer,
                                              _graph_and_eager)
        # a non-finite gradient on the graph step: the SGD kernel's veto
        # flag and the gated writes leave every tensor as it was
        for opt, hp in (("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
                        ("adam", {"learning_rate": 0.01})):
            net = ResNetV1(BottleneckV1, [1, 1], [16, 32, 64], classes=10,
                           layout="NHWC", device=dev)
            init_resnet_params(net, seed=3)
            st = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), opt, hp,
                                device=dev)
            st.step(x, y)
            numerics.drain_flags()
            before = [t.clone() for t in _trainer_state(st)]
            bad = x.clone()
            bad[0, 0, 0, 0] = float("nan")
            loss = float(st.step(bad, y))
            guard = numerics.drain_flags()
            kept = all(torch.equal(a, b) for a, b in
                       zip(before, _trainer_state(st)))
            if np.isfinite(loss) or not kept or \
                    guard["skipped_steps"] != 1 or len(st._graphs) != 1:
                fail("sharded_api nan (%s): loss %g, state kept %s, guard "
                     "%s, %d graphs" % (opt, loss, kept, guard,
                                        len(st._graphs)))
            out["nan_" + opt] = dict(state_kept_bit_for_bit=kept,
                                     skipped_steps=guard["skipped_steps"])
    finally:
        torch.backends.cudnn.deterministic = False
    emit(phase="sharded_api", card=card, model="ResNetV1 BottleneckV1 "
         "[1, 1] [16, 32, 64], NHWC, fp32, seeded weights", batch=cfg["batch"],
         image=cfg["img"], steps=cfg["steps"], tol=cfg["tol"],
         cudnn_deterministic=True, cases=out)
    return total


def _dropout_under_graph(dev, mx, ShardedTrainer, pair):
    """An MLP with Dropout(0.5) at lr 0 (its weights never move): each
    graph replay draws a new mask, and the mean of the graph's losses
    lies within 5 standard errors of the eager steps' mean."""
    n = SHARDED_API["dropout_steps"]
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.randn(64, 32).astype(np.float32))
    y = torch.from_numpy((np.arange(64) % 10).astype(np.float32))

    def make():
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(256, activation="relu", in_units=32,
                                  device=dev),
                mx.gluon.nn.Dropout(0.5),
                mx.gluon.nn.Dense(10, in_units=256, device=dev))
        g = torch.Generator().manual_seed(12)
        net.load_parameters({k: torch.randn(v.shape, generator=g) * 0.1
                             for k, v in net.state_dict().items()})
        return ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              "sgd", {"learning_rate": 0.0}, device=dev)
    graph, eager = pair(make)
    try:
        lg = torch.stack([graph.step(x, y) for _ in range(n)]).cpu().double()
    except Exception as err:
        fail("sharded_api dropout (graph): %s: %s" % (type(err).__name__,
                                                       err))
    le = torch.stack([eager.step(x, y) for _ in range(n)]).cpu().double()
    se = float(((lg.var() + le.var()) / n).sqrt())
    gap = abs(float(lg.mean() - le.mean()))
    distinct = len(set(lg.tolist()))
    if distinct < n // 2 or gap > 5 * se:
        fail("sharded_api dropout: %d distinct losses over %d replays, "
             "mean %g against eager %g (5 standard errors: %g)"
             % (distinct, n, float(lg.mean()), float(le.mean()), 5 * se))
    return dict(steps=n, distinct_graph_losses=distinct,
                graph_mean=float(lg.mean()), eager_mean=float(le.mean()),
                standard_error=se)


# ---------------------------------------------------------------------------
# phase 8/9: the Gluon loop
# ---------------------------------------------------------------------------
def gluon_loop(net, trainer, loss_fn, x, y):
    """One iteration of the loop an MXNet user writes: record, backward,
    Trainer.step. Returns the mean loss (a device tensor)."""
    from mxnet_tpu_torch import autograd
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss.astorch().detach().float().mean()


def running_stats(net):
    return {k: p.data().clone() for k, p in net.collect_params().items()
            if "_running_" in k}


def gluon_small(dev):
    """3 fp32 iterations of the Gluon loop on a narrow ResNetV1, on the
    card and on the CPU from the same seeded weights, lr halved every
    step: losses, parameters and running statistics agree."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.convert import init_resnet_params
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(8, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy((np.arange(8) % 10).astype(np.float32))
    runs = {}
    for where in (dev, torch.device("cpu")):
        net = ResNetV1(BottleneckV1, [1, 1], [16, 32, 64], classes=10,
                       layout="NHWC", device=where)
        init_resnet_params(net, seed=3)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
            "lr_scheduler": mx.lr_scheduler.FactorScheduler(step=1,
                                                            factor=0.5)})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        ops.reset_launch_counts()
        losses = [float(gluon_loop(net, trainer, loss_fn, x.to(where),
                                   y.to(where))) for _ in range(3)]
        runs[where.type] = (losses, {k[len(net.prefix):]:
                                     p.data().detach().cpu() for k, p in
                                     net.collect_params().items()},
                            ops.launch_counts(), trainer.learning_rate)
    (lc, pc, nc, lrc), (lh, ph, nh, lrh) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(lc, lh))
    param_err = max((pc[k] - ph[k]).abs().max().item() for k in ph
                    if "_running_" not in k)
    stat_err = max((pc[k] - ph[k]).abs().max().item() for k in ph
                   if "_running_" in k)
    # fp32 on both; cuDNN and the CPU convolutions sum in other orders,
    # as in train_small
    loss_tol, param_tol, stat_tol = 1e-4, 1e-3, 1e-3
    if not np.isfinite(lc).all() or loss_err > loss_tol or \
            param_err > param_tol or stat_err > stat_tol or lrc != lrh:
        fail("gluon_small: card vs CPU losses %s vs %s, max param err %g, "
             "running statistics err %g (tol %g, %g, %g)"
             % (lc, lh, param_err, stat_err, loss_tol, param_tol, stat_tol))
    if nc["conv1x1_bn_stats"] != 6 * 3 or nc["fused_sgd_momentum"] != 3 \
            or any(nh.values()):
        fail("gluon_small: launches card %s, CPU %s; want 18 "
             "conv1x1_bn_stats and 3 fused_sgd_momentum on the card, none "
             "on the CPU" % (nc, nh))
    emit(phase="gluon_small", losses_card=lc, losses_cpu=lh,
         loss_max_abs_err=loss_err, param_max_abs_err=param_err,
         running_stats_max_abs_err=stat_err, loss_tol=loss_tol,
         param_tol=param_tol, stat_tol=stat_tol, final_lr=lrc, launches=nc)


def gluon_train(dev, card):
    """ResNet-50 v1 trained through the Gluon loop with MXNet's
    mixed-precision recipe. Returns the launch counts of the timed
    window and its img/s."""
    import gc
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.observability import registry
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mx.random.seed(0)
    net = resnet50_v1(layout="NHWC", device=dev)
    net.initialize()            # Gluon's default: Uniform(0.07)
    net.cast("bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
        "multi_precision": True,
        "lr_scheduler": mx.lr_scheduler.FactorScheduler(step=5,
                                                        factor=0.5)})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    n_params = sum(p.data().numel() for p in net.collect_params().values()
                   if p.grad_req != "null")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(BATCH, IMG, IMG, 3).astype("float32")) \
        .to(dev).to(torch.bfloat16)
    y = torch.from_numpy((rng.rand(BATCH) * 1000).astype("float32")).to(dev)
    warm = torch.stack([gluon_loop(net, trainer, loss_fn, x, y)
                        for _ in range(GLUON_WARM)]).cpu().numpy()
    setup_s = time.perf_counter() - t0
    g0, b0 = guard_counts(), trainer.numerics.last_report["step"]

    # the main path, with every launch counter at 0 just before it
    groups = registry.counter("optimizer.fused.groups")
    groups0 = groups.get()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = torch.stack([gluon_loop(net, trainer, loss_fn, x, y)
                          for _ in range(TRAIN_STEPS)]).cpu().numpy()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    sgd_groups = groups.get() - groups0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # one boundary a step, each reading its step's verdict
    guard = dict(guard_since(g0),
                 boundaries=trainer.numerics.last_report["step"] - b0)
    lrs = trainer.learning_rate

    if not (np.isfinite(warm).all() and np.isfinite(losses).all()):
        fail("gluon_train: non-finite loss: warm %s, timed %s"
             % (warm, losses))
    if guard["skipped_steps"] or guard["anomalies"] or \
            guard["boundaries"] != TRAIN_STEPS:
        fail("gluon_train: numerics guard reports %s over %d steps"
             % (guard, TRAIN_STEPS))
    if not losses[-1] < warm[0]:
        fail("gluon_train: loss did not fall: first %g, last %g"
             % (warm[0], losses[-1]))
    if launches["conv1x1_bn_stats"] != 36 * TRAIN_STEPS or \
            launches["fused_sgd_momentum"] != sgd_groups or \
            sgd_groups != TRAIN_STEPS:
        fail("gluon_train: launches %s and %d SGD groups over %d steps, "
             "want 36 conv1x1_bn_stats a step and one fused_sgd_momentum "
             "launch per SGD group, one group a step"
             % (launches, sgd_groups, TRAIN_STEPS))

    # where one step's time goes: host wall of one step, device profile
    t = time.perf_counter()
    gluon_loop(net, trainer, loss_fn, x, y).cpu()
    one_step_ms = (time.perf_counter() - t) * 1e3
    events = device_events(
        lambda: gluon_loop(net, trainer, loss_fn, x, y).cpu(), 1)
    dev_us = {k: us for k, (us, _) in events.items()}
    conv_paths = {k[:90]: c for k, (_, c) in events.items()
                  if "conv1x1_" in k}
    if any("conv1x1_wmma_kernel" in k or "conv1x1_simt_kernel" in k
           for k in conv_paths) or (events and not any(
               "conv1x1_wgmma_kernel" in k for k in conv_paths)):
        fail("gluon_train: the step's conv1x1 launches were %s, want only "
             "conv1x1_wgmma_kernel" % conv_paths)
    step_profile = breakdown(dev_us, 1, one_step_ms, top_n=12)
    step_profile["device_ms_by_kind"] = by_kind(dev_us, 1)
    step_profile["conv1x1_kernels"] = conv_paths
    step_profile["sgd_kernels"] = {k[:120]: c for k, (_, c) in events.items()
                                   if "sgd_" in k}

    # predict outside record(): the running statistics stay as they are,
    # and no graph is built (torch's own grad mode is on here)
    before = running_stats(net)
    out = net(x)
    torch.cuda.synchronize()
    after = running_stats(net)
    same = all(torch.equal(before[k], after[k]) for k in before)
    if not same or not torch.isfinite(out.float()).all() or \
            tuple(out.shape) != (BATCH, 1000) or out.requires_grad:
        fail("gluon_train: a record()-free net(x) moved the running "
             "statistics (%s), built a graph (%s) or gave %s non-finite "
             "logits" % (not same, out.requires_grad, tuple(out.shape)))
    step_ms = wall / TRAIN_STEPS * 1e3
    img_s = BATCH * TRAIN_STEPS / wall
    emit(phase="gluon_train", card=card, model="ResNet-50 v1, NHWC, seeded "
         "random weights (net.initialize(): Uniform 0.07)",
         params=n_params, batch=BATCH, image=IMG,
         dtype="net.cast(bfloat16), multi_precision (fp32 masters)",
         steps=TRAIN_STEPS, warm_steps=GLUON_WARM, img_s=img_s,
         step_ms=step_ms, wall_s=wall,
         mfu=FLOPS_PER_IMG * img_s / BF16_FLOP_S, peak_mem_gb=peak_gb,
         setup_s=setup_s, losses_warm=warm.tolist(),
         losses=losses.tolist(), lr_after=lrs, launches=launches,
         sgd_groups=sgd_groups, numerics=guard,
         running_stats_bit_identical_after_predict=same,
         profile_one_step=step_profile)
    return launches, img_s


# ---------------------------------------------------------------------------
# phases 10-13: the eager array layer (mx.nd)
# ---------------------------------------------------------------------------
ND_GPT = dict(batch=8, T=1024, warm=1, steps=3)
ND_SGD = dict(lr=0.01, momentum=0.9, wd=1e-4)
# card against CPU in the sweep: CUDA's math library and the CPU's differ
# in the last places, so the elementwise class takes 1e-5 here; a
# kernel-backed op takes its kernel's stated tolerance
ND_CARD_TOL = {"elem": 1e-5, "reduce": 1e-5, "gemm": 1e-4}
ND_KERNEL_TOL = {"LayerNorm": 1e-4, "_contrib_flash_attention": 1e-4}
# multi-precision SGD runs bf16 weights on the card (the kernel's low
# dtype): its output is one bf16 rounding of equal fp32 masters
ND_MP = ("mp_sgd_update", "mp_sgd_mom_update")
ND_KINDS = (("layer_norm kernel", ("layer_norm_kernel",)),
            ("fused_sgd_momentum kernel", ("sgd_momentum_kernel",)),
            ("flash_attention kernel", ("flash_fwd_kernel",)),
            ("GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_",
                               "sm80_")),
            ("copies and casts", ("copy", "Memcpy")),
            ("reductions", ("reduce", "softmax", "Softmax")),
            ("elementwise", ("elementwise", "Memset", "index", "gather",
                             "scatter", "embedding", "cat")))


def nd_run(name, arrays, params, train, ctx, cots=None, which=(),
           dtypes=None):
    """One call of registry op `name` on NDArrays made on `ctx` from
    numpy `arrays`; with `cots`, under record() and with a backward from
    those head gradients into the float inputs of `which`. Returns (the
    outputs, the inputs) as numpy, and the inputs' gradients."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.ndarray.ndarray import invoke
    from mxnet_tpu_torch.ops import registry as R
    op = R.get(name)
    with ctx:
        ins = [nd.array(a, dtype=(dtypes or {}).get(k, a.dtype))
               for k, a in enumerate(arrays)]
        grads = {}
        if cots is None:
            with autograd.train_mode() if train else autograd.pause():
                outs = invoke(op, ins, dict(params))
        else:
            for k in which:
                if np.issubdtype(arrays[k].dtype, np.floating):
                    ins[k].attach_grad()
            with autograd.record(train_mode=train):
                outs = invoke(op, ins, dict(params))
            heads = [o for o in outs if o._data.is_floating_point()]
            autograd.backward(heads, [nd.array(c) for c in
                                      cots[:len(heads)]])
            grads = {k: ins[k].grad.asnumpy() for k in which
                     if ins[k].grad is not None}
    return ([o.asnumpy() for o in outs], [i.asnumpy() for i in ins],
            grads)


def nd_sweep(dev):
    """Every registered op on the card against the same op on the CPU,
    from the case table of tools/torch_op_cases.py: outputs, the inputs
    after the call (aux write-backs) and, for the differentiable ops,
    the gradients of one record() -> backward; the random ops by the
    mean and variance of their draws."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry as R
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tools import torch_op_cases as C
    names = R.list_ops()
    t0 = time.perf_counter()
    failures, ran = [], 0
    card, host = mx.gpu(dev.index or 0), mx.cpu()
    for name in names:
        ran += 1
        case = C.case_of(name, R.get)
        try:
            if case is None:
                rcase = C.random_case_of(name, R.get)
                if rcase is None:
                    raise AssertionError("no case")
                make, params = rcase
                arrays = make(C.rng_for(name))
                mx.random.seed(0)
                got = nd_run(name, arrays, params, False, card)[0][0]
                want = nd_run(name, arrays, params, False, host)[0][0]
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise AssertionError("draws %s %s vs %s %s" % (
                        got.shape, got.dtype, want.shape, want.dtype))
                rows = got.reshape(-1, got.shape[-1]) if arrays and \
                    got.ndim > 1 else got.reshape(1, -1)
                for g, w in zip(rows, want.reshape(rows.shape)):
                    diff = C.draws_agree(g, w)
                    if diff:
                        raise AssertionError(diff)
                continue
            make, variants, tol_class, grad, opts = case
            tol = ND_KERNEL_TOL.get(name, ND_CARD_TOL[tol_class])
            if R.get(name) is R.get("LayerNorm"):
                tol = ND_KERNEL_TOL["LayerNorm"]
            dtypes = None
            for i, v in enumerate(variants):
                params, train, alt = C.split_params(v)
                arrays = (alt or make)(C.rng_for(name))
                if name in ND_MP:
                    dtypes = {k: "bfloat16" for k, a in enumerate(arrays)
                              if a.dtype == np.float16}
                outs = {}
                for where in (card, host):
                    outs[where] = nd_run(name, arrays, params, train,
                                         where, dtypes=dtypes)
                # the arrays held in bf16 (the weight, out and in)
                n_out = len(outs[host][0])
                low = {0} | {n_out + j for j in dtypes} if dtypes else ()
                for k, (g, w) in enumerate(zip(*(outs[c][0] + outs[c][1]
                                                 for c in (card, host)))):
                    t = 2.0 ** -8 if k in low else tol
                    diff = C.compare(g, w, t, opts.get("up_to_sign", False))
                    if diff:
                        raise AssertionError("variant %d array %d: %s"
                                             % (i, k, diff))
                if not grad:
                    continue
                r = np.random.RandomState(i + 7)
                cots = [C.f32(r.uniform(-1, 1, o.shape))
                        for o in outs[host][0]
                        if np.issubdtype(o.dtype, np.floating)]
                which = opts.get("grad_inputs", range(len(arrays)))
                gc = nd_run(name, arrays, params, train, card, cots, which)[2]
                gh = nd_run(name, arrays, params, train, host, cots, which)[2]
                for k in gh:
                    diff = C.compare(gc[k], gh[k], tol)
                    if diff:
                        raise AssertionError("variant %d d/d input %d: %s"
                                             % (i, k, diff))
        except Exception as e:  # noqa: BLE001 - every op is reported
            failures.append("%s: %s: %s" % (name, type(e).__name__, e))
    torch.cuda.synchronize()
    if failures:
        fail("nd_sweep: %d of %d ops failed on the card against the CPU:\n"
             "%s" % (len(failures), ran, "\n".join(failures)))
    unique = len({id(R.get(n)) for n in names})
    emit(phase="nd_sweep", ops_run=ran, ops_passed=ran - len(failures),
         unique_ops=unique, seconds=time.perf_counter() - t0,
         tol_card_vs_cpu=ND_CARD_TOL, tol_kernels=ND_KERNEL_TOL)
    return dict(ops_run=ran, ops_passed=ran - len(failures))


def nd_flash(ops, dev, card, gen):
    """nd.contrib.flash_attention under record() with a backward, at
    (8, 12, 1024, 64) causal in fp32 and bf16: one kernel launch a call;
    the output against attention_plain and the gradients against
    autograd through attention_plain (what the op's backward is); times
    of the forward and of forward + backward beside the plain version
    and SDPA."""
    import torch.nn.functional as F
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.ndarray import NDArray
    shape = (8, 12, 1024, 64)
    B, H, T, D = shape
    rows, launches = [], 0
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, cot = (torch.randn(shape, generator=gen, device=dev)
                        .to(dtype) for _ in range(4))
        arrs = [NDArray(t.clone()) for t in (q, k, v)]
        for a in arrs:
            a.attach_grad()
        head = NDArray(cot)

        def op_fwd_bwd():
            with autograd.record():
                out = nd.contrib.flash_attention(*arrs, causal=True)
            out.backward(head)
            return out

        ops.reset_launch_counts()
        out = op_fwd_bwd()
        torch.cuda.synchronize()
        n = ops.launch_counts()["flash_attention"]
        launches += n
        if n != 1:
            fail("nd_flash %s: %d flash_attention launches in one call, "
                 "want 1" % (dtype, n))
        refs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        ref = ops.attention_plain(*refs, causal=True)
        ref.backward(cot)
        tol = TOL[("flash_attention", dtype)]
        err = (out._data.float() - ref.float()).abs().max().item()
        gerr = max((a.grad._data.float() - r.grad.float()).abs().max().item()
                   for a, r in zip(arrs, refs))
        if not (np.isfinite(err) and np.isfinite(gerr)) or err > tol or \
                gerr > tol:
            fail("nd_flash %s: output err %g, gradient err %g > %g"
                 % (dtype, err, gerr, tol))
        sq, sk, sv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(sq, sk, sv, is_causal=True) \
                .backward(cot)

        def plain_fwd_bwd():
            ops.attention_plain(*refs, causal=True).backward(cot)

        fwd = lambda: nd.contrib.flash_attention(  # noqa: E731
            *arrs, causal=True)
        fwd_ms, sdpa_fwd_ms = paired_ms(fwd, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=10)
        fb_ms, sdpa_fb_ms = paired_ms(op_fwd_bwd, sdpa_fwd_bwd, iters=5,
                                      rounds=3)
        elem = q.element_size()
        flops = 2 * B * H * T * (T + 1) * D
        # forward + backward of causal attention: the forward's two
        # products and the backward's five, over the pairs j <= i
        fb_flops = flops * 7 / 2
        # the math the kernel runs: bf16 tensor cores, or fp32 as 3xTF32
        # (as check_flash bounds the serve row); the least time for the
        # fp32 backward's products is the same 3xTF32
        if dtype == torch.bfloat16:
            mult, peak = 1, BF16_FLOP_S
        else:
            mult, peak = 3, TF32_FLOP_S
        rows.append(dict(
            dtype=str(dtype), shape=list(shape), max_abs_err=err,
            grad_max_abs_err=gerr, tol=tol, launches_per_call=n,
            fwd_ms=fwd_ms, fwd_device_ms=kernel_device_ms(
                fwd, "flash_fwd_kernel"),
            fwd_plain_ms=cuda_ms(lambda: ops.attention_plain(
                q, k, v, causal=True), iters=10),
            fwd_library_ms=sdpa_fwd_ms,
            fwd_library_device_ms=device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True)),
            fwd_bwd_ms=fb_ms,
            fwd_bwd_device_ms=device_ms(op_fwd_bwd, n=3),
            fwd_bwd_plain_ms=cuda_ms(plain_fwd_bwd, iters=5),
            fwd_bwd_library_ms=sdpa_fb_ms,
            fwd_bwd_library_device_ms=device_ms(sdpa_fwd_bwd, n=3),
            fwd_bound=bound(4 * B * H * T * D * elem, mult * flops, peak),
            fwd_bwd_bound=bound(8 * B * H * T * D * elem, mult * fb_flops,
                                peak)))
    emit(phase="nd_flash", card=card, rows=rows, launches=launches)
    return dict(rows=rows, launches=launches)


def nd_save(dev):
    """Arrays written by nd.save from the card, read back by nd.load on
    the CPU: names, dtypes and values bit for bit (bf16 as float32)."""
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    rng = np.random.RandomState(6)
    want = {"w_float32": rng.randn(64, 33).astype(np.float32),
            "w_float16": rng.randn(17).astype(np.float16),
            "w_int32": rng.randint(-9, 9, (5, 5)).astype(np.int32),
            "w_uint8": rng.randint(0, 255, (7,)).astype(np.uint8)}
    with mx.gpu(dev.index or 0):
        arrays = {k: nd.array(v, dtype=v.dtype) for k, v in want.items()}
        arrays["w_bfloat16"] = nd.array(want["w_float32"][:4],
                                        dtype="bfloat16")
    want["w_bfloat16"] = arrays["w_bfloat16"].asnumpy()
    with tempfile.TemporaryDirectory() as d:
        fname = os.path.join(d, "card.params")
        nd.save(fname, arrays)
        with mx.cpu():
            got = nd.load(fname)
    for k, v in want.items():
        g = got[k]
        if g.context != mx.cpu() or g.dtype != v.dtype or \
                not np.array_equal(g.asnumpy(), v):
            fail("nd_save: %s came back as %s %s on %s" % (
                k, g.dtype, g.shape, g.context))
    emit(phase="nd_save", arrays=sorted(want), bit_identical=True)


def nd_cross_entropy(nd, logits, labels):
    """Mean token cross entropy through registry ops."""
    return -nd.mean(nd.pick(nd.log_softmax(logits, axis=-1), labels,
                            axis=-1))


def nd_gpt_step(nd, autograd, net, P, moms, tok, labels):
    """One training step through mx.nd: record the Gluon forward and the
    loss, backward, one sgd_mom_update of every weight in place.
    Returns the loss (an NDArray) and the backward's host milliseconds
    (no synchronise: what the call costs the host)."""
    with autograd.record():
        logits = net.hybrid_forward(nd, tok, **P)
        loss = nd_cross_entropy(nd, logits, labels)
    t = time.perf_counter()
    loss.backward()
    bwd_host_ms = (time.perf_counter() - t) * 1e3
    for k, w in P.items():
        nd.sgd_mom_update(w, w.grad, moms[k], out=w, **ND_SGD)
    return loss, bwd_host_ms


def nd_gpt_setup(cfg, ctx, seed, batch, T):
    """A GPT of `cfg` on `ctx` for the mx.nd path: its seeded weights as
    NDArrays with gradient buffers (the net's parameters share their
    storage), zero momenta, and seeded tokens with their next-token
    labels."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.convert import init_gpt_params
    from mxnet_tpu_torch.gluon.model_zoo import GPTDecoder
    spec = dict(cfg, head_dim=cfg["embed_dim"] // cfg["num_heads"],
                mlp_hidden=cfg["embed_dim"] * cfg["mlp_ratio"])
    with ctx:
        P = {k: nd.array(v) for k, v in
             init_gpt_params(spec, seed=seed).items()}
        moms = {k: nd.zeros(v.shape) for k, v in P.items()}
        toks = np.random.RandomState(seed + 1).randint(
            0, cfg["vocab_size"], (batch, T + 1))
        tok = nd.array(toks[:, :-1], dtype="int32")
        labels = nd.array(toks[:, 1:], dtype="int32")
    net = GPTDecoder(params={k: v._data for k, v in P.items()},
                     device=ctx.torch_device, **cfg)
    for v in P.values():
        v.attach_grad()
    return net, P, moms, tok, labels


def nd_step_profile(fn):
    """One call of fn() under torch.profiler (host and device, warmed as
    warm_profile does): {kernel: device microseconds}, {kernel: launches
    seen}, and the device microseconds spent under the plain LayerNorm
    backward (LayerNormFunctionBackward's kernels)."""
    from torch.profiler import ProfilerActivity
    ka = warm_profile(fn, 1, [ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]).key_averages()
    cuda = [e for e in ka if on_device(e)]
    ln_bwd = max([e.device_time_total for e in ka
                  if "LayerNormFunctionBackward" in e.key] or [0.0])
    return ({e.key: e.self_device_time_total for e in cuda},
            {e.key: e.count for e in cuda}, ln_bwd)


def host_us(fn, n=2000):
    """Host microseconds per call of fn() in a loop of n (the clock stops
    before the closing synchronise: a launch counts as its enqueue)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def nd_gpt(ops, dev, card, gen):
    """GPT-2-small trained through mx.nd: the Gluon forward
    (GPTDecoder.hybrid_forward on registry ops) under record(), a token
    cross entropy of nd.log_softmax and nd.pick, backward, and
    nd.sgd_mom_update of each of the 148 weights in place; batch 8 x
    1024 tokens, fp32, seeded weights and tokens. A narrow twin (2
    layers, width 64) runs 3 steps on the card and on the CPU first."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.ops import sgd_momentum as sgd_mod
    ctx = mx.gpu(dev.index or 0)

    # the narrow twin, card against CPU
    twin = dict(vocab_size=512, max_seq_len=64, num_layers=2, num_heads=2,
                embed_dim=64, mlp_ratio=4)
    runs = {}
    for where in (ctx, mx.cpu()):
        net, P, moms, tok, labels = nd_gpt_setup(twin, where, 11, 2, 64)
        losses = [float(nd_gpt_step(nd, autograd, net, P, moms, tok,
                                    labels)[0].asscalar())
                  for _ in range(3)]
        runs[where.device_type] = (losses, {k: v.asnumpy()
                                            for k, v in P.items()})
    (lc, pc), (lh, ph) = runs["gpu"], runs["cpu"]
    twin_loss_err = max(abs(a - b) for a, b in zip(lc, lh))
    twin_param_err = max(float(np.abs(pc[k] - ph[k]).max()) for k in ph)
    if not np.isfinite(lc).all() or twin_loss_err > 1e-4 or \
            twin_param_err > 1e-4:
        fail("nd_gpt twin: card vs CPU losses %s vs %s, max param err %g "
             "(tol 1e-4)" % (lc, lh, twin_param_err))

    cfg = GPT2_SMALL
    B, T = ND_GPT["batch"], ND_GPT["T"]
    t0 = time.perf_counter()
    net, P, moms, tok, labels = nd_gpt_setup(cfg, ctx, 0, B, T)
    n_weights = sum(v.size for v in P.values())

    def step():
        return nd_gpt_step(nd, autograd, net, P, moms, tok, labels)

    warm = [float(step()[0].asscalar()) for _ in range(ND_GPT["warm"])]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # the main path, with every launch counter at 0 just before it
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    walls, hosts, bwd_host, losses = [], [], [], []
    for _ in range(ND_GPT["steps"]):
        t = time.perf_counter()
        loss, bwd_ms = step()
        hosts.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss.asscalar()))
        walls.append((time.perf_counter() - t) * 1e3)
        bwd_host.append(bwd_ms)
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = ND_GPT["steps"]
    want = {"layer_norm": 25 * n, "fused_sgd_momentum": 148 * n,
            "flash_attention": 0, "conv1x1_bn_stats": 0}
    if launches != want or len(P) != 148:
        fail("nd_gpt: launches %s over %d steps of %d weights, want %s"
             % (launches, n, len(P), want))
    if not np.isfinite(warm + losses).all():
        fail("nd_gpt: non-finite loss: warm %s, timed %s" % (warm, losses))

    # where a step's device time goes
    kernels, counts, ln_bwd_us = nd_step_profile(step)
    # the 148 updates' device time within that step, when the profiler
    # kept the record of every launch (else None: not measured)
    sgd_keys = [k for k in kernels if "MXNetForm" in k]
    sgd_in_step_ms = (sum(kernels[k] for k in sgd_keys) / 1e3
                      if sum(counts[k] for k in sgd_keys) == len(P)
                      else None)
    by_class = by_kind(kernels, 1, ND_KINDS)
    by_class["plain LayerNorm backward (its kernels, within the "
             "classes above)"] = ln_bwd_us / 1e3
    step_ms = float(np.median(walls))
    device_step_ms = sum(kernels.values()) / 1e3

    # the NDArray layer's dispatch: one small invoke against bare torch
    with ctx:
        a = nd.ones((4, 4))
    ta = a._data
    invoke_us = host_us(lambda: nd.broadcast_add(a, a))
    bare_us = host_us(lambda: torch.add(ta, ta))

    # the kernels at this path's call sites
    ln_row = check_layer_norm(ops, dev, B * T, torch.float32, gen)

    def sgd_loop():
        for k, w in P.items():
            nd.sgd_mom_update(w, w.grad, moms[k], out=w, **ND_SGD)

    ws = [w._data.detach() for w in P.values()]
    gs = [w.grad._data for w in P.values()]
    vs = [m._data for m in moms.values()]
    # the one-tensor update at these shapes (the 50257 x 768 embedding
    # too) against its plain version, on clones of this step's weights,
    # gradients and momenta; the relative error of check_sgd_mxnet
    want = [sgd_mod.sgd_mxnet_plain(w, g, v, **ND_SGD)
            for w, g, v in zip(ws, gs, vs)]
    cw, cg, cm = ([NDArray(t.clone()) for t in ts] for ts in (ws, gs, vs))
    for w, g, v in zip(cw, cg, cm):
        nd.sgd_mom_update(w, g, v, out=w, **ND_SGD)
    torch.cuda.synchronize()
    sgd_err = max(max((w._data - w_new).abs().max().item()
                      / max(1.0, w_new.abs().max().item()),
                      (v._data - v_new).abs().max().item())
                  for w, v, (w_new, v_new) in zip(cw, cm, want))
    sgd_tol = TOL[("sgd_mxnet", torch.float32)]
    if not np.isfinite(sgd_err) or sgd_err > sgd_tol:
        fail("nd_gpt: nd.sgd_mom_update over the %d weights against "
             "sgd_mxnet_plain: max err %g > %g" % (len(P), sgd_err, sgd_tol))
    del want, cw, cg, cm
    params = [torch.nn.Parameter(w.clone()) for w in ws]
    for p_, g in zip(params, gs):
        p_.grad = g.clone()
    opt = torch.optim.SGD(params, lr=ND_SGD["lr"],
                          momentum=ND_SGD["momentum"], dampening=0,
                          weight_decay=ND_SGD["wd"], fused=True)
    opt.step()
    sgd_ms, sgd_lib_ms = paired_ms(sgd_loop, opt.step, iters=5, rounds=3)
    nbytes = 20 * n_weights
    sgd_row = dict(
        tensors=len(P), elements=n_weights, ms=sgd_ms,
        max_abs_err=sgd_err, tol=sgd_tol,
        device_ms=kernel_device_ms(sgd_loop, "MXNetForm", n=1,
                                   launches=len(P)),
        device_ms_in_step=sgd_in_step_ms,
        host_us_per_call=host_us(sgd_loop, n=5) / len(P),
        plain_ms=cuda_ms(lambda: [sgd_mod.sgd_mxnet_plain(
            w, g, v, ND_SGD["lr"], ND_SGD["momentum"], ND_SGD["wd"])
            for w, g, v in zip(ws, gs, vs)], iters=5),
        library_ms=sgd_lib_ms,
        library="fused torch.optim.SGD over the same 148 tensors",
        library_device_ms=device_ms(opt.step, n=3),
        **bound(nbytes, 9 * n_weights, FP32_FLOP_S))

    # C3: backward's host cost with a ResNet-50's parameters alive too
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    r50 = resnet50_v1(layout="NHWC", device=dev)
    r50_params = sum(1 for p_ in r50.collect_params().values()
                     if p_.grad_req != "null")
    with_r50 = []
    for _ in range(2):
        loss, bwd_ms = step()
        float(loss.asscalar())
        with_r50.append(bwd_ms)
    del r50
    emit(phase="nd_gpt", card=card, model="GPT-2-small (12 layers, 12 "
         "heads, width 768, vocab 50257), seeded random weights, trained "
         "through mx.nd (GPTDecoder.hybrid_forward on registry ops)",
         dtype="fp32", batch=B, seq_len=T, weights=len(P),
         weight_elements=n_weights, warm_losses=warm, losses=losses,
         step_ms=step_ms, step_ms_all=walls, host_ms=float(np.median(hosts)),
         device_ms=device_step_ms,
         device_busy_share=device_step_ms / step_ms,
         tokens_s=B * T / (step_ms / 1e3), peak_mem_gb=peak_gb,
         setup_s=setup_s, launches=launches,
         device_ms_by_class=by_class,
         top_device_ms=breakdown(kernels, 1, step_ms, 10)["top_device_ms"],
         invoke_host_us=invoke_us, bare_torch_add_host_us=bare_us,
         invoke_overhead_us=invoke_us - bare_us,
         backward_host_ms=float(np.median(bwd_host)),
         backward_host_ms_with_resnet50=float(np.median(with_r50)),
         resnet50_params_alive=r50_params,
         twin=dict(losses_card=lc, losses_cpu=lh,
                   loss_max_abs_err=twin_loss_err,
                   param_max_abs_err=twin_param_err, tol=1e-4),
         layer_norm_row=ln_row, sgd_one_tensor=sgd_row)
    return dict(launches=launches, ln_row=ln_row, sgd_row=sgd_row)


# ---------------------------------------------------------------------------
# phases 14-16: Gluon breadth
# ---------------------------------------------------------------------------
CIFAR_SCRIPT = os.path.join("tools", "torch_train_cifar10.py")
CIFAR_STEPS = 32                # 2 epochs of 2048 images at batch 128
ZOO = dict(model="mobilenet1.0", workers=4, warm=1)
ZOO_TWIN = dict(model="mobilenet0.25", batch=16, img=128, steps=2,
                lr=1e-3)


def _load_script(path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_train_cifar10", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loader_batches(loader):
    return [[b.astorch().clone() for b in batch] for batch in loader]


def gluon_cifar(ops, dev, card):
    """example/gluon/train_cifar10.py as published, through its port copy
    (tools/torch_train_cifar10.py: the imports are the only change), on
    the card: resnet18_v1, SGD lr 0.1 momentum 0.9 wd 1e-4, batch 128,
    2 epochs over the 2048 synthetic images. The script's own assert,
    one MXNet-form fused_sgd_momentum launch a step, and batches of a
    shuffled DataLoader at 2 workers equal to those at 0 under one seed.
    Returns the launch counts of the script's run."""
    import contextlib
    import gc
    import io
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    gc.collect()
    torch.cuda.empty_cache()
    script = _load_script(CIFAR_SCRIPT)
    stamps = []
    real_step = Trainer.step

    def stamped(self, *args, **kwargs):
        real_step(self, *args, **kwargs)
        stamps.append(time.perf_counter())

    out = io.StringIO()
    argv = sys.argv
    with tempfile.TemporaryDirectory() as tmp:
        sys.argv = [CIFAR_SCRIPT, "--data-dir", os.path.join(tmp, "none")]
        Trainer.step = stamped
        torch.cuda.reset_peak_memory_stats()
        # the main path, with every launch counter at 0 just before it
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                script.main()
        except AssertionError as e:
            fail("gluon_cifar: the example's assert failed: %s\n%s"
                 % (e, out.getvalue()))
        finally:
            Trainer.step = real_step
            sys.argv = argv
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lines = out.getvalue().splitlines()
    if lines[-1:] != ["CIFAR_EXAMPLE_OK"] or len(stamps) != CIFAR_STEPS:
        fail("gluon_cifar: %d steps, output %s" % (len(stamps), lines))
    if launches["fused_sgd_momentum"] != CIFAR_STEPS or \
            launches["conv1x1_bn_stats"]:
        fail("gluon_cifar: launches %s over %d steps, want one "
             "fused_sgd_momentum a step and no conv1x1 (NCHW)"
             % (launches, CIFAR_STEPS))
    gaps = np.diff(stamps)
    steady = stamps[-1] - stamps[0]
    # the update is MXNet's form of the SGD kernel
    mx.random.seed(0)
    net = get_model("resnet18_v1", classes=10)
    net.initialize(mx.init.Xavier())
    trainer = Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x = torch.randn(128, 3, 32, 32, device=dev)
    y = torch.randint(0, 10, (128,), device=dev).float()
    sgd = kernels_seen(lambda: gluon_loop(net, trainer, loss_fn, x, y),
                       "sgd_momentum_kernel", "MXNetForm")
    if not any("MXNetForm" in k for k in sgd):
        fail("gluon_cifar: the step's SGD kernels were %s, want "
             "sgd_momentum_kernel<MXNetForm>" % sgd)
    # batches of a shuffled DataLoader: 2 workers against none
    rng = np.random.RandomState(0)
    data = ArrayDataset(rng.randn(2048, 3, 32, 32).astype("float32"),
                        rng.randint(0, 10, 2048).astype("float32"))
    got = {}
    for workers in (0, 2):
        loader = DataLoader(data, batch_size=128, shuffle=True,
                            last_batch="discard", num_workers=workers)
        np.random.seed(7)
        got[workers] = loader_batches(loader)
        del loader
    gc.collect()
    same = len(got[0]) == len(got[2]) == 16 and all(
        torch.equal(a, b) for ba, bb in zip(got[0], got[2])
        for a, b in zip(ba, bb))
    on_card = all(b.device.type == "cuda" for batch in got[2] for b in batch)
    if not (same and on_card):
        fail("gluon_cifar: DataLoader batches at 2 workers equal to 0 "
             "workers: %s, on the card: %s" % (same, on_card))
    emit(phase="gluon_cifar", card=card, script=CIFAR_SCRIPT,
         model="resnet18_v1, NCHW, fp32, Xavier", batch=128,
         steps=len(stamps), output=lines, wall_s=wall,
         img_s=128 * (len(stamps) - 1) / steady,
         step_ms=float(np.median(gaps)) * 1e3,
         step_ms_p90=percentile(gaps, 90) * 1e3, peak_mem_gb=peak_gb,
         launches=launches, sgd_kernels=[k[:120] for k in sgd],
         loader_workers_2_equal_0=same)
    return launches


def loader_fp32(n_batches=4):
    """The DataLoader alone as a Gluon user feeds ImageNet-sized images:
    uint8 HWC NDArrays on the CPU through `transform_first(ToTensor,
    Normalize)` in 4 workers, which pickle fp32 CHW batches of BATCH to
    the parent, pinned and copied to the card. Returns (img/s over
    `n_batches` after a first one, the first batch's ms)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.data.vision import transforms
    rng = np.random.default_rng(1)
    n = 2 * BATCH
    data = ArrayDataset(
        mx.nd.array(rng.integers(0, 256, (n, IMG, IMG, 3), np.uint8),
                    ctx=mx.cpu(), dtype="uint8"),
        (rng.random(n) * 1000).astype("float32"))
    tf = transforms.Compose([
        transforms.ToTensor(),
        transforms.Normalize((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))])
    draws = [rng.permutation(n)[:BATCH].tolist()
             for _ in range(n_batches + 1)]
    loader = DataLoader(data.transform_first(tf), batch_sampler=draws,
                        num_workers=ZOO["workers"], pin_memory=True)
    t0 = time.perf_counter()
    feed = iter(loader)
    first = next(feed)[0]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for xb, _ in feed:
        if xb.shape != first.shape or xb.dtype != np.float32:
            fail("zoo_train: the fp32 loader gave %s %s, want %s float32"
                 % (xb.shape, xb.dtype, first.shape))
    torch.cuda.synchronize()
    return BATCH * n_batches / (time.perf_counter() - t1), (t1 - t0) * 1e3


def zoo_train(ops, dev, card, gen, per):
    """MobileNet-1.0 (get_model, NHWC) trained at 224x224, batch 128,
    with the gluon_train recipe: net.cast("bfloat16"), multi_precision
    SGD lr 0.1 momentum 0.9 wd 1e-4; batches from a seeded synthetic
    ArrayDataset through DataLoader(num_workers=4, pin_memory=True). 1
    warm-up and 10 timed steps: finite, falling losses, 13
    conv1x1_bn_stats launches a forward, one SGD launch a step; a narrow
    twin card against CPU. The images are uint8, cast to bf16 on the
    card. `per`: the kernel at MobileNet's 9 pointwise shapes (13 calls),
    held against its plain version and timed in the kernel phase (before
    the training phases' long profiles leave the profiler dropping
    records). Returns (launches, `per` with the kernel's device ms inside
    the profiled step)."""
    import gc
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.observability import registry
    zoo_twin(ops, dev)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mx.random.seed(0)
    net = get_model(ZOO["model"], layout="NHWC")
    net.initialize()            # Gluon's default: Uniform(0.07)
    net.cast("bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
        "multi_precision": True})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    # uint8 HWC images, as decoded image data is, 2 batches' worth; one
    # pass of the batch sampler draws every step of the phase (warm,
    # timed, the one-step timing and the profile) from them, so the
    # loader's pipeline never restarts and the net can fit the labels
    rng = np.random.default_rng(0)
    n = 2 * BATCH
    data = ArrayDataset(rng.integers(0, 256, (n, IMG, IMG, 3), np.uint8),
                        (rng.random(n) * 1000).astype("float32"))
    draws = [rng.permutation(n)[:BATCH].tolist()
             for _ in range(ZOO["warm"] + TRAIN_STEPS + 2)]
    loader = DataLoader(data, batch_sampler=draws,
                        num_workers=ZOO["workers"], pin_memory=True)
    feed = iter(loader)
    waits = []

    def step():
        t = time.perf_counter()
        xb, yb = next(feed)
        waits.append(time.perf_counter() - t)
        with autograd.record():
            loss = loss_fn(net(xb.astype("bfloat16") * (1.0 / 255)), yb)
        loss.backward()
        trainer.step(BATCH)
        return loss.astorch().detach().float().mean()

    warm = torch.stack([step() for _ in range(ZOO["warm"])]).cpu().numpy()
    setup_s = time.perf_counter() - t0
    del waits[:]
    groups = registry.counter("optimizer.fused.groups")
    groups0 = groups.get()
    torch.cuda.reset_peak_memory_stats()
    # the main path, with every launch counter at 0 just before it
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = torch.stack([step() for _ in range(TRAIN_STEPS)]).cpu().numpy()
    wall = time.perf_counter() - t0
    loader_wait_ms = sum(waits) / len(waits) * 1e3
    launches = ops.launch_counts()
    sgd_groups = groups.get() - groups0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not (np.isfinite(warm).all() and np.isfinite(losses).all()):
        fail("zoo_train: non-finite loss: warm %s, timed %s"
             % (warm, losses))
    if not losses[-1] < warm[0]:
        fail("zoo_train: loss did not fall: first %g, last %g"
             % (warm[0], losses[-1]))
    if launches["conv1x1_bn_stats"] != 13 * TRAIN_STEPS or \
            launches["fused_sgd_momentum"] != sgd_groups or \
            sgd_groups != TRAIN_STEPS:
        fail("zoo_train: launches %s and %d SGD groups over %d steps, "
             "want 13 conv1x1_bn_stats a step and one fused_sgd_momentum "
             "launch a step" % (launches, sgd_groups, TRAIN_STEPS))
    # where one step's time goes
    t = time.perf_counter()
    step().cpu()
    one_step_ms = (time.perf_counter() - t) * 1e3
    events = device_events(lambda: step().cpu(), 1)
    dev_us = {k: us for k, (us, _) in events.items()}
    profile = breakdown(dev_us, 1, one_step_ms, top_n=12)
    profile["device_ms_by_kind"] = by_kind(dev_us, 1)
    profile["conv1x1_kernels"] = {k[:90]: c for k, (_, c) in events.items()
                                  if "conv1x1_" in k}
    del feed, loader, data
    gc.collect()
    n_params = sum(p.data().numel() for p in net.collect_params().values()
                   if p.grad_req != "null")
    img_s = BATCH * TRAIN_STEPS / wall
    fp32_img_s, fp32_first_ms = loader_fp32()
    emit(phase="zoo_train", card=card, model="%s, NHWC, seeded random "
         "weights (net.initialize(): Uniform 0.07)" % ZOO["model"],
         params=n_params, batch=BATCH, image=IMG,
         dtype="net.cast(bfloat16), multi_precision (fp32 masters)",
         loader="ArrayDataset of %d seeded uint8 images, DataLoader("
         "num_workers=%d, pin_memory=True), a seeded batch sampler of %d "
         "batches; cast to bf16 / 255 on the card"
         % (n, ZOO["workers"], len(draws)),
         loader_wait_ms_per_step=loader_wait_ms,
         loader_alone_fp32_img_s=fp32_img_s,
         loader_alone_fp32_first_batch_ms=fp32_first_ms,
         loader_alone_fp32="uint8 NDArrays on the CPU, transform_first("
         "ToTensor, Normalize) in %d workers, fp32 CHW batches pickled, "
         "pinned, to the card" % ZOO["workers"],
         steps=TRAIN_STEPS, warm_steps=ZOO["warm"], img_s=img_s,
         step_ms=wall / TRAIN_STEPS * 1e3, wall_s=wall, peak_mem_gb=peak_gb,
         setup_s=setup_s, losses_warm=warm.tolist(), losses=losses.tolist(),
         launches=launches, sgd_groups=sgd_groups, profile_one_step=profile)
    # the kernel's device time inside the profiled training step, where
    # the profiler saw the forward's 13 launches
    seen = sum(profile["conv1x1_kernels"].values())
    per["device_ms_in_step"] = profile["device_ms_by_kind"].get(
        "conv1x1_bn_stats") if seen == 13 else None
    return launches, per


def zoo_twin(ops, dev):
    """mobilenet0.25 at 128x128, batch 16, fp32, 2 SGD steps (lr 1e-3,
    momentum 0.9, wd 1e-4) through gluon.Trainer on the card and on the
    CPU from the same seeded weights, each step from the same state:
    before step 2 the CPU net and trainer load the card's parameters and
    optimizer states (`save_parameters`, `save_states`). Losses within
    1e-4 and weights within 1e-3 after each step.

    Why this size, lr and per-step state (PERF.md section 6, and
    tools/torch_twin_probe.py): a ReLU input within the forward's fp32
    rounding of 0 lands on the other side on the card, a step-sized
    change of one gradient element that its BatchNorm spreads over the
    channel. At lr 0.1 the first update is up to 68x a weight, so one
    such element moves the first step's weights by 0.04 and the second
    step runs from another state. In float64 the card and the CPU agree
    to 1e-15 over both steps."""
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    c = ZOO_TWIN
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(c["batch"], c["img"], c["img"], 3)
                         .astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, c["batch"]).astype(np.float32))
    sides = []
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            mx.random.seed(3)
            net = get_model(c["model"], classes=10, layout="NHWC")
            net.initialize(mx.init.Xavier())
            net(x[:1].to(ctx.torch_device))   # deferred shapes: draw now
            trainer = mx.gluon.Trainer(net.collect_params(), "sgd", {
                "learning_rate": c["lr"], "momentum": 0.9, "wd": 1e-4})
            sides.append((ctx, net, trainer, x.to(ctx.torch_device),
                          y.to(ctx.torch_device)))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    (_, cnet, ctrainer, _, _), (_, hnet, htrainer, _, _) = sides

    def weights(net):
        return {k: p.data().detach().float().cpu().clone()
                for k, p in net._collect_params_with_prefix().items()}

    ops.reset_launch_counts()
    lc, lh, loss_err, param_err = [], [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(c["steps"]):
            if k:
                cnet.save_parameters(os.path.join(tmp, "p"))
                ctrainer.save_states(os.path.join(tmp, "s"))
                with mx.cpu():
                    hnet.load_parameters(os.path.join(tmp, "p"),
                                         ctx=mx.cpu())
                    htrainer.load_states(os.path.join(tmp, "s"))
            losses = []
            for ctx, net, trainer, xs, ys in sides:
                with ctx:
                    losses.append(float(gluon_loop(net, trainer, loss_fn,
                                                   xs, ys)))
            lc.append(losses[0])
            lh.append(losses[1])
            wc, wh = weights(cnet), weights(hnet)
            loss_err.append(abs(lc[-1] - lh[-1]))
            param_err.append(max((wc[n] - wh[n]).abs().max().item()
                                 for n in wh))
    launches = ops.launch_counts()
    loss_tol, param_tol = 1e-4, 1e-3
    if not np.isfinite(lc).all() or max(loss_err) > loss_tol or \
            max(param_err) > param_tol:
        fail("zoo_train twin: card vs CPU losses %s vs %s (max abs err by "
             "step %s, tolerance %g), max weight err by step %s "
             "(tolerance %g)" % (lc, lh, loss_err, loss_tol, param_err,
                                 param_tol))
    if launches["conv1x1_bn_stats"] != 13 * c["steps"] or \
            launches["fused_sgd_momentum"] != c["steps"]:
        fail("zoo_train twin: launches %s over %d card steps, want 13 "
             "conv1x1_bn_stats and one fused_sgd_momentum a step, none "
             "on the CPU" % (launches, c["steps"]))
    emit(phase="zoo_twin", config=c, losses_card=lc, losses_cpu=lh,
         loss_max_abs_err=loss_err, param_max_abs_err=param_err,
         loss_tol=loss_tol, param_tol=param_tol, launches=launches)


def _layer_cases(g):
    """(name, constructor, input shape, recorded?) of the layer sweep:
    every gluon.nn class of the port, both layouts where they exist."""
    def stack(cls):
        net = cls()
        with net.name_scope():
            net.add(g.nn.Dense(6, activation="relu"), g.nn.Dense(3))
        return net

    def conv_bn():
        net = g.nn.HybridSequential()
        with net.name_scope():
            net.add(g.nn.Conv2D(5, 1, layout="NHWC"),
                    g.nn.BatchNorm(axis=3), g.nn.Activation("relu"))
        return net

    return [
        ("Dense", lambda: g.nn.Dense(5, activation="tanh"), (4, 3, 2)),
        ("Dense_no_flatten", lambda: g.nn.Dense(5, flatten=False),
         (2, 3, 4)),
        ("Activation", lambda: g.nn.Activation("softrelu"), (3, 5)),
        ("BatchNorm", lambda: g.nn.BatchNorm(), (4, 3, 5, 5)),
        ("BatchNorm_nhwc", lambda: g.nn.BatchNorm(axis=3), (2, 3, 3, 4)),
        ("Embedding", lambda: g.nn.Embedding(10, 4), "indices"),
        ("InstanceNorm", lambda: g.nn.InstanceNorm(scale=True),
         (2, 3, 5, 4)),
        ("LayerNorm", lambda: g.nn.LayerNorm(), (4, 64)),
        ("Flatten", lambda: g.nn.Flatten(), (2, 3, 4)),
        ("LeakyReLU", lambda: g.nn.LeakyReLU(0.1), (3, 5)),
        ("PReLU", lambda: g.nn.PReLU(), (3, 5)),
        ("ELU", lambda: g.nn.ELU(0.7), (3, 5)),
        ("SELU", lambda: g.nn.SELU(), (3, 5)),
        ("Swish", lambda: g.nn.Swish(1.5), (3, 5)),
        ("GELU", lambda: g.nn.GELU(), (3, 5)),
        ("Conv1D", lambda: g.nn.Conv1D(4, 3, strides=2, padding=1),
         (2, 3, 9)),
        ("Conv2D", lambda: g.nn.Conv2D(4, 3, padding=1), (2, 3, 6, 6)),
        ("Conv2D_nhwc", lambda: g.nn.Conv2D(4, 3, padding=1, groups=2,
                                            layout="NHWC"), (2, 5, 5, 4)),
        ("Conv3D", lambda: g.nn.Conv3D(3, 2), (1, 2, 4, 4, 4)),
        ("Conv3D_ndhwc", lambda: g.nn.Conv3D(3, 2, layout="NDHWC"),
         (1, 4, 4, 4, 2)),
        ("Conv1DTranspose", lambda: g.nn.Conv1DTranspose(
            3, 3, strides=2, padding=1, output_padding=1), (2, 2, 5)),
        ("Conv2DTranspose", lambda: g.nn.Conv2DTranspose(3, 3, strides=2),
         (1, 2, 4, 4)),
        ("Conv3DTranspose", lambda: g.nn.Conv3DTranspose(2, 2),
         (1, 2, 3, 3, 3)),
        ("MaxPool1D", lambda: g.nn.MaxPool1D(3, 2, ceil_mode=True),
         (2, 3, 8)),
        ("MaxPool2D", lambda: g.nn.MaxPool2D(3, 2, 1), (1, 2, 6, 6)),
        ("MaxPool2D_nhwc", lambda: g.nn.MaxPool2D(3, 2, ceil_mode=True,
                                                  layout="NHWC"),
         (1, 6, 6, 2)),
        ("MaxPool3D", lambda: g.nn.MaxPool3D(2, layout="NDHWC"),
         (1, 4, 4, 4, 2)),
        ("AvgPool1D", lambda: g.nn.AvgPool1D(3, 1, 1,
                                             count_include_pad=False),
         (2, 3, 7)),
        ("AvgPool2D", lambda: g.nn.AvgPool2D(2, layout="NHWC"),
         (1, 4, 4, 3)),
        ("AvgPool3D", lambda: g.nn.AvgPool3D(2, ceil_mode=True),
         (1, 2, 5, 5, 5)),
        ("GlobalMaxPool1D", lambda: g.nn.GlobalMaxPool1D(), (2, 3, 7)),
        ("GlobalMaxPool2D", lambda: g.nn.GlobalMaxPool2D(layout="NHWC"),
         (2, 4, 4, 3)),
        ("GlobalMaxPool3D", lambda: g.nn.GlobalMaxPool3D(),
         (1, 2, 3, 3, 3)),
        ("GlobalAvgPool1D", lambda: g.nn.GlobalAvgPool1D(), (2, 3, 7)),
        ("GlobalAvgPool2D", lambda: g.nn.GlobalAvgPool2D(), (2, 3, 4, 4)),
        ("GlobalAvgPool3D", lambda: g.nn.GlobalAvgPool3D(layout="NDHWC"),
         (1, 3, 3, 3, 2)),
        ("ReflectionPad2D", lambda: g.nn.ReflectionPad2D(2), (1, 2, 5, 5)),
        ("Sequential", lambda: stack(g.nn.Sequential), (3, 4)),
        ("HybridSequential_conv1x1_bn", conv_bn, (2, 4, 4, 3)),
        ("HybridConcurrent", lambda: _concurrent(g), (2, 3)),
        ("Lambda", lambda: g.nn.Lambda("tanh"), (3, 4)),
        ("HybridLambda", lambda: g.nn.HybridLambda(
            lambda F, x: F.relu(x) * 2), (3, 4)),
    ]


def _concurrent(g):
    net = g.contrib.nn.HybridConcurrent(axis=1)
    with net.name_scope():
        net.add(g.nn.Dense(3), g.contrib.nn.Identity())
    return net


def _loss_cases(g):
    """(name, loss, pred shape, label maker) of the loss sweep: all 12."""
    L = g.loss
    dense = lambda r, s: r.rand(*s)                 # noqa: E731
    sign = lambda r, s: np.sign(r.randn(*s))        # noqa: E731
    binary = lambda r, s: r.randint(0, 2, s)        # noqa: E731
    classes = lambda r, s: r.randint(0, s[1], s[0])  # noqa: E731
    return [
        ("L2Loss", L.L2Loss(), (4, 3), dense),
        ("L1Loss", L.L1Loss(weight=0.5), (4, 3), dense),
        ("SigmoidBCELoss", L.SigmoidBCELoss(), (4, 3), binary),
        ("SoftmaxCELoss", L.SoftmaxCELoss(), (4, 5), classes),
        ("KLDivLoss", L.KLDivLoss(from_logits=False), (4, 5), dense),
        ("HuberLoss", L.HuberLoss(rho=0.7), (4, 3), dense),
        ("HingeLoss", L.HingeLoss(), (4, 3), sign),
        ("SquaredHingeLoss", L.SquaredHingeLoss(), (4, 3), sign),
        ("LogisticLoss", L.LogisticLoss(), (4, 3), sign),
        ("TripletLoss", L.TripletLoss(margin=0.5), (4, 6), "triplet"),
        ("CTCLoss", L.CTCLoss(), (3, 7, 5), "ctc"),
    ]


def _run_layer(mx, layer, x, head, ctx):
    """(output, input gradient, {block path: weight gradient}) of one
    recorded forward and backward."""
    from mxnet_tpu_torch import autograd, nd
    with ctx:
        xa = nd.array(x, dtype=x.dtype)
        grad = x.dtype == np.float32
        if grad:
            xa.attach_grad()
        with autograd.record():
            y = layer(xa)
        y.backward(nd.array(head))
        grads = {k: p.grad().detach().float().cpu()
                 for k, p in layer._collect_params_with_prefix().items()
                 if p.grad_req != "null"}
        return (y.astorch().detach().float().cpu(),
                xa.grad.astorch().float().cpu() if grad else None, grads)


def gluon_layers(ops, dev, card, gen):
    """Every gluon.nn class of the port and every loss, forward and
    backward on the card against the same block on the CPU (the same
    weights, by block path); gluon.nn.LayerNorm at (8192, 768) fp32 on
    the layer_norm kernel, one launch a forward, held against its plain
    version and timed; one forward of each zoo family's smallest member
    (Inception V3 at 299 px), card against CPU. Returns the LayerNorm
    row."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    tol = 1e-4
    errs, rng = {}, np.random.RandomState(5)
    for name, make, shape in _layer_cases(gluon):
        x = (rng.randint(0, 10, (3, 4)).astype(np.float32)
             if shape == "indices" else rng.randn(*shape).astype(np.float32))
        nets = []
        for ctx in (mx.cpu(), mx.gpu(0)):
            with ctx:
                nets.append(make())
        cpu_net, card_net = nets
        with mx.cpu():
            cpu_net.initialize(mx.init.Uniform(0.5))
            probe = cpu_net(nd.array(x))
        card_net.load_parameters(
            {k: p.data().detach() for k, p in
             cpu_net._collect_params_with_prefix().items()}, ctx=mx.gpu(0))
        head = rng.randn(*probe.shape).astype(np.float32)
        a = _run_layer(mx, cpu_net, x, head, mx.cpu())
        b = _run_layer(mx, card_net, x, head, mx.gpu(0))
        scale = max(1.0, a[0].abs().max().item())
        err = (a[0] - b[0]).abs().max().item() / scale
        if a[1] is not None:
            err = max(err, (a[1] - b[1]).abs().max().item() / scale)
        for k in a[2]:
            err = max(err, (a[2][k] - b[2][k]).abs().max().item() /
                      max(1.0, a[2][k].abs().max().item()))
        if not np.isfinite(err) or err > tol or a[2].keys() != b[2].keys():
            fail("gluon_layers: %s card vs CPU err %g > %g" % (name, err,
                                                              tol))
        errs[name] = err
    # Dropout: the identity outside record(), the kept share inside
    with mx.gpu(0):
        drop = gluon.nn.Dropout(0.25)
        ones = nd.ones((512, 512))
        same = bool((drop(ones) == ones).astorch().all())
        with autograd.record():
            kept = float((drop(ones) != 0).astorch().float().mean())
    if not same or abs(kept - 0.75) > 0.01:
        fail("gluon_layers: Dropout(0.25) identity %s, kept share %g"
             % (same, kept))
    dropout = dict(identity_outside_record=same, kept_share=kept,
                   kept_share_tol=0.01)
    # the losses
    loss_errs = {}
    for name, loss, shape, labels in _loss_cases(gluon):
        r = np.random.RandomState(6)
        pred = r.randn(*shape).astype(np.float32)
        if labels == "triplet":
            extra = [r.randn(*shape).astype(np.float32) for _ in range(2)]
        elif labels == "ctc":
            extra = [np.array([[1, 2, 2, 0], [3, 0, 0, 0], [4, 1, 3, 2]],
                              np.float32)]
        else:
            extra = [np.asarray(labels(r, shape), np.float32)]
        out = []
        for ctx in (mx.cpu(), mx.gpu(0)):
            with ctx:
                p = nd.array(pred)
                p.attach_grad()
                with autograd.record():
                    v = loss(p, *[nd.array(e) for e in extra])
                v.backward()
                out.append((v.astorch().float().cpu(),
                            p.grad.astorch().float().cpu()))
        err = max((u - w).abs().max().item() / max(1.0, u.abs().max().item())
                  for u, w in zip(*out))
        if not np.isfinite(err) or err > tol:
            fail("gluon_layers: %s card vs CPU err %g > %g" % (name, err,
                                                              tol))
        loss_errs[name] = err
    # gluon.nn.LayerNorm on the kernel, at nd_gpt's rows
    rows, width = 8192, 768
    with mx.gpu(0):
        ln = gluon.nn.LayerNorm(in_channels=width)
        ln.initialize()
    x = torch.randn(rows, width, generator=gen, device=dev) * 3 + 1
    ops.reset_launch_counts()
    y = ln(x)
    torch.cuda.synchronize()
    ln_launches = ops.launch_counts()["layer_norm"]
    want = ops.layer_norm_plain(x, ln.gamma, ln.beta, 1e-5)
    ln_err = (y - want).abs().max().item()
    if ln_launches != 1 or ln_err > TOL[("layer_norm", torch.float32)]:
        fail("gluon_layers: gluon.nn.LayerNorm (%d, %d): %d layer_norm "
             "launches, err %g" % (rows, width, ln_launches, ln_err))
    ln_row = check_layer_norm(ops, dev, rows, torch.float32, gen)
    ln_row.update(launches=ln_launches, layer_ms=cuda_ms(lambda: ln(x)),
                  layer_max_abs_err=ln_err)
    emit(phase="kernel_gluon_layernorm", card=card, **ln_row)
    # one forward of each zoo family's smallest member
    zoo_errs = {}
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    for name, side in (("resnet18_v1", 64), ("resnet18_v2", 64),
                       ("vgg11_bn", 32), ("alexnet", 64),
                       ("squeezenet1.1", 64), ("densenet121", 224),
                       ("inceptionv3", 299), ("mobilenet0.25", 64),
                       ("mobilenetv2_0.25", 64)):
        x = np.random.RandomState(8).randn(2, 3, side, side) \
            .astype(np.float32)
        with mx.cpu():
            mx.random.seed(8)
            cpu_net = get_model(name, classes=10)
            cpu_net.initialize(mx.init.Xavier())
            want = cpu_net(nd.array(x)).astorch()
        with mx.gpu(0):
            card_net = get_model(name, classes=10)
            card_net.load_parameters(
                {k: p.data().detach() for k, p in
                 cpu_net._collect_params_with_prefix().items()})
            got = card_net(nd.array(x)).astorch().cpu()
        err = (got - want).abs().max().item() / max(1.0, want.abs().max()
                                                    .item())
        if not np.isfinite(err) or err > tol or got.shape != (2, 10):
            fail("gluon_layers: %s card vs CPU logits err %g > %g"
                 % (name, err, tol))
        zoo_errs[name] = err
    emit(phase="gluon_layers", card=card, layers=len(errs) + 1,
         losses=len(loss_errs), zoo=len(zoo_errs), tol=tol,
         layer_max_err=max(errs.values()), loss_max_err=max(
             loss_errs.values()), zoo_max_err=max(zoo_errs.values()),
         layer_errs=errs, dropout=dropout, loss_errs=loss_errs,
         zoo_errs=zoo_errs,
         layernorm=dict(shape=[rows, width], launches=ln_launches,
                        max_abs_err=ln_err))
    return ln_row


# ---------------------------------------------------------------------------
# phases 17-22: Symbol, the executor, CachedOp and the Module API
# ---------------------------------------------------------------------------
RESNET_SYMBOL = os.path.join("tools", "torch_resnet_symbol.py")
MNIST_SCRIPT = os.path.join("tools", "torch_train_mnist.py")
MNIST_EPOCHS = 10
MODULE_WARM = 2
HYBRID = dict(windows=2, steps=5)
SCORE_BATCH = 32


def _step_losses():
    """A batch-end callback that keeps each batch's metric value and
    resets the metric: per-step cross-entropy out of Module.fit."""
    losses = []

    def cb(param):
        losses.append(param.eval_metric.get()[1])
        param.eval_metric.reset()
    return losses, cb


def module_small(dev):
    """A narrow NHWC ResNet V1 symbol (tools/torch_resnet_symbol.py,
    units [1, 1], widths [16, 32, 64], 10 classes) through Module.fit:
    b8 at 32 px, fp32, 3 SGD steps, on the card and on the CPU from the
    same seeded parameters: per-step losses, parameters and aux states
    agree, and the card ran 6 conv1x1_bn_stats launches a step and one
    fused_sgd_momentum launch a step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.observability import registry
    groups = registry.counter("optimizer.fused.groups")
    resnet_v1_symbol = _load_script(RESNET_SYMBOL).resnet_v1_symbol
    rng = np.random.RandomState(2)
    x = rng.randn(24, 32, 32, 3).astype(np.float32)
    y = (np.arange(24) % 10).astype(np.float32)
    init = None
    runs = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        with mx.name.NameManager():
            sym = resnet_v1_symbol(mx, units=(1, 1), filters=(16, 32, 64),
                                   num_classes=10)
        it = mx.io.NDArrayIter(x, y, batch_size=8)
        mod = mx.mod.Module(sym, context=ctx)
        mod.bind(it.provide_data, it.provide_label)
        if init is None:
            mx.random.seed(3)
            mod.init_params(mx.init.Xavier(magnitude=2.0))
            init = tuple({k: v.copy() for k, v in d.items()}
                         for d in mod.get_params())
        else:
            mod.init_params(arg_params=init[0], aux_params=init[1])
        losses, cb = _step_losses()
        groups0 = groups.get()
        ops.reset_launch_counts()
        mod.fit(it, num_epoch=1, eval_metric="ce", batch_end_callback=cb,
                optimizer="sgd", optimizer_params={
                    "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
        args, auxs = mod.get_params()
        runs.append((losses, args, auxs, ops.launch_counts(),
                     groups.get() - groups0))
    (lh, ah, xh, nh, _), (lc, ac, xc, nc, sgd_groups) = runs
    loss_err = max(abs(a - b) for a, b in zip(lc, lh))
    param_err = max(np.abs(ac[k].asnumpy() - ah[k].asnumpy()).max()
                    for k in ah)
    aux_err = max(np.abs(xc[k].asnumpy() - xh[k].asnumpy()).max()
                  for k in xh)
    loss_tol, param_tol = 1e-4, 1e-3
    if len(lc) != 3 or not np.isfinite(lc).all() or loss_err > loss_tol \
            or param_err > param_tol or aux_err > param_tol:
        fail("module_small: card vs CPU losses %s vs %s, max param err %g, "
             "aux err %g (tol %g, %g)" % (lc, lh, param_err, aux_err,
                                          loss_tol, param_tol))
    # per forward: stage 1's and stage 2's a, c and shortcut pairs; one
    # SGD launch per group the FusedUpdater forms (Module gives biases
    # and betas no weight decay: two groups a step)
    if nc["conv1x1_bn_stats"] != 6 * 3 or \
            nc["fused_sgd_momentum"] != sgd_groups or sgd_groups < 3 or \
            any(nh.values()):
        fail("module_small: launches card %s (%d SGD groups), CPU %s; want "
             "18 conv1x1_bn_stats and one fused_sgd_momentum per SGD group "
             "on the card, none on the CPU" % (nc, sgd_groups, nh))
    emit(phase="module_small", losses_card=lc, losses_cpu=lh,
         loss_max_abs_err=loss_err, param_max_abs_err=float(param_err),
         aux_max_abs_err=float(aux_err), loss_tol=loss_tol,
         param_tol=param_tol, launches=nc, sgd_groups=sgd_groups)


def _resnet50_symbol(mx, dev):
    """resnet50_v1(classes=1000, layout="NHWC") traced to a Symbol, with
    a SoftmaxOutput head."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    with mx.name.NameManager():
        net = resnet50_v1(classes=1000, layout="NHWC", device=dev)
        out = net(mx.sym.var("data"))
        return net, mx.sym.SoftmaxOutput(out, name="softmax")


def module_train(dev, card):
    """ResNet-50 v1 traced to a Symbol and trained through Module.fit:
    b128 at 224 px, fp32 (TF32 off), SGD lr 0.1 momentum 0.9 wd 1e-4,
    over a seeded synthetic NDArrayIter of 12 batches: 2 warm steps and
    10 timed. Returns the launch counts of the 12 steps."""
    import gc
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import ops
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, sym = _resnet50_symbol(mx, dev)
    n_steps = MODULE_WARM + TRAIN_STEPS
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH * n_steps, IMG, IMG, 3),
                            dtype=np.float32)
    y = rng.integers(0, 1000, BATCH * n_steps).astype(np.float32)
    it = mx.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mx.random.seed(0)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    n_params = sum(int(np.prod(a[0].shape))
                   for a in mod._exec_group.param_arrays)
    setup_s = time.perf_counter() - t0
    losses, cb = _step_losses()
    stamps = []
    torch.cuda.reset_peak_memory_stats()
    # the main path, with every launch counter at 0 just before it
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, eval_metric="ce",
            batch_end_callback=[cb, lambda _: stamps.append(
                time.perf_counter())],
            optimizer="sgd", optimizer_params={
                "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len(losses) != n_steps or not np.isfinite(losses).all():
        fail("module_train: %d steps, losses %s" % (len(losses), losses))
    if launches["conv1x1_bn_stats"] != 36 * n_steps or \
            launches["fused_sgd_momentum"] != n_steps:
        fail("module_train: launches %s over %d steps, want 36 "
             "conv1x1_bn_stats and 1 fused_sgd_momentum a step"
             % (launches, n_steps))
    timed = stamps[-1] - stamps[MODULE_WARM - 1]
    gaps = np.diff(stamps[MODULE_WARM - 1:])
    # where one step's time goes
    batch = next(iter(it))

    def step():
        mod.forward_backward(batch)
        mod.update()
        mod.get_outputs()[0].asnumpy()
    step()
    t = time.perf_counter()
    step()
    one_step_ms = (time.perf_counter() - t) * 1e3
    events = device_events(step, 1)
    dev_us = {k: us for k, (us, _) in events.items()}
    profile = breakdown(dev_us, 1, one_step_ms, top_n=12)
    profile["device_ms_by_kind"] = by_kind(dev_us, 1)
    profile["conv1x1_kernels"] = {k[:90]: c for k, (_, c) in events.items()
                                  if "conv1x1_" in k}
    rewrite = rewrite_cost(mod, step)
    step_ms = timed / TRAIN_STEPS * 1e3
    img_s = BATCH * TRAIN_STEPS / timed
    emit(phase="module_train", card=card,
         model="ResNet-50 v1, NHWC, traced to a Symbol + SoftmaxOutput, "
         "seeded random weights (Xavier gaussian in 2)", params=n_params,
         batch=BATCH, image=IMG, dtype="fp32 (TF32 off)", steps=n_steps,
         warm_steps=MODULE_WARM, timed_steps=TRAIN_STEPS, img_s=img_s,
         step_ms=step_ms, step_ms_median=float(np.median(gaps)) * 1e3,
         step_ms_p90=percentile(gaps, 90) * 1e3, wall_s=wall,
         mfu=FLOPS_PER_IMG * img_s / FP32_FLOP_S, peak_mem_gb=peak_gb,
         setup_s=setup_s, losses=losses, launches=launches,
         profile_one_step=profile, conv1x1_rewrite=rewrite)
    return launches


def rewrite_cost(mod, step, windows=3, steps=3):
    """What the executor's conv1x1+BN rewrite costs a Module step: the
    bound executor's training graph as built, against the same graph
    built with no fusion plan (every pair a cuDNN convolution and a
    BatchNorm), in turns on the same parameters: the host ms a step of
    each window, the device ms of one step of each and its device ms by
    kind. Runs after the main path's launch counts are read."""
    from unittest import mock
    from mxnet_tpu_torch import graph
    ex = mod._exec_group.exec_
    fns = {"fused": ex._fns["train"]}
    with mock.patch.object(graph, "_fusion_plan", lambda *a: {}):
        fns["unfused"] = graph.build_graph_fn(ex._symbol._entries,
                                              "train")[0]
    if fns["unfused"].fused_pairs != 0 or fns["fused"].fused_pairs != 36:
        fail("module_train: fused pairs %d and %d, want 36 and 0" % (
            fns["fused"].fused_pairs, fns["unfused"].fused_pairs))
    ms = {k: [] for k in fns}
    dev = {}
    try:
        for _ in range(windows):
            for k, fn in fns.items():
                ex._fns["train"] = fn
                step()
                t0 = time.perf_counter()
                for _ in range(steps):
                    step()
                ms[k].append((time.perf_counter() - t0) * 1e3 / steps)
        kinds = {}
        for k, fn in fns.items():
            ex._fns["train"] = fn
            dev[k] = device_ms(step, n=1, tries=6)
            kinds[k] = by_kind(profiled(step, 1), 1)
    finally:
        ex._fns["train"] = fns["fused"]
    return dict(step_ms={k: v for k, v in ms.items()},
                step_ms_median={k: float(np.median(v))
                                for k, v in ms.items()},
                device_ms=dev, device_ms_by_kind=kinds, windows=windows,
                steps_per_window=steps)


def hybrid_train(dev, card):
    """gluon_train's net and recipe (ResNet-50 v1 NHWC b128,
    cast("bfloat16"), multi-precision SGD), eager against hybridized,
    from the same seeded weights: the first step's losses equal, then
    interleaved windows of steps, eager and hybridized in turns. Returns
    the hybridized net's launch counts over its timed steps."""
    import gc
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(BATCH, IMG, IMG, 3).astype("float32")) \
        .to(dev).to(torch.bfloat16)
    y = torch.from_numpy((rng.rand(BATCH) * 1000).astype("float32")).to(dev)
    runs = {}
    for mode in ("eager", "hybrid"):
        mx.random.seed(0)
        net = resnet50_v1(layout="NHWC", device=dev)
        net.initialize()
        net.cast("bfloat16")
        if mode == "hybrid":
            net.hybridize()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
            "multi_precision": True,
            "lr_scheduler": mx.lr_scheduler.FactorScheduler(step=5,
                                                            factor=0.5)})
        runs[mode] = [net, trainer, mx.gluon.loss.SoftmaxCrossEntropyLoss()]
    first = {m: float(gluon_loop(*runs[m], x, y)) for m in runs}
    if first["eager"] != first["hybrid"] or not np.isfinite(
            first["eager"]):
        fail("hybrid_train: first-step losses eager %r, hybridized %r"
             % (first["eager"], first["hybrid"]))
    gluon_loop(*runs["hybrid"], x, y).cpu()
    gluon_loop(*runs["eager"], x, y).cpu()
    times = {"eager": [], "hybrid": []}
    launches = {}
    for _ in range(HYBRID["windows"]):
        for mode in ("eager", "hybrid"):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            losses = torch.stack([gluon_loop(*runs[mode], x, y) for _ in
                                  range(HYBRID["steps"])]).cpu().numpy()
            times[mode].append((time.perf_counter() - t0) * 1e3
                               / HYBRID["steps"])
            if not np.isfinite(losses).all():
                fail("hybrid_train: %s losses %s" % (mode, losses))
            counts = ops.launch_counts()
            for k, v in counts.items():
                launches.setdefault(mode, {}).setdefault(k, 0)
                launches[mode][k] += v
    steps = HYBRID["windows"] * HYBRID["steps"]
    for mode in runs:
        if launches[mode]["conv1x1_bn_stats"] != 36 * steps or \
                launches[mode]["fused_sgd_momentum"] != steps:
            fail("hybrid_train: %s launches %s over %d steps, want 36 "
                 "conv1x1_bn_stats and 1 fused_sgd_momentum a step"
                 % (mode, launches[mode], steps))
    net = runs["hybrid"][0]
    if net._cached_op is None:
        fail("hybrid_train: the hybridized net ran no CachedOp")
    emit(phase="hybrid_train", card=card, model="ResNet-50 v1, NHWC, "
         "cast(bfloat16), multi-precision SGD (gluon_train's recipe)",
         batch=BATCH, image=IMG, first_loss=first,
         windows=HYBRID["windows"], steps_per_window=HYBRID["steps"],
         step_ms_eager=times["eager"], step_ms_hybrid=times["hybrid"],
         step_ms_eager_median=float(np.median(times["eager"])),
         step_ms_hybrid_median=float(np.median(times["hybrid"])),
         graph_nodes=len(net._cached_graph[1].get_internals().list_outputs()),
         launches=launches)
    return launches["hybrid"]


def sym_score(dev, card):
    """bench.py's b32 scoring pass through the port's graph function: the
    ResNet-50 predict graph (the net traced to a Symbol, then
    graph.build_graph_fn) at b32 in bf16, weights of 2 or more dims in
    bf16, the rest fp32: img/s. In fp32 the graph's output equals the
    eager net's; export then SymbolBlock.imports gives bit-identical
    outputs."""
    import gc
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.graph import build_graph_fn
    gc.collect()
    torch.cuda.empty_cache()
    mx.random.seed(0)
    net, _ = _resnet50_symbol(mx, dev)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2))
    with mx.name.NameManager():
        out_sym = net(mx.sym.var("data"))
    fn = build_graph_fn(out_sym._entries, "predict")[0]
    params = {n: p._graph_value().detach() for n, p in
              net.collect_params().items()}
    aux_names = set(out_sym.list_auxiliary_states())
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(SCORE_BATCH, IMG, IMG, 3)
                         .astype("float32")).to(dev)
    with torch.no_grad():
        # fp32: the graph against the eager net
        args = {n: v for n, v in params.items() if n not in aux_names}
        aux = {n: v for n, v in params.items() if n in aux_names}
        got = fn({**args, "data": x}, aux)[0][0]
        want = net(x)
        fp32_err = (got - want).abs().max().item() / max(
            1.0, want.abs().max().item())
        if not torch.isfinite(got).all() or fp32_err > 1e-5:
            fail("sym_score: the fp32 graph against eager, err %g" %
                 fp32_err)
        # bf16 scoring, as bench.py sets it up
        bf = {n: (v.to(torch.bfloat16) if v.dim() >= 2 else v)
              for n, v in args.items()}
        xb = x.to(torch.bfloat16)
        score = lambda: fn({**bf, "data": xb}, aux)[0][0]  # noqa: E731
        out = score()
        if not torch.isfinite(out.float()).all() or \
                tuple(out.shape) != (SCORE_BATCH, 1000):
            fail("sym_score: bf16 scores %s, finite %s" % (
                tuple(out.shape), bool(torch.isfinite(out.float()).all())))
        ms = cuda_ms(score, iters=30)
        # a profile of 2 calls: the profiler drops records of longer
        # windows of this graph's ~500 launches a call
        dev_ms = device_ms(score, n=2, tries=20)
    # export, then SymbolBlock.imports: bit-identical
    net.hybridize()
    ref = net(x).detach()
    with tempfile.TemporaryDirectory() as tmp:
        net.export(os.path.join(tmp, "r50"))
        blk = mx.gluon.SymbolBlock.imports(
            os.path.join(tmp, "r50-symbol.json"), ["data"],
            os.path.join(tmp, "r50-0000.params"), ctx=mx.gpu(0))
    back = blk(x).detach()
    same = torch.equal(ref, back)
    if not same:
        fail("sym_score: export then SymbolBlock.imports differs by %g"
             % (ref - back).abs().max().item())
    emit(phase="sym_score", card=card, model="ResNet-50 v1 NHWC predict "
         "graph (build_graph_fn), bf16 weights of ndim >= 2, fp32 BN",
         batch=SCORE_BATCH, image=IMG, img_s=SCORE_BATCH / ms * 1e3,
         ms=ms, device_ms=dev_ms,
         device_busy_share=dev_ms / ms if dev_ms else None,
         fp32_graph_vs_eager_err=fp32_err,
         export_imports_bit_identical=same)


def mnist(ops, dev, card):
    """tools/torch_train_mnist.py, the port's copy of
    example/image_classification/train_mnist.py (LeNet through
    Module.fit, 10 epochs on its synthetic data, SGD momentum 0.9), on the
    card: its own accuracy assert, and one fused_sgd_momentum launch per
    SGD group the FusedUpdater formed (weights, and the biases Module
    gives no weight decay). Returns the launch counts of the script's
    run."""
    import contextlib
    import io
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.observability import registry
    groups = registry.counter("optimizer.fused.groups")
    script = _load_script(MNIST_SCRIPT)
    out = io.StringIO()
    argv = sys.argv
    steps = []
    real_update = mx.mod.Module.update

    def counted(self):
        real_update(self)
        steps.append(1)
    with tempfile.TemporaryDirectory() as tmp:
        # 10 epochs: the recipe (Uniform(0.01) init, momentum 0.9) leaves
        # its plateau at an epoch that varies with the initial weights
        # and, on the card, with cuDNN's nondeterministic reductions (6
        # epochs reached 0.63-0.88); the JAX package's own test of the
        # example runs 8
        sys.argv = [MNIST_SCRIPT, "--data-dir", os.path.join(tmp, "none"),
                    "--epochs", str(MNIST_EPOCHS)]
        mx.mod.Module.update = counted
        groups0 = groups.get()
        # cuDNN's deterministic algorithms: one trajectory per seed
        torch.backends.cudnn.deterministic = True
        # the main path, with every launch counter at 0 just before it
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                script.main()
        except AssertionError as e:
            fail("mnist: the example's assert failed: %s\n%s"
                 % (e, out.getvalue()))
        finally:
            torch.backends.cudnn.deterministic = False
            mx.mod.Module.update = real_update
            sys.argv = argv
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    sgd_groups = groups.get() - groups0
    lines = out.getvalue().splitlines()
    if lines[-1:] != ["MNIST_EXAMPLE_OK"] or \
            launches["fused_sgd_momentum"] != sgd_groups or \
            sgd_groups < len(steps) or launches["conv1x1_bn_stats"]:
        fail("mnist: %d steps, %d SGD groups, launches %s, output %s"
             % (len(steps), sgd_groups, launches, lines[-3:]))
    emit(phase="mnist", card=card, script=MNIST_SCRIPT, steps=len(steps),
         sgd_groups=sgd_groups, wall_s=wall,
         output=[ln for ln in lines if "accuracy" in ln], launches=launches)
    return launches


def _flash_block(g):
    """A user HybridBlock whose hybrid_forward calls
    F.contrib.flash_attention on projections of its input."""
    class Attention(g.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.proj = g.nn.Dense(3 * 64, flatten=False)

        def hybrid_forward(self, F, x):
            qkv = self.proj(x)                               # (B, T, 192)
            qkv = F.reshape(qkv, shape=(0, 0, 3, 2, 32))
            qkv = F.transpose(qkv, axes=(2, 0, 3, 1, 4))      # (3,B,H,T,D)
            q, k, v = (F.squeeze(F.slice_axis(qkv, axis=0, begin=i,
                                              end=i + 1), axis=0)
                       for i in range(3))
            return F.contrib.flash_attention(q, k, v, causal=True)
    return Attention()


def gluon_layers_hybridized(ops, dev, card):
    """Every hybridizable gluon.nn layer of the port (the gluon_layers
    cases but Sequential and Lambda), hybridized, forward and backward on
    the card against the same hybridized block on the CPU (the same
    weights), and a user HybridBlock calling F.contrib.flash_attention.
    LayerNorm and flash attention run on their kernels: the phase counts
    their launches. Returns them."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    tol = 1e-4
    errs, rng = {}, np.random.RandomState(5)
    cases = [c for c in _layer_cases(gluon)
             if c[0] not in ("Sequential", "Lambda")]
    cases.append(("user_flash_attention", lambda: _flash_block(gluon),
                  (2, 64, 16)))
    ops.reset_launch_counts()
    for name, make, shape in cases:
        x = (rng.randint(0, 10, (3, 4)).astype(np.float32)
             if shape == "indices" else rng.randn(*shape).astype(np.float32))
        nets = []
        for ctx in (mx.cpu(), mx.gpu(0)):
            with ctx:
                nets.append(make())
        cpu_net, card_net = nets
        with mx.cpu():
            cpu_net.initialize(mx.init.Uniform(0.5))
            probe = cpu_net(nd.array(x))
        card_net.load_parameters(
            {k: p.data().detach() for k, p in
             cpu_net._collect_params_with_prefix().items()}, ctx=mx.gpu(0))
        cpu_net.hybridize()
        card_net.hybridize()
        head = rng.randn(*probe.shape).astype(np.float32)
        a = _run_layer(mx, cpu_net, x, head, mx.cpu())
        b = _run_layer(mx, card_net, x, head, mx.gpu(0))
        if card_net._cached_op is None:
            fail("gluon_layers_hybridized: %s ran no CachedOp" % name)
        scale = max(1.0, a[0].abs().max().item())
        err = (a[0] - b[0]).abs().max().item() / scale
        if a[1] is not None:
            err = max(err, (a[1] - b[1]).abs().max().item() / scale)
        for k in a[2]:
            err = max(err, (a[2][k] - b[2][k]).abs().max().item() /
                      max(1.0, a[2][k].abs().max().item()))
        if not np.isfinite(err) or err > tol or a[2].keys() != b[2].keys():
            fail("gluon_layers_hybridized: %s card vs CPU err %g > %g"
                 % (name, err, tol))
        errs[name] = err
    launches = ops.launch_counts()
    if launches["layer_norm"] < 1 or launches["flash_attention"] < 1:
        fail("gluon_layers_hybridized: launches %s, want layer_norm and "
             "flash_attention" % launches)
    emit(phase="gluon_layers_hybridized", card=card, layers=len(errs),
         tol=tol, max_err=max(errs.values()), errs=errs, launches=launches)
    return launches


# ---------------------------------------------------------------------------
# phases 23-24: the distributed KVStore and the fused exchange + update step
# ---------------------------------------------------------------------------
DIST_SMALL = dict(ranks=2, batch=8, timeout_s=600, tol=1e-5)


def _dist_worker():
    """tests/torch_dist_worker.py as a module: its data and oracles."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    import torch_dist_worker
    return torch_dist_worker


def _init_world_of_one():
    """A one-process group: the store binds a free port itself (port 0)
    and publishes it in a file, so no port is probed and closed first."""
    import tempfile
    from mxnet_tpu_torch.parallel.kvstore_dist import init_distributed
    init_distributed("127.0.0.1:0", 1, 0, port_file=os.path.join(
        tempfile.mkdtemp(prefix="rendezvous"), "port"))


def dist_small(dev, card):
    """2 ranks on the one card over gloo with CUDA tensors, started by
    tools/torch_launch.py -n 2 as a user starts a gang (rank 0 binds the
    coordinator's port and publishes it): each rank checks the
    store's exact sums and trains tests/torch_dist_worker.py's nets (a
    narrow NHWC ResNet V1 at b8 and 32 px, fp32, 3 fused then 3 staged
    steps from the same start; an MLP, also 2-bit compressed). Gates: the
    ranks' weights bit-identical, fused equal to staged, the ResNet within
    tol of a one-process card oracle that sums the ranks' gradients in
    rank order, the compressed MLP equal to its exact oracle. Returns the
    ranks' launches."""
    import shutil
    import signal
    import tempfile
    import mxnet_tpu_torch as mx
    w = _dist_worker()
    n, batch = DIST_SMALL["ranks"], DIST_SMALL["batch"]
    here = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="dist_small")
    cmd = [sys.executable, os.path.join(here, "tools", "torch_launch.py"),
           "-n", str(n), sys.executable, os.path.join(here, "tests",
                                                      "torch_dist_worker.py"),
           "--device", "cuda", "--resnet-batch", str(batch), "--out", out]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, start_new_session=True,
                            env=dict(os.environ, MXTPU_DIST_BACKEND="gloo"))
    try:
        log, _ = proc.communicate(timeout=DIST_SMALL["timeout_s"])
    except subprocess.TimeoutExpired:
        log = b"timed out after %d s" % DIST_SMALL["timeout_s"]
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    gang_s = time.perf_counter() - t0
    log = log.decode(errors="replace")
    if proc.returncode or any("WORKER_%d_OK" % r not in log
                              for r in range(n)):
        fail("dist_small: the gang failed (rc %s):\n%s"
             % (proc.returncode, log[-4000:]))
    ranks = [dict(np.load(os.path.join(out, "rank%d.npz" % r)))
             for r in range(n)]
    shutil.rmtree(out, ignore_errors=True)

    def keys(arrays, tag):
        return sorted((k for k in arrays if k.startswith(tag + "_")),
                      key=lambda k: (len(k), k))

    names = list(w.build_resnet(torch.device("cpu")).collect_params())
    running = {i for i, name in enumerate(names) if "_running_" in name}
    differ = [(tag, k) for tag in ("mlp_fused", "mlp_staged", "mlp_comp",
                                   "resnet_fused", "resnet_staged",
                                   "module")
              for k in keys(ranks[0], tag)
              if not (tag.startswith("resnet")
                      and int(k.rsplit("_", 1)[1]) in running)
              and any(r[k].tobytes() != ranks[0][k].tobytes()
                      for r in ranks[1:])]
    staged_differ = [(i, k) for i, r in enumerate(ranks)
                     for kind in ("mlp", "resnet")
                     for k in keys(r, kind + "_fused")
                     if r[k].tobytes() !=
                     r[k.replace("_fused_", "_staged_")].tobytes()]
    oracle = w.resnet_oracle(mx, dev, n, batch)
    oracle_err = max(
        float(np.abs(ranks[r][k] - oracle[r][ok]).max() /
              max(1.0, np.abs(oracle[r][ok]).max()))
        for r in range(n) for k, ok in zip(keys(ranks[r], "resnet_fused"),
                                           keys(oracle[r], "resnet")))
    comp = w.compressed_mlp_oracle(mx, dev, n)
    comp_differ = [k for k in keys(ranks[0], "mlp_comp")
                   if ranks[0][k].tobytes() != comp[k].tobytes()]
    launches = {tag: ranks[0]["launches_" + tag].tolist()
                for tag in ("resnet_fused", "resnet_staged")}
    if differ or staged_differ or not oracle_err <= DIST_SMALL["tol"] or \
            comp_differ:
        fail("dist_small: ranks differ in %s; fused and staged differ in "
             "%s; ResNet against the card oracle %g (tol %g); compressed "
             "MLP against its exact oracle differs in %s"
             % (differ[:4], staged_differ[:4], oracle_err,
                DIST_SMALL["tol"], comp_differ))
    # 6 conv1x1+BN pairs a forward, 3 steps; one SGD group a step
    if any(v != [6 * w.STEPS, w.STEPS] for v in launches.values()):
        fail("dist_small: rank 0's launches (conv1x1_bn_stats, "
             "fused_sgd_momentum) %s, want [%d, %d] a run"
             % (launches, 6 * w.STEPS, w.STEPS))
    dispatches, flats, groups, steps = ranks[0]["counts"].tolist()
    emit(phase="dist_small", card=card, ranks=n, backend="gloo, CUDA "
         "tensors (host-staged)", launcher="tools/torch_launch.py -n %d" % n,
         resnet_batch_per_rank=batch, image=w.RESNET["img"], steps=steps,
         gang_s=gang_s, store_exact_sums=True, ranks_bit_identical=True,
         fused_equals_staged=True, resnet_oracle_rel_err=oracle_err,
         tol=DIST_SMALL["tol"], compressed_equals_exact_oracle=True,
         mlp_fused_dispatches_a_step=dispatches / steps,
         mlp_flats=flats, mlp_groups_a_step=groups / steps,
         launches_rank0=launches)
    total = [sum(r["launches_" + tag][i] for r in ranks
                 for tag in ("resnet_fused", "resnet_staged"))
             for i in range(2)]
    return {"conv1x1_bn_stats": int(total[0]),
            "fused_sgd_momentum": int(total[1])}


def _train_state(net, trainer):
    """Copies of the parameters (running statistics too) and of every
    optimizer state tensor."""
    out = [p.data().detach().clone() for p in net.collect_params().values()]
    stack = list(trainer._updaters[0].states.values())
    while stack:
        st = stack.pop()
        if isinstance(st, (list, tuple)):
            stack.extend(st)
        elif isinstance(st, torch.Tensor):
            out.append(st.detach().clone())
    return out


def dist_train(dev, card, gluon_img_s):
    """ResNet-50 v1 with gluon_train's recipe through
    gluon.Trainer(kvstore="dist_device_sync") after init_distributed() at
    world size 1 over NCCL: from one saved state, 10 fused steps, then 10
    staged steps (MXTPU_FUSED_STEP=0); their weights and optimizer states
    must be bit-identical (cuDNN's deterministic algorithms, so that two
    runs of a step are). Returns the launches of both runs."""
    import gc
    import shutil
    import tempfile
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.observability import registry
    gc.collect()
    torch.cuda.empty_cache()
    _init_world_of_one()
    tmp = tempfile.mkdtemp(prefix="dist_train")
    torch.backends.cudnn.deterministic = True
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            fail("dist_train: process group %s of %d, want nccl of 1"
                 % (dist.get_backend(), dist.get_world_size()))
        mx.random.seed(0)
        net = resnet50_v1(layout="NHWC", device=dev)
        net.initialize()
        net.cast("bfloat16")
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
            "multi_precision": True,
            "lr_scheduler": mx.lr_scheduler.FactorScheduler(step=5,
                                                            factor=0.5)},
            kvstore="dist_device_sync")
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.randn(BATCH, IMG, IMG, 3)
                             .astype("float32")).to(dev).to(torch.bfloat16)
        y = torch.from_numpy((rng.rand(BATCH) * 1000).astype("float32")) \
            .to(dev)
        os.environ["MXTPU_FUSED_STEP"] = "1"
        warm = torch.stack([gluon_loop(net, trainer, loss_fn, x, y)
                            for _ in range(GLUON_WARM)]).cpu().numpy()
        kv_type = trainer._kvstore.type
        params, states = (os.path.join(tmp, "net.params"),
                          os.path.join(tmp, "trainer.states"))
        net.save_parameters(params)
        trainer.save_states(states)
        disp = registry.counter("train.step.dispatches")
        groups = registry.counter("optimizer.fused.groups")
        runs, finals = {}, {}
        for mode in ("fused", "staged"):
            os.environ["MXTPU_FUSED_STEP"] = "1" if mode == "fused" else "0"
            net.load_parameters(params)
            trainer.load_states(states)
            guard0 = guard_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            d0, g0 = disp.get(), groups.get()
            # the main path, with every launch counter at 0 just before it
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            losses = torch.stack([gluon_loop(net, trainer, loss_fn, x, y)
                                  for _ in range(TRAIN_STEPS)]).cpu().numpy()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
            dispatches, n_groups = disp.get() - d0, groups.get() - g0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            guard = guard_since(guard0)
            finals[mode] = _train_state(net, trainer)
            ran_fused = trainer._updaters[0]._fused_step_owner is not None \
                and mode == "fused"
            if not np.isfinite(losses).all() or guard["skipped_steps"] or \
                    guard["anomalies"]:
                fail("dist_train %s: losses %s, numerics guard %s"
                     % (mode, losses, guard))
            if launches["conv1x1_bn_stats"] != 36 * TRAIN_STEPS or \
                    launches["fused_sgd_momentum"] != n_groups or \
                    n_groups < TRAIN_STEPS or dispatches != n_groups or \
                    (mode == "fused" and not ran_fused):
                fail("dist_train %s: launches %s, %d SGD groups, %d "
                     "dispatches over %d steps, fused step ran: %s; want 36 "
                     "conv1x1_bn_stats a step, one fused_sgd_momentum "
                     "launch and one dispatch per SGD group"
                     % (mode, launches, n_groups, dispatches, TRAIN_STEPS,
                        ran_fused))
            # where one step's time goes (after the state was taken): the
            # whole step, and the host's enqueue of trainer.step alone
            t = time.perf_counter()
            gluon_loop(net, trainer, loss_fn, x, y).cpu()
            one_step_ms = (time.perf_counter() - t) * 1e3
            step_host = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                trainer.step(BATCH)
                step_host.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            events = device_events(
                lambda: gluon_loop(net, trainer, loss_fn, x, y).cpu(), 1)
            dev_us = {k: us for k, (us, _) in events.items()}
            profile = breakdown(dev_us, 1, one_step_ms, top_n=8)
            profile["device_ms_by_kind"] = by_kind(dev_us, 1)
            runs[mode] = dict(
                img_s=BATCH * TRAIN_STEPS / wall,
                step_ms=wall / TRAIN_STEPS * 1e3, peak_mem_gb=peak_gb,
                losses=losses.tolist(),
                conv1x1_bn_stats_a_step=launches["conv1x1_bn_stats"] /
                TRAIN_STEPS,
                fused_sgd_momentum_a_step=launches["fused_sgd_momentum"] /
                TRAIN_STEPS,
                train_step_dispatches_a_step=dispatches / TRAIN_STEPS,
                trainer_step_host_ms_median=float(np.median(step_host)),
                launches=launches, profile_one_step=profile)
        same = len(finals["fused"]) == len(finals["staged"]) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(finals["fused"], finals["staged"]))
        if not same:
            fail("dist_train: 10 fused and 10 staged steps from one state "
                 "left different weights or optimizer states")
    finally:
        os.environ.pop("MXTPU_FUSED_STEP", None)
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(tmp, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    emit(phase="dist_train", card=card, model="ResNet-50 v1, NHWC, seeded "
         "random weights", batch=BATCH, image=IMG,
         dtype="net.cast(bfloat16), multi_precision (fp32 masters)",
         kvstore=kv_type, backend="nccl", world_size=1,
         collectives_a_step=0, steps=TRAIN_STEPS, warm_steps=GLUON_WARM,
         losses_warm=warm.tolist(), cudnn_deterministic=True,
         fused_equals_staged_bit_for_bit=same,
         state_tensors_compared=len(finals["fused"]),
         fused=runs["fused"], staged=runs["staged"],
         gluon_train_img_s=gluon_img_s)
    return {k: runs["fused"]["launches"][k] + runs["staged"]["launches"][k]
            for k in ("conv1x1_bn_stats", "fused_sgd_momentum")}


# ---------------------------------------------------------------------------
# phases 25-26: ShardedTrainer across processes
# ---------------------------------------------------------------------------
# stated before the first run (PERF.md): at world size 1 every collective
# is an identity, so the one difference from `train`'s one-card trainer is
# BatchNorm after a 1x1 conv rebuilding var from E[x^2] = var + mean^2;
# the first loss within FIRST_RTOL, the 10 steps' losses within LOSS_RTOL
# and every state tensor within STATE_TOL of max(1, |train's|)
DIST_SHARDED = dict(first_rtol=1e-3, loss_rtol=2e-2, state_tol=2e-2)


class _Collectives:
    """Counts the trainer's collectives (parallel.mesh's all_reduce_,
    reduce_scatter_, all_gather_): all calls, and those made while the
    calling thread's stream was capturing a CUDA graph."""

    NAMES = ("all_reduce_", "reduce_scatter_", "all_gather_")

    def __init__(self):
        from mxnet_tpu_torch.parallel import data_parallel, mesh
        self.mods = (mesh, data_parallel)
        self.calls = {n: 0 for n in self.NAMES}
        self.captured = {n: 0 for n in self.NAMES}
        self.saved = {}

    def __enter__(self):
        for mod in self.mods:
            for name in self.NAMES:
                fn = getattr(mod, name)
                self.saved[(mod, name)] = fn
                setattr(mod, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def counted(*args, **kwargs):
            self.calls[name] += 1
            if args[0].is_cuda and torch.cuda.is_current_stream_capturing():
                self.captured[name] += 1
            return fn(*args, **kwargs)
        return counted

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)


def dist_sharded(dev, card, ref):
    """ResNet-50 v1 as `train` runs it (NHWC, b128 at 224 px, bf16 over
    fp32 masters, SGD momentum 0.9, from train's seeded weights and batch)
    through the ShardedTrainer of a process-spanning mesh: after
    init_distributed() at world size 1 over NCCL, {"dp": 1} over the gang,
    global-batch BatchNorm, on the CUDA-graph step; first with ZeRO-1 (its
    gradients reduce-scattered, its weights all-gathered), then
    replicated (the gradient all-reduce). Gates, each trainer: one graph
    captured, every collective of a step issued inside the capture (the
    BatchNorm reductions forward and backward, the loss's pmean, the
    exchange's), the first window's losses and state against train's
    one-card trainer within DIST_SHARDED, 36 conv1x1_wgmma_kernel and 1
    sgd_momentum_kernel launches a step read by the profiler over the
    replays, and no other conv1x1 kernel. Returns the launches."""
    import gc
    import torch.distributed as dist
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.convert import init_resnet_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.nn import BatchNorm
    from mxnet_tpu_torch.parallel import ShardedTrainer, data_parallel
    from mxnet_tpu_torch.resilience import numerics
    gc.collect()
    torch.cuda.empty_cache()
    _init_world_of_one()
    tol = DIST_SHARDED
    torch.backends.cudnn.deterministic = True
    runs, launches = {}, {}
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            fail("dist_sharded: process group %s of %d, want nccl of 1"
                 % (dist.get_backend(), dist.get_world_size()))
        net = resnet50_v1(layout="NHWC", device=dev)
        init_resnet_params(net, seed=0)
        n_bn = sum(isinstance(m, BatchNorm) for m in net.modules())
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.randn(BATCH, IMG, IMG, 3)
                             .astype("float32")).to(dev)
        y = torch.from_numpy((rng.rand(BATCH) * 1000).astype("float32")) \
            .to(dev)
        for mode, zero in (("zero1", True), ("replicated", False)):
            st = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9},
                                compute_dtype="bfloat16",
                                shard_optimizer_state=zero)
            if not (st._dist and st._graph_on and st._mesh.shape ==
                    {"dp": 1} and bool(st._zero) == zero):
                fail("dist_sharded %s: trainer over %r, graph %s, %d "
                     "ZeRO-1 parameters" % (mode, st._mesh, st._graph_on,
                                           len(st._zero)))
            numerics.drain_flags()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # the main path, with every launch counter at 0 just before it
            ops.reset_launch_counts()
            t = time.perf_counter()
            with _Collectives() as coll:
                losses = st.step_many(x, y, n_steps=TRAIN_STEPS).cpu()
            first_s = time.perf_counter() - t
            wrappers = ops.launch_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            calls = data_parallel._WARMUP + 1
            per_step = {"all_reduce_": 2 * n_bn + 1 + len(st._rep_buckets),
                        "reduce_scatter_": len(st._zero_buckets),
                        "all_gather_": len(st._zero_buckets)}
            if len(st._graphs) != 1 or coll.captured != per_step or \
                    coll.calls != {k: v * calls for k, v in
                                   per_step.items()}:
                fail("dist_sharded %s: %d graphs; collectives %s, inside "
                     "the capture %s; want one graph and %s a step, every "
                     "one of the capture's captured"
                     % (mode, len(st._graphs), coll.calls, coll.captured,
                        per_step))
            if wrappers["conv1x1_bn_stats"] != 36 * calls or \
                    wrappers["fused_sgd_momentum"] != calls:
                fail("dist_sharded %s: the warm-up and capture launched %s, "
                     "want %d conv1x1_bn_stats and %d fused_sgd_momentum"
                     % (mode, wrappers, 36 * calls, calls))
            state = _trainer_state(st)
            first_err = abs(float(losses[0]) - float(ref["losses"][0])) / \
                abs(float(ref["losses"][0]))
            loss_err = float((losses - ref["losses"]).abs().max()) / \
                float(ref["losses"].abs().max())
            state_err = max(float((a.float() - b.float()).abs().max()) /
                            max(1.0, float(b.float().abs().max()))
                            for a, b in zip(state, ref["state"]))
            same = torch.equal(losses, ref["losses"]) and all(
                torch.equal(a, b) for a, b in zip(state, ref["state"]))
            if len(state) != len(ref["state"]) or \
                    first_err > tol["first_rtol"] or \
                    loss_err > tol["loss_rtol"] or \
                    state_err > tol["state_tol"]:
                fail("dist_sharded %s: against train's one-card trainer, "
                     "first loss %g, losses %g, state %g (tolerances %s)"
                     % (mode, first_err, loss_err, state_err, tol))
            guard = numerics.drain_flags()
            if not torch.isfinite(losses).all() or guard["anomalies"]:
                fail("dist_sharded %s: losses %s, numerics guard %s"
                     % (mode, losses.tolist(), guard))
            # a timed window of replays
            torch.cuda.synchronize()
            t = time.perf_counter()
            timed = st.step_many(x, y, n_steps=TRAIN_STEPS).cpu().numpy()
            wall = time.perf_counter() - t
            numerics.drain_flags()
            want = {"conv1x1_bn_stats": 36 * TRAIN_STEPS,
                    "fused_sgd_momentum": TRAIN_STEPS}
            replayed = device_launches(
                lambda: st.step_many(x, y, n_steps=TRAIN_STEPS), 1, want)
            events = device_events(lambda: st.step_many(x, y, n_steps=1), 1)
            conv_paths = {k[:90]: c for k, (_, c) in events.items()
                          if "conv1x1_" in k}
            if any(replayed[k] != v for k, v in want.items()) or \
                    replayed["flash_attention"] or replayed["layer_norm"] \
                    or any("conv1x1_wmma_kernel" in k or
                           "conv1x1_simt_kernel" in k for k in conv_paths):
                fail("dist_sharded %s: the profiler saw %s over %d replays "
                     "(want %s) and conv1x1 kernels %s"
                     % (mode, replayed, TRAIN_STEPS, want, conv_paths))
            numerics.drain_flags()
            torch.cuda.synchronize()
            t = time.perf_counter()
            st.step_many(x, y, n_steps=1).cpu()
            one_step_ms = (time.perf_counter() - t) * 1e3
            dev_us = {k: us for k, (us, _) in events.items()}
            profile = breakdown(dev_us, 1, one_step_ms, top_n=8)
            profile["device_ms_by_kind"] = by_kind(dev_us, 1)
            profile["collective_kernels"] = {
                k[:90]: c for k, (_, c) in events.items()
                if "nccl" in k.lower() or "Memcpy" in k}
            runs[mode] = dict(
                img_s=BATCH * TRAIN_STEPS / wall,
                step_ms=wall / TRAIN_STEPS * 1e3,
                device_ms=profile["device_ms"], first_window_s=first_s,
                first_window_peak_mem_gb=peak_gb,
                losses_first_window=losses.tolist(),
                losses_timed=timed.tolist(),
                against_train=dict(first_loss_rel=first_err,
                                   losses_rel=loss_err, state_rel=state_err,
                                   bit_identical=same),
                collectives_a_step=per_step,
                collectives_inside_capture=coll.captured,
                zero1_parameters=len(st._zero),
                buckets=dict(all_reduce=len(st._rep_buckets),
                             reduce_scatter=len(st._zero_buckets)),
                wrapper_launches=wrappers, replay_launches=replayed,
                profile_one_step=profile)
            launches[mode] = (wrappers, replayed)
            del st
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
        if dist.is_initialized():
            dist.destroy_process_group()
    emit(phase="dist_sharded", card=card, model="ResNet-50 v1, NHWC, "
         "seeded random weights (train's)", batch=BATCH, image=IMG,
         dtype="bf16 compute, fp32 master", backend="nccl", world_size=1,
         mesh={"dp": 1}, steps=TRAIN_STEPS, cudnn_deterministic=True,
         tolerances=tol, batchnorm_layers=n_bn, zero1=runs["zero1"],
         replicated=runs["replicated"],
         train=dict(img_s=ref["img_s"], step_ms=ref["step_ms"],
                    device_ms=ref["device_ms"]))
    return {name: {"replays": launches["zero1"][1][name] +
                   launches["replicated"][1][name],
                   "capture": launches["zero1"][0][name] +
                   launches["replicated"][0][name]}
            for name in ("conv1x1_bn_stats", "fused_sgd_momentum")}


DIST_SHARDED_SMALL = dict(ranks=2, timeout_s=600, tol=1e-5, zero1_tol=1e-6)


def _sharded_worker():
    """tests/torch_sharded_worker.py as a module: its nets and data."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    import torch_sharded_worker
    return torch_sharded_worker


def _same(a, b):
    """a and b equal bit for bit (nested dicts and lists of tensors and
    numbers)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(p, q) for p, q in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _rel(a, b):
    """max over the tensors of max |a - b| / max(1, max |b|)."""
    flat_a, flat_b = [], []

    def walk(x, out):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], out)
        else:
            out.append(x.double())
    walk(a, flat_a)
    walk(b, flat_b)
    if len(flat_a) != len(flat_b):
        return float("inf")
    return max(float((p - q).abs().max()) / max(1.0, float(q.abs().max()))
               for p, q in zip(flat_a, flat_b))


def dist_sharded_small(dev, card):
    """2 ranks on the one card over gloo, eager (MXTPU_CUDA_GRAPH=0),
    started by tools/torch_launch.py -n 2: tests/torch_sharded_worker.py's
    narrow NHWC ResNet V1 (BatchNorm) at global batch 16, 32 px, fp32,
    3 steps each of the global-batch trainer, ZeRO-1 and the 2-bit
    compressed step; a TrainerCheckpoint saved at 2 ranks. Gates: the
    ranks bit-identical; the global-batch run within tol of a one-rank
    run on the whole batch here; ZeRO-1 within zero1_tol of replicated;
    the compressed run finite and its loss at most 1.25x its first; the
    checkpoint restored by one rank here continues as the uninterrupted
    2-rank run (tol); a graph-mode trainer over gloo raised, naming
    MXTPU_CUDA_GRAPH=0. Returns the ranks' launches."""
    import shutil
    import signal
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import init_resnet_params
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.parallel.checkpoint import TrainerCheckpoint
    w = _sharded_worker()
    cfg = DIST_SHARDED_SMALL
    n = cfg["ranks"]
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="dist_sharded_small")
    try:
        with mx.cpu():
            seeded = w.build_resnet(vision)
            seeded.initialize()
        init_resnet_params(seeded, seed=3)
        weights = {k: v.detach().clone() for k, v in
                   seeded.state_dict().items()}
        inputs = os.path.join(tmp, "inputs.pt")
        torch.save({"resnet": weights, "ckpt_dir": os.path.join(tmp, "ck")},
                   inputs)
        out = os.path.join(tmp, "out")
        cmd = [sys.executable, os.path.join(here, "tools",
                                            "torch_launch.py"),
               "-n", str(n), sys.executable,
               os.path.join(here, "tests", "torch_sharded_worker.py"),
               "--mode", "chip_small", "--device", "cuda", "--inputs",
               inputs, "--out", out]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT,
                                start_new_session=True,
                                env=dict(os.environ, MXTPU_DIST_BACKEND="gloo",
                                         MXTPU_CUDA_GRAPH="0"))
        try:
            log, _ = proc.communicate(timeout=cfg["timeout_s"])
        except subprocess.TimeoutExpired:
            log = b"timed out after %d s" % cfg["timeout_s"]
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        gang_s = time.perf_counter() - t0
        log = log.decode(errors="replace")
        if proc.returncode or any("WORKER_%d_OK" % r not in log
                                  for r in range(n)):
            fail("dist_sharded_small: the gang failed (rc %s):\n%s"
                 % (proc.returncode, log[-4000:]))
        ranks = [torch.load(os.path.join(out, "rank%d.pt" % r))
                 for r in range(n)]
        r0 = ranks[0]
        differ = [k for k in r0 if any(not _same(r[k], r0[k])
                                       for r in ranks[1:])]
        # one rank on the whole batch, here, and the checkpoint's restore
        x, y = w.batch("resnet")
        os.environ["MXTPU_CUDA_GRAPH"] = "0"
        try:
            with mx.gpu(dev.index):
                one = w._trainer(mx, "resnet", weights, dev)
                one_losses = [float(one.step(x, y))
                              for _ in range(w.RESNET["steps"])]
                restored = w._trainer(mx, "resnet", weights, dev)
                with TrainerCheckpoint(os.path.join(tmp, "ck")) as ck:
                    step = ck.restore_latest(restored)
                resumed = [float(restored.step(x, y)) for _ in range(2)]
        finally:
            os.environ.pop("MXTPU_CUDA_GRAPH", None)
        one_state = w._state(one)
        errs = dict(
            global_batch=max(_rel(r0["plain"], one_state), _rel(
                {"l": torch.tensor(r0["plain_losses"])},
                {"l": torch.tensor(one_losses)})),
            zero1=_rel(r0["zero1"], r0["plain"]),
            checkpoint=_rel({"l": torch.tensor(resumed)},
                            {"l": torch.tensor(r0["after_save"])}))
        comp = r0["comp_losses"]
        if differ or errs["global_batch"] > cfg["tol"] or \
                errs["zero1"] > cfg["zero1_tol"] or \
                errs["checkpoint"] > cfg["tol"] or \
                step != w.RESNET["steps"] or \
                not (np.isfinite(comp).all() and comp[-1] <= 1.25 * comp[0]) \
                or "MXTPU_CUDA_GRAPH=0" not in (r0["graph_over_gloo"] or ""):
            fail("dist_sharded_small: ranks differ in %s; errors %s "
                 "(tolerances %s); restored step %s; compressed losses %s; "
                 "graph over gloo: %s" % (differ, errs, cfg, step, comp,
                                          r0["graph_over_gloo"]))
        want = {"conv1x1_bn_stats": 6 * w.RESNET["steps"],
                "fused_sgd_momentum": w.RESNET["steps"]}
        bad = {tag: r0[tag + "_launches"] for tag in ("plain", "zero1",
                                                       "comp")
               if any(r0[tag + "_launches"][k] != v
                      for k, v in want.items())}
        if bad:
            fail("dist_sharded_small: rank 0's launches %s, want %s a run"
                 % (bad, want))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase="dist_sharded_small", card=card, ranks=n,
         backend="gloo, CUDA tensors (host-staged)", step="eager",
         launcher="tools/torch_launch.py -n %d" % n,
         global_batch=w.RESNET["batch"], image=w.RESNET["img"],
         dtype="fp32", steps=w.RESNET["steps"], gang_s=gang_s,
         ranks_bit_identical=not differ, errors=errs, tolerances=cfg,
         losses=dict(plain=r0["plain_losses"], zero1=r0["zero1_losses"],
                     compressed=comp, one_rank=one_losses,
                     after_save=r0["after_save"], restored_at_1=resumed),
         graph_over_gloo=(r0["graph_over_gloo"] or "")[:160],
         launches_rank0={tag: r0[tag + "_launches"]
                         for tag in ("plain", "zero1", "comp")})
    return {k: sum(r[tag + "_launches"][k] for r in ranks
                   for tag in ("plain", "zero1", "comp"))
            for k in ("conv1x1_bn_stats", "fused_sgd_momentum")}



# ---------------------------------------------------------------------------
# phases 27-28: the record-file input pipeline
# ---------------------------------------------------------------------------
RECORD = dict(images=1536, width=500, height=375, quality=90, threads=8,
              warm=2, steps=10, classes=1000, check_every=97)
RECORD_MODULE = dict(images=256, side=40, img=32, batch=16, epochs=2,
                     classes=10)


def _id_blocks(img, ident):
    """Write `ident` (< 4096) into three 16x16 blocks of the top-left
    corner, one hex digit each, as (digit * 16 + 8) in every channel: a
    JPEG keeps a flat block aligned to its 16x16 MCUs within a few
    levels."""
    for k, shift in enumerate((8, 4, 0)):
        img[:16, 16 * k:16 * k + 16] = ((ident >> shift) & 15) * 16 + 8


def _read_id_blocks(img):
    digits = [int(round((float(img[:16, 16 * k:16 * k + 16].mean()) - 8)
                        / 16)) for k in range(3)]
    return (digits[0] << 8) | (digits[1] << 4) | digits[2]


def write_records(path, n, height, width, seed, classes, quality,
                  class_pattern=False):
    """n seeded smooth-noise RGB images (height x width) packed into the
    indexed .rec at `path` (and its .idx): JPEG at `quality` where PIL is
    importable, else `pack_img`'s NPY records. Record i carries id i in
    its corner blocks and the label vector [class, i] (class i % classes);
    with `class_pattern` the class also sets a colour bias the net can
    learn. Returns the seconds it took."""
    import torch.nn.functional as F
    from concurrent.futures import ThreadPoolExecutor
    from mxnet_tpu_torch import recordio
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)
    w = recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                   path, "w")
    chunk = 128

    def pack(i, img):
        cls = i % classes
        if class_pattern:
            img[..., cls % 3] = np.clip(img[..., cls % 3].astype(np.int32)
                                        + 40 * (cls // 3) - 60, 0, 255)
        _id_blocks(img, i)
        return recordio.pack_img(
            recordio.IRHeader(0, [float(cls), float(i)], i, 0), img,
            quality=quality, img_fmt=".jpg")

    with ThreadPoolExecutor(8) as pool:
        for lo in range(0, n, chunk):
            m = min(chunk, n - lo)
            low = torch.from_numpy(rng.rand(m, 3, max(2, height // 24),
                                            max(2, width // 24))
                                   .astype(np.float32))
            imgs = (F.interpolate(low, size=(height, width),
                                  mode="bilinear", align_corners=False)
                    * 160 + 48).clamp(0, 255).to(torch.uint8) \
                .permute(0, 2, 3, 1).contiguous().numpy()
            for k, rec in enumerate(pool.map(pack, range(lo, lo + m),
                                             list(imgs))):
                w.write_idx(lo + k, rec)
    w.close()
    return time.perf_counter() - t0


def _pulls(it, depths):
    """The batches of `it`, recording io.record.queue_depth as each pull
    sampled it."""
    from mxnet_tpu_torch.observability import registry
    gauge = registry.gauge("io.record.queue_depth")
    while True:
        try:
            batch = next(it)
        except StopIteration:
            return
        depths.append(gauge.get())
        yield batch


def record_train(dev, card, train_img_s):
    """train_imagenet.py's composition on the card, at ResNet-50's full
    width: 1536 seeded synthetic 500x375 RGB images in a .rec (JPEG q90
    where PIL is there, else NPY records) -> mx.io.ImageRecordIter
    (data_shape (3, 224, 224), b128, NHWC, shuffle, rand_crop, rand_mirror,
    ImageNet's mean/std, preprocess_threads=8, round_batch=False) ->
    ShardedTrainer.prefetched
    -> ShardedTrainer.step on its CUDA graph (bf16 over fp32 masters, SGD
    momentum 0.9, wd 1e-4, lr 0.1), as the `train` phase sets it up.
    Prints the reader and the decoder, the host's CPU count, the loader
    alone (one epoch, no training) and end to end (10 steps after 2
    warm-up steps of a new epoch) in img/s beside `train`'s img/s of this
    call, io.batch_wait.seconds a step, the device busy share of a
    profiled window and io.record.queue_depth at each pull. Gates: each
    record once an epoch (read back through the ids), finite losses, 360
    conv1x1_wgmma_kernel and 10 sgd_momentum_kernel launches over the
    profiled window's 10 replays, and the native reader wherever the
    native library builds. Returns {"replays": the profiler's counts,
    "capture": the wrappers' counts over the first epoch}."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _native, ops, recordio
    from mxnet_tpu_torch.convert import init_resnet_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.observability import registry
    from mxnet_tpu_torch.parallel import ShardedTrainer, data_parallel
    from mxnet_tpu_torch.resilience import numerics
    cfg = RECORD
    n_img, batch = cfg["images"], BATCH
    epoch_steps = n_img // batch
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rec_")
    try:
        path = os.path.join(tmp, "train.rec")
        try:
            import PIL  # noqa: F401
            encoding = "jpeg q%d (PIL)" % cfg["quality"]
        except ImportError:
            encoding = "npy (pack_img without PIL)"
        write_s = write_records(path, n_img, cfg["height"], cfg["width"], 0,
                                cfg["classes"], cfg["quality"])
        rec_bytes = os.path.getsize(path)
        t = time.perf_counter()
        lib = _native.ensure_built()
        native_s = time.perf_counter() - t
        native_jpeg = lib is not None and hasattr(lib, "MXTPUImdecodeJPEG")
        build_log = ""
        if lib is not None and not native_jpeg:
            log = os.path.join(_native.build_dir(), "build.log")
            if os.path.exists(log):
                with open(log) as f:
                    build_log = f.read()[-300:]
        # the ids in the corner blocks are the records' own
        reader = recordio.MXIndexedRecordIO(
            os.path.splitext(path)[0] + ".idx", path, "r")
        for i in range(0, n_img, cfg["check_every"]):
            header, img = recordio.unpack_img(reader.read_idx(i), 1)
            if header.id != i or int(header.label[1]) != i or \
                    _read_id_blocks(img) != i:
                fail("record_train: record %d reads back id %d, label %s, "
                     "corner id %d" % (i, header.id, header.label,
                                       _read_id_blocks(img)))
        reader.close()
        # normalized by ImageNet's channel means and deviations, as
        # MXNet's image-classification examples feed ImageRecordIter
        kw = dict(path_imgrec=path, data_shape=(3, IMG, IMG),
                  batch_size=batch, layout="NHWC", shuffle=True,
                  rand_crop=True, rand_mirror=True,
                  preprocess_threads=cfg["threads"], round_batch=False,
                  mean_r=123.68, mean_g=116.28, mean_b=103.53,
                  std_r=58.395, std_g=57.12, std_b=57.375)

        # the loader alone: one epoch, ids [class, id], no training
        t = time.perf_counter()
        it = mx.io.ImageRecordIter(label_width=2, **kw)
        ids, first_ms, depths_alone = [], None, []
        for b in _pulls(it, depths_alone):
            if first_ms is None:
                first_ms = (time.perf_counter() - t) * 1e3
            x = b.data[0]
            if tuple(x.shape) != (batch, IMG, IMG, 3) or \
                    x.dtype != np.float32:
                fail("record_train: loader batch %s %s" % (x.shape,
                                                          x.dtype))
            ids.extend(int(v) for v in b.label[0].asnumpy()[:, 1])
        loader_s = time.perf_counter() - t
        it.close()
        reader_kind, decoders = it.reader, dict(it.decoders)
        if sorted(ids) != list(range(n_img)):
            fail("record_train: the loader's epoch served %d ids, %d "
                 "distinct, want each of %d once"
                 % (len(ids), len(set(ids)), n_img))
        if lib is not None and reader_kind != "native":
            fail("record_train: the native library built but the iterator "
                 "read through %s" % reader_kind)
        loader_img_s = n_img / loader_s
        # the loader alone at fewer decode threads: how it scales
        by_threads = {cfg["threads"]: loader_img_s}
        for threads in (1, 2, 4):
            t = time.perf_counter()
            it = mx.io.ImageRecordIter(**dict(kw, preprocess_threads=threads))
            n = sum(b.data[0].shape[0] for b in it)
            by_threads[threads] = n / (time.perf_counter() - t)
            it.close()

        # training through the iterator
        torch.cuda.reset_peak_memory_stats()
        net = resnet50_v1(layout="NHWC", device=dev)
        init_resnet_params(net, seed=0)
        st = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 1e-4}, compute_dtype="bfloat16",
                            device=dev)
        if not st._graph_on:
            fail("record_train: the trainer is not on its CUDA-graph step")
        it = mx.io.ImageRecordIter(**kw)
        wait = registry.histogram("io.batch_wait.seconds")

        def run(n_steps=None, on_step=None, depths=None):
            pf = st.prefetched(_pulls(it, depths if depths is not None
                                      else []))
            losses = []
            try:
                for k, staged in enumerate(pf):
                    if n_steps is not None and k == n_steps:
                        break
                    losses.append(st.step(*staged))
                    if on_step is not None:
                        on_step(k)
            finally:
                pf.close()
            return torch.stack(losses).float().cpu().numpy() if losses \
                else np.zeros(0)

        # epoch 1, the main path: counts at 0 just before, read just after
        # (the graph's warm-up steps and its capture call the wrappers; its
        # replays call none, and the profiler counts them below)
        numerics.drain_flags()
        depths_train = []
        ops.reset_launch_counts()
        t = time.perf_counter()
        losses1 = run(depths=depths_train)
        epoch1_s = time.perf_counter() - t
        capture = ops.launch_counts()
        calls = data_parallel._WARMUP + 1
        if capture["conv1x1_bn_stats"] != 36 * calls or \
                capture["fused_sgd_momentum"] != calls:
            fail("record_train: the first epoch's wrappers launched %s, "
                 "want %d conv1x1_bn_stats and %d fused_sgd_momentum (the "
                 "graph's warm-up and capture)" % (capture, 36 * calls,
                                                   calls))
        if len(losses1) != epoch_steps:
            fail("record_train: %d steps in the first epoch, want %d"
                 % (len(losses1), epoch_steps))

        # epoch 2: end to end over 10 steps after 2 warm-up steps
        it.reset()
        mark = {}

        def on_step(k):
            if k in (cfg["warm"] - 1, cfg["warm"] + cfg["steps"] - 1):
                torch.cuda.synchronize()
                mark[k] = (time.perf_counter(), wait.sum())
        losses2 = run(n_steps=cfg["warm"] + cfg["steps"], on_step=on_step)
        (t0, w0), (t1, w1) = mark[cfg["warm"] - 1], \
            mark[cfg["warm"] + cfg["steps"] - 1]
        e2e_s = t1 - t0
        wait_s = (w1 - w0) / cfg["steps"]
        e2e_img_s = batch * cfg["steps"] / e2e_s
        guard = numerics.drain_flags()
        losses = np.concatenate([losses1, losses2])
        if not np.isfinite(losses).all() or guard["skipped_steps"]:
            fail("record_train: losses %s, numerics %s" % (losses, guard))

        # a profiled window of 10 replays: the launches and the busy share
        want = {"conv1x1_bn_stats": 36 * cfg["steps"],
                "fused_sgd_momentum": cfg["steps"]}
        for _ in range(10):
            it.reset()
            t = time.perf_counter()
            events = device_events(lambda: run(n_steps=cfg["steps"]), 1)
            window_s = time.perf_counter() - t
            replayed = {k: sum(c for name, (_, c) in events.items()
                               if any(part in name for part in parts))
                        for k, parts in KERNEL_NAMES.items()}
            if all(replayed[k] >= v for k, v in want.items()):
                break
            print("chip_smoke: record_train's profile saw %s, want %s"
                  % (replayed, want), file=sys.stderr, flush=True)
        numerics.drain_flags()
        wgmma = sum(c for name, (_, c) in events.items()
                    if "conv1x1_wgmma_kernel" in name)
        if replayed["conv1x1_bn_stats"] != want["conv1x1_bn_stats"] or \
                wgmma != want["conv1x1_bn_stats"] or \
                replayed["fused_sgd_momentum"] != want["fused_sgd_momentum"]:
            fail("record_train: the profiler saw %s (%d conv1x1_wgmma_kernel)"
                 " over %d replays, want %s, all conv1x1 on wgmma"
                 % (replayed, wgmma, cfg["steps"], want))
        dev_us = {k: us for k, (us, _) in events.items()}
        window_device_ms = sum(dev_us.values()) / 1e3
        step_device_ms = window_device_ms / cfg["steps"]
        it.close()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        emit(phase="record_train", card=card,
             model="ResNet-50 v1, NHWC, seeded random weights (Uniform "
             "0.07)", batch=batch, image=IMG, dtype="bf16 compute, fp32 "
             "master", records=n_img, record_size=[cfg["height"],
                                                    cfg["width"]],
             encoding=encoding, rec_mb=rec_bytes / 1e6,
             write_records_s=write_s, native_library_s=native_s,
             native_library=lib is not None, native_jpeg=native_jpeg,
             native_build_log_tail=build_log, reader=reader_kind,
             decoders=decoders, host_cpus=os.cpu_count(),
             host_cpus_usable=len(os.sched_getaffinity(0)),
             preprocess_threads=cfg["threads"],
             loader_alone_img_s=loader_img_s,
             loader_alone_img_s_by_threads=by_threads,
             loader_alone_first_batch_ms=first_ms,
             loader_alone_epoch_s=loader_s,
             end_to_end_img_s=e2e_img_s, train_img_s_same_call=train_img_s,
             end_to_end_over_train=e2e_img_s / train_img_s
             if train_img_s else None,
             end_to_end_steps=cfg["steps"], warm_steps=cfg["warm"],
             end_to_end_s=e2e_s, first_epoch_s=epoch1_s,
             batch_wait_s_per_step=wait_s,
             device_ms_per_step=step_device_ms,
             device_busy_share=step_device_ms * cfg["steps"] / 1e3 / e2e_s,
             profiled_window_s=window_s,
             profiled_window_device_ms=window_device_ms,
             profiled_window_busy_share=window_device_ms / 1e3 / window_s,
             device_ms_by_kind=by_kind(dev_us, cfg["steps"]),
             queue_depth_at_each_pull=dict(
                 loader_alone=depths_alone, first_epoch=depths_train),
             ids_once_per_epoch=True, losses=losses.tolist(),
             replays_launches=replayed, capture_launches=capture,
             peak_mem_gb=peak_gb)
        del st, net
        return {"replays": replayed, "capture": capture}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def record_module(dev, card):
    """Module.fit over an ImageRecordIter on the card: 256 seeded 40x40
    images (class-coloured, JPEG) -> ImageRecordIter (32 px crops, b16,
    NHWC, fp32, shuffle, rand_crop, rand_mirror, mean/std 128/64) ->
    Module.fit (its prefetch loop stages each batch on the card) over the
    narrow ResNet V1 symbol (tools/torch_resnet_symbol.py, units [1, 1],
    widths [16, 32, 64], 10 classes), SGD lr 0.05 momentum 0.9, 2 epochs.
    NHWC, since the executor rewrites only a 1x1 NHWC convolution before
    a training BatchNorm (fp32: conv1x1_simt_kernel). Gates: finite
    losses, the second epoch's mean loss below the first's, 6
    conv1x1_bn_stats launches a step and one fused_sgd_momentum launch a
    SGD group. Returns the wrappers' counts."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.observability import registry
    cfg = RECORD_MODULE
    groups = registry.counter("optimizer.fused.groups")
    resnet_v1_symbol = _load_script(RESNET_SYMBOL).resnet_v1_symbol
    tmp = tempfile.mkdtemp(prefix="chip_smoke_recmod_")
    try:
        path = os.path.join(tmp, "m.rec")
        write_records(path, cfg["images"], cfg["side"], cfg["side"], 1,
                      cfg["classes"], RECORD["quality"], class_pattern=True)
        it = mx.io.ImageRecordIter(
            path_imgrec=path, data_shape=(3, cfg["img"], cfg["img"]),
            batch_size=cfg["batch"], layout="NHWC", shuffle=True,
            rand_crop=True, rand_mirror=True, preprocess_threads=4,
            mean_r=128.0, mean_g=128.0, mean_b=128.0, std_r=64.0,
            std_g=64.0, std_b=64.0)
        with mx.name.NameManager():
            sym = resnet_v1_symbol(mx, units=(1, 1), filters=(16, 32, 64),
                                   num_classes=cfg["classes"])
        mod = mx.mod.Module(sym, context=mx.gpu(0))
        losses, cb = _step_losses()
        groups0 = groups.get()
        mx.random.seed(3)
        ops.reset_launch_counts()
        t = time.perf_counter()
        mod.fit(it, num_epoch=cfg["epochs"], eval_metric="ce",
                batch_end_callback=cb, initializer=mx.init.Xavier(
                    magnitude=2.0), optimizer="sgd", optimizer_params={
                    "learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})
        wall = time.perf_counter() - t
        launches = ops.launch_counts()
        sgd_groups = groups.get() - groups0
        it.close()
        steps = cfg["epochs"] * (cfg["images"] // cfg["batch"])
        per_epoch = len(losses) // cfg["epochs"]
        first, second = np.mean(losses[:per_epoch]), \
            np.mean(losses[per_epoch:])
        if len(losses) != steps or not np.isfinite(losses).all() or \
                not second < first:
            fail("record_module: %d losses (want %d), epoch means %g, %g"
                 % (len(losses), steps, first, second))
        if launches["conv1x1_bn_stats"] != 6 * steps or \
                launches["fused_sgd_momentum"] != sgd_groups or \
                sgd_groups < steps:
            fail("record_module: launches %s over %d steps (%d SGD groups), "
                 "want %d conv1x1_bn_stats and one fused_sgd_momentum per "
                 "group" % (launches, steps, sgd_groups, 6 * steps))
        emit(phase="record_module", card=card, steps=steps,
             batch=cfg["batch"], image=cfg["img"], dtype="fp32",
             layout="NHWC", reader=it.reader, decoders=dict(it.decoders),
             img_s=steps * cfg["batch"] / wall, wall_s=wall,
             epoch_mean_losses=[float(first), float(second)],
             launches=launches, sgd_groups=sgd_groups)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 5b: the rest of serving — ModelServer of both kinds, the module
# predict path, ModelRegistry and the HTTP Gateway
# ---------------------------------------------------------------------------
MODEL_SERVER = dict(clients=16, rounds=4, bucket=32, bf16_tol=2e-2,
                    mixed=(1, 3, 7, 12, 20, 31))


def _client_threads(n, work):
    """Run work(i) on n threads started together; the wall seconds from
    the first start to the last finish, and work's results by i."""
    out, errors = [None] * n, []
    gate = threading.Barrier(n + 1)

    def run(i):
        gate.wait()
        try:
            out[i] = work(i)
        except BaseException as err:  # noqa: BLE001 — reported below
            errors.append(err)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail("model_server: a client failed: %r" % (errors[0],))
    return wall, out


def _http(url, payload=None, timeout=300):
    """(status, JSON body) of a GET, or of a POST of `payload`."""
    import urllib.error
    import urllib.request
    req = url if payload is None else urllib.request.Request(
        url, data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode("utf-8"))
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode("utf-8"))


def _http_stream(url, payload, timeout=300):
    import urllib.request
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return [json.loads(line) for line in
                r.read().decode("utf-8").splitlines()]


def model_server(ops, dev, card, served):
    """The serving stack a user runs, on the card.

    (a) `ModelServer` over a `DecodeEngine` at `serve`'s configuration
    (GPT-2-small width, `serve`'s seeded weights, 8 slots, its 8 prompts,
    32 new tokens), in fp32 and in bf16, each driven by 16 client threads
    at once (thread i submits prompt i % 8): fp32 tokens identical to
    `serve`'s sequential decoding, bf16 tokens identical to a sequential
    bf16 engine; the profiler sees the flash-attention and LayerNorm
    kernels under the server. (b) `InferenceEngine.from_block` over
    ResNet-50 v1 (train's net, seeded, predict mode) at 224 px NHWC bf16,
    buckets up to 32, behind `ModelServer` from 16 client threads: 32-row
    responses bit-identical to `engine.infer` at that bucket, mixed sizes
    within 2e-2 of it (scaled by its largest magnitude), a 1..32 sweep
    after warmup builds nothing, `Deadline(0)` is refused, and a SIGTERM
    under `handle_signals` drains. (c) A Module bound for prediction
    answers through its frozen engine what its executor answers; a
    `Gateway` over a `ModelRegistry` of (a) and (b) on 127.0.0.1:0."""
    import gc
    import signal
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.observability import registry as obs
    from mxnet_tpu_torch.resilience import Deadline, DeadlineExceeded
    from mxnet_tpu_torch.serving import (DecodeEngine, Gateway,
                                         InferenceEngine, ModelRegistry,
                                         ModelServer, RequestRejected)
    cfg = MODEL_SERVER
    gc.collect()
    torch.cuda.empty_cache()
    # the device lease the servers and the gateway hold on a card: in a
    # directory of this run's own
    lease_dir = tempfile.mkdtemp(prefix="model_server_lease")
    os.environ["MXTPU_LEASE_PATH"] = os.path.join(lease_dir, "dev.lease")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    blk, prompts, oracle = served["blk"], served["prompts"], served["oracle"]
    # bf16 is held to bf16: a sequential bf16 engine's tokens
    seq_bf16 = DecodeEngine(blk, max_slots=SLOTS, dtype="bf16", device=dev,
                            name="seq_bf16")
    oracle_bf16 = sequential_tokens(seq_bf16, prompts)
    del seq_bf16
    mx.random.seed(0)
    with mx.name.NameManager():
        net = resnet50_v1(classes=1000, layout="NHWC", device=dev)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2))
    rng = np.random.RandomState(5)
    xs = [rng.randn(cfg["bucket"], IMG, IMG, 3).astype(np.float32)
          for _ in range(4)]
    builds = obs.REGISTRY.get("serving.engine.compiles")
    rec = dict(phase="model_server", card=card)

    # the main path, with every launch counter at 0 just before it
    ops.reset_launch_counts()
    t_phase = time.perf_counter()

    # (a) the decode kind
    decode = {}
    for dtype, want in (("fp32", oracle), ("bf16", oracle_bf16)):
        engine = DecodeEngine(blk, max_slots=SLOTS, dtype=dtype, device=dev,
                              name="gpt2_%s" % dtype)
        srv = ModelServer(engine, max_new_tokens=NEW_TOKENS,
                          warmup=True).start()
        handles = [None] * cfg["clients"]

        def client(i, srv=srv, handles=handles):
            handles[i] = srv.submit(prompts[i % len(prompts)])
            return handles[i].result(timeout=600)
        wall, toks = _client_threads(cfg["clients"], client)
        for i, got in enumerate(toks):
            if not np.array_equal(np.asarray(got, np.int32),
                                  want[i % len(prompts)]):
                fail("model_server %s: client %d's tokens %s != "
                     "sequential %s" % (dtype, i, list(got),
                                        list(want[i % len(prompts)])))
        seen = device_launches(
            lambda srv=srv: srv.generate(prompts[0], max_new_tokens=2,
                                         timeout=300),
            1, {"flash_attention": 12, "layer_norm": 50})
        if not (seen["flash_attention"] and seen["layer_norm"]):
            fail("model_server %s: the profiler saw %s under the server"
                 % (dtype, seen))
        stats = srv.stats()
        if not srv.drain(timeout=300):
            fail("model_server %s: the decode server did not drain" % dtype)
        ttft = [h.ttft() * 1e3 for h in handles]
        n_tok = sum(len(t) for t in toks)
        decode[dtype] = dict(
            clients=cfg["clients"], tokens=n_tok, wall_s=wall,
            tok_s=n_tok / wall, ttft_ms_p50=percentile(ttft, 50),
            ttft_ms_p95=percentile(ttft, 95),
            tokens_identical_to_sequential=True,
            profiled_generate_launches={
                k: seen[k] for k in ("flash_attention", "layer_norm")},
            lease_held=bool(stats["lease"] and stats["lease"]["held"]),
            device_bytes=engine.device_bytes())
        del srv, engine
    rec["decode"] = decode
    rec["serve_tok_s"] = served["tok_s"]

    # (b) the bucketed kind
    example = torch.zeros(1, IMG, IMG, 3, device=dev)
    engine = InferenceEngine.from_block(
        net, example, max_batch_size=cfg["bucket"], dtype="bf16",
        name="resnet50")
    conv0 = ops.launch_counts()["conv1x1_bn_stats"]
    srv = ModelServer(engine, max_wait_ms=2.0, warmup=True).start()
    warm = sum(builds.get(engine="resnet50", bucket=str(b))
               for b in engine.buckets)
    for n in range(1, cfg["bucket"] + 1):
        out = srv.infer(xs[0][:n], timeout=300)[0]
        if out.shape != (n, 1000) or not np.isfinite(out).all():
            fail("model_server: %d rows gave %s" % (n, out.shape))
    swept = sum(builds.get(engine="resnet50", bucket=str(b))
                for b in engine.buckets)
    if warm != len(engine.buckets) or swept != warm:
        fail("model_server: %d graph builds after warmup, %d after the "
             "1..32 sweep, want %d and no more" % (warm, swept,
                                                   len(engine.buckets)))
    rounds = cfg["rounds"]
    wall, outs = _client_threads(cfg["clients"], lambda i: [
        srv.infer(xs[(i + r) % len(xs)], timeout=300)[0]
        for r in range(rounds)])
    direct = [engine.infer(x)[0].asnumpy() for x in xs]
    for i, got in enumerate(outs):
        for r, o in enumerate(got):
            if o.tobytes() != direct[(i + r) % len(xs)].tobytes():
                fail("model_server: a 32-row response differs from "
                     "engine.infer at bucket 32 by %g" % np.abs(
                         o - direct[(i + r) % len(xs)]).max())
    mixed = cfg["mixed"]
    _, mouts = _client_threads(len(mixed), lambda i: srv.infer(
        xs[1][:mixed[i]], timeout=300)[0])
    mixed_err = 0.0
    for n, o in zip(mixed, mouts):
        ref = engine.infer(xs[1][:n])[0].asnumpy()
        mixed_err = max(mixed_err, float(np.abs(o - ref).max()
                                         / np.abs(ref).max()))
    if mixed_err > cfg["bf16_tol"]:
        fail("model_server: mixed-size responses %g from engine.infer "
             "(tol %g)" % (mixed_err, cfg["bf16_tol"]))
    try:
        srv.infer(xs[0][:1], deadline=Deadline(0.0), timeout=60)
        fail("model_server: Deadline(0) was served")
    except DeadlineExceeded:
        pass
    # the engine alone at b32 (a device batch: no host copy), by events,
    # and its device time by the profiler
    x32 = torch.from_numpy(xs[0]).to(dev)
    direct_ms = cuda_ms(lambda: engine.infer(x32), iters=10)
    dev_ms = device_ms(lambda: engine.infer(x32), n=2, tries=20)
    batches = cfg["clients"] * rounds
    img_s = batches * cfg["bucket"] / wall
    stats = srv.stats()
    # SIGTERM under handle_signals: in flight finishes, new work refused
    with srv.handle_signals():
        flight = [srv.submit(xs[k % len(xs)]) for k in range(8)]
        signal.raise_signal(signal.SIGTERM)
        t0 = time.monotonic()
        while not srv.draining and time.monotonic() - t0 < 30:
            time.sleep(0.005)
        try:
            srv.submit(xs[0][:1])
            fail("model_server: a submit after SIGTERM was accepted")
        except RequestRejected:
            pass
        done = [h.result(timeout=300)[0].shape for h in flight]
        drained = srv.drain(timeout=300)
    if not drained or done != [(cfg["bucket"], 1000)] * 8:
        fail("model_server: SIGTERM drain %s, in-flight results %s"
             % (drained, done))
    conv1x1 = ops.launch_counts()["conv1x1_bn_stats"] - conv0
    rec["bucketed"] = dict(
        model="ResNet-50 v1, NHWC, 224 px, bf16, predict mode",
        buckets=list(engine.buckets), clients=cfg["clients"],
        batches=batches, wall_s=wall, img_s=img_s,
        engine_b32_img_s=cfg["bucket"] / direct_ms * 1e3,
        engine_b32_ms=direct_ms, device_ms_b32=dev_ms,
        device_busy_share=dev_ms * batches / (wall * 1e3)
        if dev_ms else None,
        responses_bit_identical_to_infer=True,
        mixed_sizes_max_rel_err=mixed_err, mixed_tol=cfg["bf16_tol"],
        builds_after_warmup=swept - warm,
        deadline0_refused=True, sigterm_drained=True,
        conv1x1_bn_stats_launches=conv1x1,
        lease_held=bool(stats["lease"] and stats["lease"]["held"]),
        request_latency_p50_s=stats["request_latency_p50_s"],
        request_latency_p95_s=stats["request_latency_p95_s"],
        device_bytes=engine.device_bytes())
    del srv

    # (c) Module's predict path through its frozen engine
    resnet_v1_symbol = _load_script(RESNET_SYMBOL).resnet_v1_symbol
    with mx.name.NameManager():
        sym = resnet_v1_symbol(mx, units=(1, 1), filters=(16, 32, 64),
                               num_classes=10)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mod.bind([("data", (16, 32, 32, 3))], for_training=False)
    mx.random.seed(3)
    mod.init_params(mx.init.Xavier(magnitude=2.0))
    xb = mx.io.DataBatch([mx.nd.array(
        rng.randn(16, 32, 32, 3).astype(np.float32), ctx=mx.gpu(0))])
    mod.forward(xb, is_train=False)
    via_engine = mod.get_outputs()[0].asnumpy()
    if not mod._serving_engine_obj:
        fail("model_server: Module predict did not freeze an engine")
    os.environ["MXTPU_SERVING_ENGINE"] = "0"
    try:
        mod.forward(xb, is_train=False)
        via_executor = mod.get_outputs()[0].asnumpy()
    finally:
        del os.environ["MXTPU_SERVING_ENGINE"]
    if via_engine.tobytes() != via_executor.tobytes():
        fail("model_server: Module predict through the engine differs "
             "from the executor by %g" % np.abs(via_engine -
                                                via_executor).max())
    rec["module_predict_equals_executor"] = True

    # the Gateway over a ModelRegistry of both kinds
    gate = threading.Event()

    def gated(build):
        def builder():
            gate.wait(600)
            return build()
        return builder
    reg = ModelRegistry()
    reg.register("resnet50", gated(lambda: InferenceEngine.from_block(
        net, example, max_batch_size=cfg["bucket"], dtype="bf16",
        name="gw_resnet50")), eager=True, max_wait_ms=2.0)
    reg.register("gpt2", gated(lambda: DecodeEngine(
        blk, max_slots=SLOTS, device=dev, name="gw_gpt2")), eager=True,
        max_new_tokens=NEW_TOKENS)
    gw = Gateway(reg, port=0, device=dev)
    boot = threading.Thread(target=gw.start, daemon=True)
    boot.start()
    t0 = time.monotonic()
    while not gw._started and time.monotonic() - t0 < 60:
        time.sleep(0.01)
    early = (_http(gw.url + "/readyz")[0], _http(gw.url + "/healthz")[0])
    gate.set()
    boot.join(600)
    ready = _http(gw.url + "/readyz")
    if early != (503, 200) or ready[0] != 200 or \
            sorted(ready[1]["resident"]) != ["gpt2", "resnet50"]:
        fail("model_server: /readyz, /healthz during the eager warm-ups "
             "%s, after %s" % (early, ready))
    try:
        x1 = xs[2][:1]
        st, predicted = _http(gw.url + "/v1/models/resnet50:predict",
                              {"inputs": x1.tolist()})
        direct1 = reg.get("resnet50").engine.infer(x1)[0].asnumpy()
        got1 = np.asarray(predicted["outputs"][0], np.float32) \
            if st == 200 else None
        if got1 is None or got1.tobytes() != direct1.tobytes():
            fail("model_server: /predict %s is not byte-identical to "
                 "infer" % st)
        st, body = _http(gw.url + "/v1/models/gpt2:generate",
                         {"tokens": prompts[0].tolist()})
        lines = _http_stream(gw.url + "/v1/models/gpt2:generate",
                             {"tokens": prompts[0].tolist(),
                              "stream": True})
        streamed = [line["token"] for line in lines if "token" in line]
        if st != 200 or body["tokens"] != streamed or \
                streamed != oracle[0].tolist():
            fail("model_server: /generate %s: %s, streamed %s, sequential "
                 "%s" % (st, body, streamed, oracle[0].tolist()))
        sizes = {m: reg.stats()["models"][m]["bytes"]
                 for m in ("resnet50", "gpt2")}
        small, big = sorted(sizes.values())
        reloads0 = reg.stats()["reloads"]
        # only the smaller model fits: each load evicts the other, and the
        # larger one stays resident only while it is the one just loaded
        reg.set_budget(budget_bytes=(small + big) // 2)
        resident = [reg.resident()]
        st1, again1 = _http(gw.url + "/v1/models/resnet50:predict",
                            {"inputs": x1.tolist()})
        resident.append(reg.resident())
        st2, again2 = _http(gw.url + "/v1/models/gpt2:generate",
                            {"tokens": prompts[0].tolist()})
        resident.append(reg.resident())
        reloads = reg.stats()["reloads"] - reloads0
        expect = [[] if sizes["gpt2"] > sizes["resnet50"] else ["gpt2"],
                  ["resnet50"], ["gpt2"]]
        if resident != expect or reloads != 2 or \
                (st1, st2) != (200, 200) or \
                again1["outputs"] != predicted["outputs"] or \
                again2["tokens"] != oracle[0].tolist():
            fail("model_server: under a budget between %s, resident %s, "
                 "reloads %d, answers %s %s" % (sizes, resident, reloads,
                                                st1, st2))
        reg.set_budget(budget_bytes=0)
        gw_lease = bool(_http(gw.url + "/healthz")[1]["lease"])
    finally:
        gate.set()
        closed = gw.close(timeout=300)
    if not closed:
        fail("model_server: the gateway did not drain")
    rec["gateway"] = dict(
        readyz_during_warmup=early[0], healthz_during_warmup=early[1],
        predict_byte_identical=True, generate_stream_identical=True,
        budget_bytes=(small + big) // 2, model_bytes=sizes,
        resident_under_budget=resident, reloads=reloads,
        lease_held=gw_lease)
    launches = ops.launch_counts()
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    if not (launches["flash_attention"] and launches["layer_norm"]):
        fail("model_server: launches %s" % launches)
    torch.backends.cudnn.deterministic = deterministic
    del os.environ["MXTPU_LEASE_PATH"]
    emit(**rec)
    return launches


# ---------------------------------------------------------------------------
# phase 29: the training planes (step records, the numerics guard, chaos,
# preemption, the gang supervisor, the profiler)
# ---------------------------------------------------------------------------
PLANES = dict(steps=TRAIN_STEPS, nan_at=3, nan_steps=6, profile_steps=2,
              narrow_steps=6, sigterm_at=3, kill_after=5, nan_after=3,
              patience=2, collective_budget_s=60, timeout_s=300)
# what every JAX-schema step record holds (mxnet_tpu/observability/
# telemetry.py:337-347, the phases and the batch)
STEP_RECORD_KEYS = {"ts", "source", "step", "step_time", "data_wait",
                    "compile_count", "compile_seconds", "kvstore_bytes",
                    "batch_size", "samples_per_sec"}


def _records(path, source="gluon.trainer"):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if source is None or r.get("source") == source]


def _weights_and_momenta(net, trainer):
    """Copies of the trained parameters (not the running statistics) and
    of the optimizer's state tensors."""
    out = [p.data().detach().clone() for p in net.collect_params().values()
           if p.grad_req != "null"]
    for st in trainer._updaters[0].states.values():
        for t in (st if isinstance(st, (list, tuple)) else (st,)):
            if isinstance(t, torch.Tensor):
                out.append(t.detach().clone())
    return out


def _tensors_equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _tool(name, *args):
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.run([sys.executable, os.path.join(here, "tools", name),
                           *args], capture_output=True, text=True,
                          timeout=120)


def planes_full(dev, card, tmp):
    """planes (a): ResNet-50 b128 NHWC bf16 through gluon.Trainer under
    MXTPU_TELEMETRY (module docstring, phase 29)."""
    import gc
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, ops, profiler
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.observability import registry, telemetry
    from mxnet_tpu_torch.resilience import chaos
    cfg = PLANES
    gc.collect()
    torch.cuda.empty_cache()
    t_setup = time.perf_counter()
    mx.random.seed(0)
    net = resnet50_v1(layout="NHWC", device=dev)
    net.initialize()
    net.cast("bfloat16")

    def make_trainer():
        return mx.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
            "multi_precision": True,
            "lr_scheduler": mx.lr_scheduler.FactorScheduler(step=5,
                                                            factor=0.5)})
    trainer = make_trainer()
    os.environ["MXTPU_NUMERICS"] = "0"
    trainer_off = make_trainer()          # made with the guard off
    del os.environ["MXTPU_NUMERICS"]
    if trainer.numerics is None or trainer_off.numerics is not None:
        fail("planes: the guard should be on by default and off under "
             "MXTPU_NUMERICS=0 (on: %s, off: %s)"
             % (trainer.numerics, trainer_off.numerics))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(BATCH, IMG, IMG, 3).astype("float32")) \
        .to(dev).to(torch.bfloat16)
    y = torch.from_numpy((rng.rand(BATCH) * 1000).astype("float32")).to(dev)
    torch.stack([gluon_loop(net, trainer, loss_fn, x, y)
                 for _ in range(GLUON_WARM)]).cpu()
    params, states = (os.path.join(tmp, "net.params"),
                      os.path.join(tmp, "trainer.states"))
    net.save_parameters(params)
    trainer.save_states(states)
    setup_s = time.perf_counter() - t_setup

    groups = registry.counter("optimizer.fused.groups")
    windows = {}
    # the guard-on trainer's windows back to back: a record's deltas run
    # from its timer's previous step, which another trainer's window
    # would land in
    for mode, tr in (("on", trainer), ("on_again", trainer),
                     ("off", trainer_off)):
        net.load_parameters(params)
        tr.load_states(states)
        if mode == "off":
            os.environ["MXTPU_NUMERICS"] = "0"
        stream = os.path.join(tmp, "planes_%s.jsonl" % mode)
        os.environ["MXTPU_TELEMETRY"] = stream
        torch.cuda.synchronize()
        g0, grp0 = guard_counts(), groups.get()
        # the main path, with every launch counter at 0 just before it
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        losses = torch.stack([gluon_loop(net, tr, loss_fn, x, y)
                              for _ in range(cfg["steps"])]).cpu()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        del os.environ["MXTPU_TELEMETRY"]
        os.environ.pop("MXTPU_NUMERICS", None)
        telemetry.close_stream()
        recs = _records(stream)
        windows[mode] = dict(
            losses=losses, state=_train_state(net, tr), wall=wall,
            launches=launches, sgd_groups=groups.get() - grp0,
            guard=guard_since(g0), records=recs, stream=stream,
            img_s=BATCH * cfg["steps"] / wall,
            numerics_ms=[r["numerics_time"] * 1e3 for r in recs
                         if "numerics_time" in r],
            # the fused step's phase is named "step", so its time is what
            # the record's step_time holds (as in the JAX package)
            step_phase_ms=[r["step_time"] * 1e3 for r in recs])
    on, off, again = windows["on"], windows["off"], windows["on_again"]
    bit_identical = all(
        torch.equal(on["losses"], w["losses"]) and _tensors_equal(on["state"],
                                                         w["state"])
        for w in (off, again))
    if not bit_identical:
        fail("planes: the guard changed a clean run: losses on %s, off %s, "
             "on again %s" % (on["losses"].tolist(), off["losses"].tolist(),
                              again["losses"].tolist()))
    if not torch.isfinite(on["losses"]).all() or on["guard"]["skipped_steps"] \
            or on["guard"]["anomalies"]:
        fail("planes: losses %s, guard %s" % (on["losses"].tolist(),
                                              on["guard"]))
    for mode, w in windows.items():
        recs = w["records"]
        # a trainer made under MXTPU_NUMERICS=0 has no guard, no phase
        want = STEP_RECORD_KEYS | ({"numerics_time"} if mode != "off"
                                   else set())
        missing = [sorted(want - set(r)) for r in recs
                   if not want <= set(r)]
        if len(recs) != cfg["steps"] or missing or any(
                r.get("step_dispatches") != 1 for r in recs):
            fail("planes %s: %d gluon.trainer records for %d steps, "
                 "missing keys %s, step_dispatches %s" % (
                     mode, len(recs), cfg["steps"], missing[:2],
                     [r.get("step_dispatches") for r in recs]))
        lc = w["launches"]
        if lc["conv1x1_bn_stats"] != 36 * cfg["steps"] or \
                lc["fused_sgd_momentum"] != w["sgd_groups"] or \
                w["sgd_groups"] != cfg["steps"]:
            fail("planes %s: launches %s and %d SGD groups over %d steps, "
                 "want 36 conv1x1_bn_stats a step and one fused_sgd_momentum "
                 "launch a step" % (mode, lc, w["sgd_groups"],
                                     cfg["steps"]))
    report = _tool("telemetry_report.py", "--json", on["stream"])
    gate = _tool("perf_gate.py", on["stream"], "--max-skipped-steps", "0",
                 "--max-dispatches-per-step", "1")
    summary = json.loads(report.stdout) if report.returncode == 0 else None
    if summary is None or summary.get("steps") != cfg["steps"] or \
            gate.returncode != 0:
        fail("planes: telemetry_report rc %d (%s), perf_gate rc %d (%s %s)"
             % (report.returncode, report.stderr[-500:], gate.returncode,
                gate.stdout[-500:], gate.stderr[-500:]))

    # the NaN drill: a loss-scaled run, grad.post poisoned at step k only
    k = cfg["nan_at"]
    net.load_parameters(params)
    trainer.load_states(states)
    stream = os.path.join(tmp, "planes_nan.jsonl")
    os.environ["MXTPU_TELEMETRY"] = stream
    os.environ["MXTPU_CHAOS"] = "grad.post:kind=nan,after=%d,n=1" % k
    chaos.reset()
    snaps, scales, stats = [], [], []
    try:
        for i in range(cfg["nan_steps"]):
            snaps.append(_weights_and_momenta(net, trainer))
            stats.append(running_stats(net))
            with autograd.record():
                loss = loss_fn(net(x), y)
                scaled = trainer.scale_loss(loss)
            scaled.backward()
            trainer.step(BATCH)
            scales.append(trainer.loss_scale)
        snaps.append(_weights_and_momenta(net, trainer))
        torch.cuda.synchronize()
    finally:
        del os.environ["MXTPU_CHAOS"]
        del os.environ["MXTPU_TELEMETRY"]
        chaos.reset()
        telemetry.close_stream()
    nan_recs = _records(stream)
    events = [r for r in _records(stream, None)
              if r.get("event") == "numerics_skip"]
    skipped_identical = _tensors_equal(snaps[k], snaps[k + 1])
    neighbours_moved = not _tensors_equal(snaps[k - 1], snaps[k]) and \
        not _tensors_equal(snaps[k + 1], snaps[k + 2])
    stats_moved = any(not torch.equal(stats[k][n], stats[k + 1][n])
                      for n in stats[k])
    nan_gate = _tool("perf_gate.py", stream, "--max-skipped-steps", "0")
    if not (skipped_identical and neighbours_moved) or \
            scales[k - 1] != 2 * scales[k] or \
            [r.get("skipped_steps", 0) for r in nan_recs] != \
            [int(i == k) for i in range(cfg["nan_steps"])] or \
            len(events) != 1 or nan_gate.returncode != 1:
        fail("planes NaN drill: step %d skipped bit-identically %s, steps "
             "around it moved %s, loss scales %s, records' skipped_steps %s, "
             "numerics_skip events %d, perf_gate rc %d" % (
                 k, skipped_identical, neighbours_moved, scales,
                 [r.get("skipped_steps", 0) for r in nan_recs], len(events),
                 nan_gate.returncode))

    # mx.profiler over 2 steps: one chrome trace with the kernels and spans
    kernels, spans, prof_path = {}, set(), None
    for attempt in range(3):
        profiler.set_config(filename=os.path.join(tmp, "profile%d"
                                                  % attempt))
        profiler.set_state("run")
        torch.stack([gluon_loop(net, trainer, loss_fn, x, y)
                     for _ in range(cfg["profile_steps"])]).cpu()
        torch.cuda.synchronize()
        prof_path = profiler.dump()
        with open(prof_path) as f:
            trace = json.load(f)["traceEvents"]
        kernels = {}
        for e in trace:
            if e.get("cat") == "kernel":
                name = e.get("name", "")
                for tag in ("conv1x1_wgmma_kernel", "sgd_momentum_kernel"):
                    if tag in name:
                        kernels[tag] = kernels.get(tag, 0) + 1
        spans = {e.get("name", "").split("[")[0] for e in trace
                 if e.get("name", "").startswith("step/")}
        if len(kernels) == 2:
            break
    if len(kernels) != 2 or not {"step/step", "step/numerics"} <= spans:
        fail("planes: mx.profiler's trace %s holds kernels %s and spans %s; "
             "want conv1x1_wgmma_kernel, sgd_momentum_kernel, step/step "
             "and step/numerics" % (prof_path, kernels, sorted(spans)))
    def per_step(v):
        return [float(np.mean(v)), float(np.max(v))] if v else None
    return on["launches"], dict(
        model="ResNet-50 v1, NHWC, b128 at 224 px, net.cast(bfloat16), "
        "multi_precision SGD through gluon.Trainer", setup_s=setup_s,
        steps=cfg["steps"], img_s_guard_on=on["img_s"],
        img_s_guard_off=off["img_s"], img_s_guard_on_again=again["img_s"],
        step_ms_guard_on=on["wall"] / cfg["steps"] * 1e3,
        step_ms_guard_off=off["wall"] / cfg["steps"] * 1e3,
        step_ms_guard_on_again=again["wall"] / cfg["steps"] * 1e3,
        numerics_phase_ms_mean_max=per_step(on["numerics_ms"]),
        numerics_phase_ms_mean_max_again=per_step(again["numerics_ms"]),
        step_phase_ms_mean_max=per_step(on["step_phase_ms"]),
        guard_on_equals_off_bit_for_bit=bit_identical,
        records_per_window=len(on["records"]),
        record_keys=sorted(on["records"][0]),
        telemetry_report=summary, perf_gate=json.loads(gate.stdout),
        launches=on["launches"], sgd_groups=on["sgd_groups"],
        nan_drill=dict(step=k, skipped_bit_identical=skipped_identical,
                       running_stats_moved_by_the_forward=stats_moved,
                       loss_scales=scales,
                       skipped_steps=[r.get("skipped_steps", 0)
                                      for r in nan_recs],
                       numerics_skip_events=len(events),
                       perf_gate_rc=nan_gate.returncode),
        profiler=dict(path=os.path.basename(prof_path), attempts=attempt + 1,
                      kernel_events=kernels, spans=sorted(spans)))


def _drill(here, tmp, name, n, extra_env, *args, supervise=True):
    """Start one narrow drill: tests/torch_gang_worker.py, under
    tools/torch_launch.py --supervise unless `supervise` is False."""
    d = os.path.join(tmp, name)
    os.makedirs(d, exist_ok=True)
    worker = [sys.executable, os.path.join(here, "tests",
                                           "torch_gang_worker.py"),
              "--model", "resnet", "--device", "cuda", "--steps",
              str(PLANES["narrow_steps"]), "--ckpt-dir",
              os.path.join(d, "ck"), "--out", os.path.join(d, "o"), *args]
    cmd = worker if not supervise else [
        sys.executable, os.path.join(here, "tools", "torch_launch.py"),
        "-n", str(n), "--supervise", "--gang-dir", os.path.join(d, "gang")
    ] + worker
    env = dict(os.environ, MXTPU_DIST_BACKEND="gloo",
               MXTPU_RESTART_BACKOFF_S="0.1", MXTPU_GANG_KILL_GRACE_S="5",
               MXTPU_GANG_PEER_POLL_S="0.2",
               MXTPU_WATCHDOG_COLLECTIVE_S=str(PLANES["collective_budget_s"]),
               **extra_env)
    for k in ("MXTPU_TELEMETRY", "MXTPU_CHAOS"):
        env.pop(k, None)
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, start_new_session=True)
    return dict(name=name, dir=d, proc=proc, n=n, t0=time.perf_counter())


def _finish_drill(drill, deadline):
    import signal
    proc = drill["proc"]
    try:
        out, _ = proc.communicate(timeout=max(1.0, deadline -
                                              time.perf_counter()))
    except subprocess.TimeoutExpired:
        out = b"timed out"
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    log = out.decode(errors="replace")
    reports = [json.loads(line.split(" ", 1)[1]) for line in
               log.splitlines() if line.startswith("GANG_REPORT ")]
    events = []
    for r in range(drill["n"]):
        events += _records(os.path.join(drill["dir"], "o.r%d.jsonl" % r),
                           None)
    return dict(rc=proc.returncode, log=log, seconds=time.perf_counter() -
                drill["t0"], report=reports[-1] if reports else None,
                digests=sorted({e["digest"] for e in events
                                if e["event"] == "done"}),
                stats0=[e["stats_digest"] for e in events
                        if e["event"] == "done" and e["rank"] == 0],
                starts=[e for e in events if e["event"] == "start"])


def planes_narrow(tmp):
    """planes (b): the recovery drills on train_small's net, fp32, each a
    child of its own (module docstring, phase 29)."""
    cfg = PLANES
    here = os.path.dirname(os.path.abspath(__file__))
    deadline = time.perf_counter() + cfg["timeout_s"]
    drills = [
        _drill(here, tmp, "ref1", 1, {}, supervise=False),
        _drill(here, tmp, "preempt", 1, {}, "--sigterm-at",
               str(cfg["sigterm_at"]), supervise=False),
        _drill(here, tmp, "ref2", 2, {}),
        _drill(here, tmp, "gang", 2, {
            "MXTPU_CHAOS_RANK_1": "worker.kill:kind=kill,after=%d"
            % cfg["kill_after"]}),
        _drill(here, tmp, "diverge", 1, {
            "MXTPU_DIVERGE_PATIENCE": str(cfg["patience"]),
            "MXTPU_CHAOS_RANK_0": "grad.post:kind=nan,after=%d,n=%d"
            % (cfg["nan_after"], cfg["patience"])})]
    res = {d["name"]: _finish_drill(d, deadline) for d in drills}
    # the preempted child's relaunch resumes from its checkpoint
    t0 = time.perf_counter()
    res["resume"] = _finish_drill(_drill(here, tmp, "preempt", 1, {},
                                         supervise=False), deadline)
    resume_s = time.perf_counter() - t0

    def why(name):
        r = res[name]
        return "%s rc %s after %.1f s: %s" % (name, r["rc"], r["seconds"],
                                              r["log"][-3000:])
    for name in ("ref1", "ref2"):
        if res[name]["rc"] != 0 or len(res[name]["digests"]) != 1:
            fail("planes: uninterrupted run %s" % why(name))
    ref1, ref2 = res["ref1"]["digests"][0], res["ref2"]["digests"][0]
    pre, resume = res["preempt"], res["resume"]
    # the trained weights and momenta of every rank, and rank 0's running
    # statistics (the checkpoint's), bit-identical to the uninterrupted run
    if pre["rc"] != 75 or resume["rc"] != 0 or \
            resume["digests"] != [ref1] or \
            resume["stats0"] != res["ref1"]["stats0"] or \
            resume["starts"][-1]["restored_step"] != cfg["sigterm_at"]:
        fail("planes preemption: %s; %s" % (why("preempt"), why("resume")))
    gang, rep = res["gang"], res["gang"]["report"]
    if gang["rc"] != 0 or rep is None or rep["restarts"] != 1 or \
            gang["digests"] != [ref2] or \
            gang["stats0"] != res["ref2"]["stats0"] or \
            rep["incidents"][0]["rank_exit_codes"]["0"] != 76 or \
            "gang peer rank 1 is lost" not in gang["log"] or \
            any(s["rank_chaos"] for s in gang["starts"]
                if s["generation"] > 0):
        fail("planes gang restart: %s" % why("gang"))
    div, drep = res["diverge"], res["diverge"]["report"]
    if div["rc"] != 0 or drep is None or drep["restarts"] != 1 or \
            drep["incidents"][0]["exit_code"] != 77 or \
            drep["incidents"][0]["action"] != "restart (rolled back)" or \
            div["digests"] != [ref1] or \
            div["stats0"] != res["ref1"]["stats0"]:
        fail("planes divergence rollback: %s" % why("diverge"))
    inc = rep["incidents"][0]
    return dict(
        model="narrow NHWC ResNet V1 (BottleneckV1, [1, 1], [16, 32, 64]), "
        "fp32, global batch 8 at 32 px, %d steps, gluon.Trainer SGD"
        % cfg["narrow_steps"],
        preemption=dict(exit_code=pre["rc"], preempted_s=pre["seconds"],
                        resumed_from=resume["starts"][-1]["restored_step"],
                        resume_s=resume_s, bit_identical=True),
        gang_restart=dict(
            ranks=2, backend="gloo (CUDA tensors host-staged)",
            restarts=rep["restarts"], incident_rank=inc["rank"],
            rank_exit_codes=inc["rank_exit_codes"],
            downtime_s=inc["downtime_s"],
            collective_budget_s=cfg["collective_budget_s"],
            resumed_from=[s["restored_step"] for s in gang["starts"]
                          if s["generation"] == 1],
            gang_s=gang["seconds"], uninterrupted_gang_s=res["ref2"][
                "seconds"], bit_identical=True),
        divergence=dict(
            patience=cfg["patience"], exit_code=77,
            action=drep["incidents"][0]["action"],
            restored_to=[s["restored_step"] for s in div["starts"]],
            downtime_s=drep["incidents"][0]["downtime_s"],
            run_s=div["seconds"], uninterrupted_s=res["ref1"]["seconds"],
            bit_identical=True))


def planes(dev, card):
    """Phase 29: the training planes at full width (a) and the recovery
    drills (b). Returns the guard-on window's launches."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="planes")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        launches, full = planes_full(dev, card, tmp)
        full_s = time.perf_counter() - t0
        narrow = planes_narrow(tmp)
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase="planes", card=card, seconds=time.perf_counter() - t0,
         full_width_s=full_s, full_width=full, narrow=narrow)
    return launches


def main():
    # a stalled phase shows where it stalls: every 10 minutes, all stacks
    faulthandler.dump_traceback_later(600, repeat=True)
    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    emit(phase="device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # phase 2: build
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for name in ("flash_attention", "layer_norm", "sgd_momentum",
                 "conv1x1_bn_stats"):
        with open("%s/%s.log" % (_build.build_dir(), name)) as f:
            print_ptxas(f.read())
    def sass_of(name):
        return subprocess.run(
            [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"),
             "--dump-sass", os.path.join(_build.build_dir(), name + ".so")],
            capture_output=True, text=True, check=True, timeout=300).stdout

    def count(sass, op):
        return sum(op in line for line in sass.splitlines())

    # the tensor cores are in use: mma.sync compiles to HMMA; the conv1x1
    # main path is wgmma (HGMMA) fed by TMA loads (UTMALDG)
    sass = sass_of("flash_attention")
    hmma = count(sass, "HMMA")
    if not hmma:
        fail("no HMMA instruction in the flash-attention library")
    conv_sass = sass_of("conv1x1_bn_stats")
    conv_ops = {op: count(conv_sass, op)
                for op in ("HGMMA", "UTMALDG", "UTMASTG")}
    if not (conv_ops["HGMMA"] and conv_ops["UTMALDG"]):
        fail("conv1x1_bn_stats library: %s, want HGMMA and UTMALDG"
             % conv_ops)
    emit(phase="build", seconds=build_s, dir=_build.build_dir(),
         flash_attention_hmma_instructions=hmma,
         flash_attention_sass_d64=sass_mix(sass, ",64>"),
         conv1x1_bn_stats_sass=conv_ops)

    # phase 3: kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for T in FLASH_T:
            rows.append(check_flash(ops, dev, T, dtype, gen))
        rows.append(check_flash(ops, dev, 1000, dtype, gen, strided=True))
        rows.append(check_flash(ops, dev, 1024, dtype, gen, causal=False))
        rows.append(check_flash(ops, dev, 1024, dtype, gen, batch=8))
        for n in (8, 1024):
            rows.append(check_layer_norm(ops, dev, n, dtype, gen))
        for shape in CONV1X1_SHAPES:
            rows.append(check_conv1x1(ops, dev, *shape, dtype, gen))
    # ResNet-50's whole parameter list, as the train step hands it over
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    r50_shapes = [tuple(p.shape) for p in
                  resnet50_v1(layout="NHWC", device="cpu").parameters()]
    rows.append(check_sgd(ops, dev, r50_shapes, torch.float32, gen))
    rows.append(check_sgd(ops, dev, r50_shapes[:40], torch.bfloat16, gen))
    mx_rows = [check_sgd_mxnet(ops, dev, r50_shapes, mp, gen)
               for mp in (False, True)]
    for r in rows + mx_rows:
        emit(phase="kernel", card=card, **r)
    # before the training phases: their long profiles leave the profiler
    # dropping records of later large launches
    conv1x1_paths(ops, dev, gen, card)
    conv_per = conv1x1_per_forward(ops, dev, gen, card)
    # the Module path's fp32 calls (module_train): the CUDA-core kernel
    conv_module = conv1x1_per_forward(
        ops, dev, gen, card, phase="kernel_module_shape",
        expect="conv1x1_simt_kernel", dtype=torch.float32)
    # zoo_train's MobileNet shapes (bf16)
    conv_mobilenet = conv1x1_per_forward(
        ops, dev, gen, card, mobilenet_conv1x1_calls(BATCH, IMG),
        phase="kernel_mobilenet_shape")

    # phases 4, 5: the model
    small_model_check(dev)
    served = serve(dev, card)
    launches = served["launches"]
    # phase 5b: the rest of serving, before the training phases, whose
    # long profiles leave the profiler dropping records
    server_launches = model_server(ops, dev, card, served)
    # phase 29: the training planes, before the training phases' long
    # profiles (its mx.profiler trace must hold the kernels' records)
    planes_launches = planes(dev, card)

    # phases 6, 7: training
    train_small(dev)
    train_launches = train(dev, card)
    api_launches = sharded_api(dev, card)
    # phases 8, 9: the Gluon loop
    gluon_small(dev)
    gluon_launches, gluon_img_s = gluon_train(dev, card)
    # phases 10-13: the eager array layer (mx.nd)
    nd_sweep(dev)
    flash_nd = nd_flash(ops, dev, card, gen)
    nd_save(dev)
    gpt_nd = nd_gpt(ops, dev, card, gen)
    # phases 14-16: Gluon breadth
    cifar_launches = gluon_cifar(ops, dev, card)
    zoo_launches, mobilenet = zoo_train(ops, dev, card, gen,
                                        conv_mobilenet)
    ln_gluon = gluon_layers(ops, dev, card, gen)
    # phases 17-22: Symbol, the executor, CachedOp and the Module API
    module_small(dev)
    module_launches = module_train(dev, card)
    hybrid_launches = hybrid_train(dev, card)
    sym_score(dev, card)
    mnist_launches = mnist(ops, dev, card)
    hyb_layers = gluon_layers_hybridized(ops, dev, card)
    # phases 23-24: the distributed KVStore and the fused step
    small_dist_launches = dist_small(dev, card)
    dist_launches = dist_train(dev, card, gluon_img_s)
    # phases 25-26: ShardedTrainer across processes
    sharded_launches = dist_sharded(dev, card, train_launches["first_window"])
    sharded_small_launches = dist_sharded_small(dev, card)
    # phases 27-28: the record-file input pipeline
    record_launches = record_train(dev, card,
                                   train_launches["first_window"]["img_s"])
    record_module_launches = record_module(dev, card)
    by_path = {name: {"train": train_launches["graph_replays"][name],
                      "train_graph_capture":
                          train_launches["graph_capture"][name],
                      "train_eager": train_launches["eager"][name],
                      "sharded_api": api_launches["replays"][name],
                      "sharded_api_wrappers": api_launches["wrappers"][name],
                      "gluon_train": gluon_launches[name],
                      "nd_gpt": gpt_nd["launches"][name],
                      "gluon_cifar": cifar_launches[name],
                      "zoo_train": zoo_launches[name],
                      "module_train": module_launches[name],
                      "hybrid_train": hybrid_launches[name],
                      "mnist": mnist_launches[name],
                      "dist_small": small_dist_launches[name],
                      "dist_train": dist_launches[name],
                      "dist_sharded": sharded_launches[name]["replays"],
                      "dist_sharded_capture":
                          sharded_launches[name]["capture"],
                      "dist_sharded_small": sharded_small_launches[name],
                      "record_train": record_launches["replays"][name],
                      "record_train_capture":
                          record_launches["capture"][name],
                      "record_module": record_module_launches[name],
                      "model_server": server_launches[name],
                      "planes": planes_launches[name]}
               for name in ("fused_sgd_momentum", "conv1x1_bn_stats")}
    by_path["layer_norm"] = {"serve": launches["layer_norm"],
                             "model_server": server_launches["layer_norm"],
                             "nd_gpt": gpt_nd["launches"]["layer_norm"],
                             "gluon_layers": ln_gluon["launches"],
                             "gluon_layers_hybridized":
                                 hyb_layers["layer_norm"]}
    by_path["flash_attention"] = {
        "serve": launches["flash_attention"],
        "model_server": server_launches["flash_attention"],
        "nd_flash": flash_nd["launches"],
        "nd_gpt": gpt_nd["launches"]["flash_attention"],
        "gluon_layers_hybridized": hyb_layers["flash_attention"]}
    launches.update({name: sum(v.values()) for name, v in by_path.items()})

    # the main path's own shapes in its serving dtype (fp32)
    main_shape = {"flash_attention": [1, 12, 1024, 64],
                  "layer_norm": [1024, 768]}
    sources = {"flash_attention": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                                   "mxnet_tpu/ops/pallas_kernels.py:109"),
               "layer_norm": ("mxnet_tpu_torch/csrc/layer_norm.cu",
                              "mxnet_tpu/ops/pallas_kernels.py:184"),
               "fused_sgd_momentum": (
                   "mxnet_tpu_torch/csrc/sgd_momentum.cu",
                   "mxnet_tpu/ops/pallas_kernels.py:259"),
               "conv1x1_bn_stats": (
                   "mxnet_tpu_torch/csrc/conv1x1_bn_stats.cu",
                   "mxnet_tpu/ops/pallas_kernels.py:319")}
    kernels = []
    for name in ("flash_attention", "layer_norm"):
        r = next(r for r in rows if r["name"] == name and
                 r["shape"] == main_shape[name] and r["dtype"] ==
                 str(torch.float32) and not r.get("strided") and
                 r.get("causal", True))
        kernels.append(dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1], launches=launches[name],
            max_abs_err=max(x["max_abs_err"] for x in rows
                            if x["name"] == name and
                            x["dtype"] == str(torch.float32)),
            ms=r["kernel_ms"], device_ms=r["device_ms"],
            plain_ms=r["plain_ms"],
            bound_ms=r["bound_us"] / 1e3, bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            library_device_ms=r["library_device_ms"], shape=r["shape"],
            dtype="fp32", launches_by_path=by_path[name]))
    # the mx.nd call sites: LayerNorm over nd_gpt's (8192, 768) rows, and
    # the flash op at (8, 12, 1024, 64) with its plain-vjp backward
    ln = gpt_nd["ln_row"]
    kernels[1]["nd_gpt"] = dict(
        shape=ln["shape"], dtype="fp32", max_abs_err=ln["max_abs_err"],
        ms=ln["kernel_ms"], device_ms=ln["device_ms"],
        plain_ms=ln["plain_ms"], bound_ms=ln["bound_us"] / 1e3,
        bound_by=ln["bound_by"], library_ms=ln["library_ms"],
        library_device_ms=ln["library_device_ms"])
    kernels[0]["nd_flash"] = flash_nd["rows"]
    # gluon.nn.LayerNorm at the same rows, one launch a forward
    kernels[1]["gluon_layers"] = dict(
        shape=ln_gluon["shape"], dtype="fp32",
        max_abs_err=max(ln_gluon["max_abs_err"],
                        ln_gluon["layer_max_abs_err"]),
        launches=ln_gluon["launches"], ms=ln_gluon["kernel_ms"],
        layer_ms=ln_gluon["layer_ms"], device_ms=ln_gluon["device_ms"],
        plain_ms=ln_gluon["plain_ms"], bound_ms=ln_gluon["bound_us"] / 1e3,
        bound_by=ln_gluon["bound_by"], library_ms=ln_gluon["library_ms"],
        library_device_ms=ln_gluon["library_device_ms"])
    # the update: ResNet-50's 193 tensors in one launch, in the m-form
    # (ShardedTrainer, fp32) and in MXNet's form (gluon.Trainer, mp bf16)
    r = next(r for r in rows if r["name"] == "fused_sgd_momentum" and
             r["dtype"] == str(torch.float32))
    rm = mx_rows[1]

    def form(row, n, path):
        return dict(launches=n, path=path, max_abs_err=row["max_abs_err"],
                    ms=row["kernel_ms"], device_ms=row["device_ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_us"] / 1e3,
                    bound_by=row["bound_by"], library_ms=row["library_ms"],
                    library_device_ms=row["library_device_ms"],
                    shape=row["shape"], dtype=row["dtype"])
    kernels.append(dict(
        name="fused_sgd_momentum", route="cuda",
        source=sources["fused_sgd_momentum"][0],
        replaces=sources["fused_sgd_momentum"][1],
        launches=launches["fused_sgd_momentum"],
        max_abs_err=max(r["max_abs_err"], rm["max_abs_err"]),
        ms=r["kernel_ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_us"] / 1e3, bound_by=r["bound_by"],
        library_ms=r["library_ms"],
        library_device_ms=r["library_device_ms"], shape=r["shape"],
        dtype="fp32", per="train step (m-form; MXNet's form in forms)",
        forms={"m": form(r, by_path["fused_sgd_momentum"]["train"],
                         "train (ShardedTrainer)"),
               "mxnet": form(rm, by_path["fused_sgd_momentum"]
                             ["gluon_train"], "gluon_train (gluon.Trainer)"),
               "mxnet_fp32": form(mx_rows[0], 0, "kernel phase only"),
               "mxnet_one_tensor": dict(
                   gpt_nd["sgd_row"], path="nd_gpt (nd.sgd_mom_update, one "
                   "launch per weight, summed over the 148)",
                   launches=by_path["fused_sgd_momentum"]["nd_gpt"],
                   bound_ms=gpt_nd["sgd_row"]["bound_us"] / 1e3)},
        launches_by_path=by_path["fused_sgd_momentum"]))
    # the train forward's 36 calls in bf16, timed shape by shape, summed
    kernels.append(dict(
        name="conv1x1_bn_stats", route="cuda",
        source=sources["conv1x1_bn_stats"][0],
        replaces=sources["conv1x1_bn_stats"][1],
        launches=launches["conv1x1_bn_stats"], max_abs_err=conv_per["err"],
        ms=conv_per["ms"], device_ms=conv_per["device_ms"],
        plain_ms=conv_per["plain_ms"], bound_ms=conv_per["bound_ms"],
        bound_by="bytes" if conv_per["t_bytes"] >= conv_per["t_ops"]
        else "operations",
        library_ms=conv_per["library_ms"],
        library_device_ms=conv_per["library_device_ms"],
        shape="ResNet-50 b128 forward, "
        "36 calls, %d shapes" % conv_per["shapes"], dtype="bf16",
        per="train forward", launches_by_path=by_path["conv1x1_bn_stats"],
        mobilenet=dict(
            shape="MobileNet-1.0 b128 NHWC forward, %d calls, %d shapes"
            % (mobilenet["calls"], mobilenet["shapes"]), dtype="bf16",
            per="zoo_train forward",
            launches=by_path["conv1x1_bn_stats"]["zoo_train"],
            max_abs_err=mobilenet["err"], ms=mobilenet["ms"],
            device_ms=mobilenet["device_ms"],
            device_ms_in_step=mobilenet["device_ms_in_step"],
            plain_ms=mobilenet["plain_ms"],
            bound_ms=mobilenet["bound_ms"],
            bound_by="bytes" if mobilenet["t_bytes"] >= mobilenet["t_ops"]
            else "operations", library_ms=mobilenet["library_ms"],
            library_device_ms=mobilenet["library_device_ms"],
            kernels=mobilenet["kernels"]),
        module=dict(
            shape="ResNet-50 b128 NHWC forward through Module, %d calls, "
            "%d shapes" % (conv_module["calls"], conv_module["shapes"]),
            dtype="fp32", per="module_train forward",
            launches=by_path["conv1x1_bn_stats"]["module_train"],
            max_abs_err=conv_module["err"], ms=conv_module["ms"],
            device_ms=conv_module["device_ms"],
            plain_ms=conv_module["plain_ms"],
            bound_ms=conv_module["bound_ms"],
            bound_by="bytes" if conv_module["t_bytes"] >=
            conv_module["t_ops"] else "operations",
            library_ms=conv_module["library_ms"],
            library_device_ms=conv_module["library_device_ms"],
            kernels=conv_module["kernels"])))
    emit(kernels=kernels)
    print(card_line(), flush=True)
    faulthandler.cancel_dump_traceback_later()
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
