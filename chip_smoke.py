#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases; any failure exits non-zero before the final line:

1. device  — needs CUDA; prints the card's name and power limit.
2. build   — compiles the kernels from mxnet_tpu_torch/csrc with nvcc
             (sm_90a) and prints the build seconds and ptxas reports.
3. kernels — holds each kernel against its plain PyTorch version on the
             card, in fp32 and bf16, at the shapes the GPT and ResNet-50
             paths give it (the momentum update over ResNet-50's whole
             parameter list), and times the kernel, the plain version
             and one PyTorch library call, beside the least time the card
             could take.
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
             ShardedTrainer on the card (through the kernels) and on the
             CPU (plain versions) from the same seeded weights: per-step
             losses and final parameters must agree.
7. train   — ResNet-50 v1 at full width, NHWC, batch 128 at 224x224,
             bf16 compute over fp32 master parameters, SGD momentum 0.9
             through ShardedTrainer.step_many, as bench.py's _train_tput
             sets it up: a warm window, then a timed one. Losses finite and
             falling, no step skipped, and exactly 36 conv1x1_bn_stats and
             1 fused_sgd_momentum launches per step; img/s, step ms, peak
             memory, MFU and a torch.profiler breakdown of one step.

It ends with a JSON line of the kernels, the card's nvidia-smi line, and
``{"ok": true, "device": {...}}``. Float32 matrix products run in full
fp32: TF32 is switched off for matmuls and cuDNN.
"""
import faulthandler
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12          # CUDA-core fp32, no tensor cores
BF16_FLOP_S = 989e12         # dense bf16 tensor cores
PEAKS = "HBM 3.35 TB/s, fp32 67 TFLOP/s, bf16 989 TFLOP/s (H100 SXM)"

GPT2_SMALL = dict(vocab_size=50257, max_seq_len=1024, num_layers=12,
                  num_heads=12, embed_dim=768, mlp_ratio=4)
PROMPT_LENS = (17, 64, 130, 255, 300, 511, 700, 990)
NEW_TOKENS = 32
SLOTS = 8
TOL = {("flash_attention", torch.float32): 1e-4,
       ("flash_attention", torch.bfloat16): 2e-2,
       ("layer_norm", torch.float32): 1e-4,
       ("layer_norm", torch.bfloat16): 2e-2,
       # w and m after one update; bf16 w: as tests/test_pallas.py:82-98
       ("fused_sgd_momentum", torch.float32): 1e-5,
       ("fused_sgd_momentum", torch.bfloat16): 2e-2,
       # y (in units of max|y| for bf16: one bf16 ulp), mean, var; the
       # statistics are fp32 sums in another order on both sides
       ("conv1x1_bn_stats", torch.float32): (1e-4, 1e-5, 1e-4),
       ("conv1x1_bn_stats", torch.bfloat16): (2 ** -7, 1e-4, 1e-3)}
SGD_HP = dict(lr=0.1, momentum=0.9, wd=1e-4)
# ResNet-50's 1x1 convolutions at batch 128 (M, Cin, Cout), and a ragged M
CONV1X1_SHAPES = [(401408, 64, 256), (401408, 256, 64), (100352, 512, 128),
                  (6272, 2048, 512), (300, 64, 256)]
BATCH, IMG, TRAIN_STEPS = 128, 224, 10
FLOPS_PER_IMG = 3 * 4.089e9     # fwd + bwd, as bench.py:784 counts them


def emit(**rec):
    print(json.dumps(rec), flush=True)


def fail(msg):
    print("chip_smoke: FAIL: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


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


def device_events(fn, n):
    """Run fn() n times under torch.profiler (device activity only);
    returns {kernel or copy name: (device microseconds, launches)} over
    the n runs. Empty when the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def profiled(fn, n):
    """{kernel or copy name: device microseconds over n runs of fn()}."""
    return {k: us for k, (us, _) in device_events(fn, n).items()}


def kernel_device_ms(fn, kernel, n=10, launches=1, tries=3):
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


_KINDS = (("conv1x1_bn_stats", ("conv1x1_", "bn_stats_finalize")),
          ("fused_sgd_momentum", ("sgd_momentum_kernel",)),
          ("GEMM / convolution (cuBLAS, cuDNN)",
           ("gemm", "xmma", "cutlass", "conv", "wgrad", "dgrad", "sm90_",
            "sm80_", "cudnn")),
          ("copies and casts", ("copy",)),
          ("reductions", ("reduce",)),
          ("elementwise", ("elementwise", "pool", "Memset")))


def by_kind(dev_us, n):
    """Device milliseconds per call of the profiled items, summed into
    the classes of _KINDS (first match wins) and "other"."""
    out = {}
    for name, us in dev_us.items():
        kind = next((k for k, keys in _KINDS
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
def check_flash(ops, dev, T, dtype, gen):
    import torch.nn.functional as F
    shape = (1, 12, T, 64)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ref = ops.attention_plain(q, k, v, causal=True)
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[("flash_attention", dtype)]
    if not np.isfinite(err) or err > tol:
        fail("flash_attention %s %s: max abs err %g > %g"
             % (shape, dtype, err, tol))
    elem = q.element_size()
    B, H, _, D = shape
    nbytes = 4 * B * H * T * D * elem
    flops = 2 * B * H * T * (T + 1) * D   # causal j <= i, q.k and p.v
    peak = FP32_FLOP_S if dtype == torch.float32 else BF16_FLOP_S
    return dict(
        name="flash_attention", shape=list(shape), dtype=str(dtype),
        max_abs_err=err, tol=tol,
        kernel_ms=cuda_ms(lambda: ops.flash_attention(q, k, v, True)),
        plain_ms=cuda_ms(lambda: ops.attention_plain(q, k, v, True)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        device_ms=kernel_device_ms(
            lambda: ops.flash_attention(q, k, v, True), "flash_fwd_kernel"),
        bytes=nbytes, flops=flops, peak_flop_s=peak,
        **bound(nbytes, flops, peak))


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
    return dict(
        name="layer_norm", shape=[rows, D], dtype=str(dtype),
        max_abs_err=err, tol=tol,
        kernel_ms=cuda_ms(lambda: ops.layer_norm(x, g, b, 1e-5)),
        plain_ms=cuda_ms(lambda: ops.layer_norm_plain(x, g, b, 1e-5)),
        library_ms=cuda_ms(lambda: F.layer_norm(x, (D,), g, b, 1e-5)),
        device_ms=kernel_device_ms(lambda: ops.layer_norm(x, g, b, 1e-5),
                                   "layer_norm_kernel"),
        bytes=nbytes, flops=flops, peak_flop_s=FP32_FLOP_S,
        **bound(nbytes, flops, FP32_FLOP_S))


def check_sgd(ops, dev, shapes, wdtype, gen):
    """fused_sgd_momentum over every tensor of `shapes` in one launch
    (w, g in `wdtype`, m fp32) against sgd_momentum_plain per tensor."""
    ws = [(torch.randn(s, generator=gen, device=dev) * 0.05).to(wdtype)
          for s in shapes]
    gs = [(torch.randn(s, generator=gen, device=dev) * 0.01).to(wdtype)
          for s in shapes]
    ms = [torch.randn(s, generator=gen, device=dev) * 0.01 for s in shapes]
    want = [ops.sgd_momentum_plain(w, g, m, **SGD_HP)
            for w, g, m in zip(ws, gs, ms)]
    ops.fused_sgd_momentum(ws, gs, ms, **SGD_HP)
    torch.cuda.synchronize()
    err = max(max((w.float() - a.float()).abs().max().item(),
                  (m - b).abs().max().item())
              for w, m, (a, b) in zip(ws, ms, want))
    tol = TOL[("fused_sgd_momentum", wdtype)]
    if not np.isfinite(err) or err > tol:
        fail("fused_sgd_momentum %d tensors, w %s: max abs err %g > %g"
             % (len(shapes), wdtype, err, tol))
    n = sum(w.numel() for w in ws)
    welem = ws[0].element_size()
    nbytes = n * (3 * welem + 2 * 4)       # w, g, m read; w, m written
    flops = 7 * n
    library_ms = None
    if wdtype == torch.float32:
        # the same update by PyTorch's fused SGD (its momentum buffers
        # start from the first step's gradient; the time is what counts)
        params = [torch.nn.Parameter(w.clone()) for w in ws]
        for p, g in zip(params, gs):
            p.grad = g
        opt = torch.optim.SGD(params, lr=SGD_HP["lr"],
                              momentum=SGD_HP["momentum"], dampening=0,
                              weight_decay=SGD_HP["wd"], fused=True)
        library_ms = cuda_ms(opt.step)
    return dict(
        name="fused_sgd_momentum", shape=[len(shapes), n], dtype=str(wdtype),
        max_abs_err=err, tol=tol,
        kernel_ms=cuda_ms(lambda: ops.fused_sgd_momentum(ws, gs, ms,
                                                         **SGD_HP)),
        plain_ms=cuda_ms(lambda: [ops.sgd_momentum_plain(w, g, m, **SGD_HP)
                                  for w, g, m in zip(ws, gs, ms)]),
        library_ms=library_ms,
        device_ms=kernel_device_ms(
            lambda: ops.fused_sgd_momentum(ws, gs, ms, **SGD_HP),
            "sgd_momentum_kernel"),
        bytes=nbytes, flops=flops, peak_flop_s=FP32_FLOP_S,
        **bound(nbytes, flops, FP32_FLOP_S))


def check_conv1x1(ops, dev, M, cin, cout, dtype, gen):
    """conv1x1_bn_stats against conv1x1_bn_stats_plain at (M, Cin, Cout),
    and the times of the kernel, the plain version and the library
    yardstick (torch.matmul + torch.var_mean in x's dtype)."""
    x = torch.randn(M, cin, generator=gen, device=dev).to(dtype)
    w = (torch.randn(cin, cout, generator=gen, device=dev)
         / math.sqrt(cin)).to(dtype)
    got = ops.conv1x1_bn_stats(x, w)
    torch.cuda.synchronize()
    want = ops.conv1x1_bn_stats_plain(x, w)
    errs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(got, want)]
    tols = list(TOL[("conv1x1_bn_stats", dtype)])
    if dtype == torch.bfloat16:
        tols[0] *= max(1.0, want[0].float().abs().max().item())
    if not all(np.isfinite(errs)) or any(e > t for e, t in zip(errs, tols)):
        fail("conv1x1_bn_stats (%d, %d, %d) %s: max abs err y/mean/var %s "
             "> %s" % (M, cin, cout, dtype, errs, tols))
    del got, want
    elem = x.element_size()
    nbytes = (M * cin + cin * cout + M * cout) * elem + 8 * cout
    flops = 2 * M * cin * cout + 3 * M * cout
    peak = FP32_FLOP_S if dtype == torch.float32 else BF16_FLOP_S
    return dict(
        name="conv1x1_bn_stats", shape=[M, cin, cout], dtype=str(dtype),
        max_abs_err=max(errs), errs_y_mean_var=errs, tols_y_mean_var=tols,
        kernel_ms=cuda_ms(lambda: ops.conv1x1_bn_stats(x, w)),
        plain_ms=cuda_ms(lambda: ops.conv1x1_bn_stats_plain(x, w)),
        library_ms=cuda_ms(lambda: torch.var_mean(
            torch.matmul(x, w), dim=0, correction=0)),
        device_ms=kernel_device_ms(lambda: ops.conv1x1_bn_stats(x, w),
                                   ("conv1x1_", "bn_stats_finalize_kernel"),
                                   launches=2),
        bytes=nbytes, flops=flops, peak_flop_s=peak,
        **bound(nbytes, flops, peak))


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


def conv1x1_per_forward(ops, dev, gen, card):
    """conv1x1_bn_stats at each shape of one ResNet-50 b128 training
    forward, in bf16, checked and timed shape by shape (each row emitted)
    and summed over the forward's 36 calls."""
    calls = resnet50_conv1x1_calls()
    per = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0, t_bytes=0.0, t_ops=0.0, err=0.0,
               shapes=len(calls))
    for (M, cin, cout), n in calls.items():
        r = check_conv1x1(ops, dev, M, cin, cout, torch.bfloat16, gen)
        emit(phase="kernel_main_shape", card=card, calls_per_forward=n, **r)
        for key, src in (("ms", "kernel_ms"), ("device_ms", "device_ms"),
                         ("plain_ms", "plain_ms"),
                         ("library_ms", "library_ms")):
            # None (the profiler did not see every launch) stays None
            per[key] = None if per[key] is None or r[src] is None \
                else per[key] + n * r[src]
        per["bound_ms"] += n * r["bound_us"] / 1e3
        per["t_bytes"] += n * r["bytes"] / HBM_BYTES_S
        per["t_ops"] += n * r["flops"] / BF16_FLOP_S
        per["err"] = max(per["err"], r["max_abs_err"])
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
    for prompt, got in zip(prompts, outs):
        toks = [seq_engine.prefill(prompt, 0)]
        while len(toks) < NEW_TOKENS:
            toks.append(int(seq_engine.step()[0]))
        seq_engine.retire(0)
        if not np.array_equal(np.asarray(toks, np.int32), got):
            fail("prompt of %d tokens: batched %s != sequential %s"
                 % (len(prompt), list(got), toks))

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
    return launches


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
    from mxnet_tpu_torch.parallel import ShardedTrainer
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
        runs[where.type] = (losses, st.params, ops.launch_counts())
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
    # 3 bottlenecks' worth per forward: 2 body + 1 downsample, 2 blocks
    if nc["conv1x1_bn_stats"] != 6 * 3 or nc["fused_sgd_momentum"] != 3 \
            or any(nh.values()):
        fail("train_small: launches card %s, CPU %s; want 18 "
             "conv1x1_bn_stats and 3 fused_sgd_momentum on the card, none "
             "on the CPU" % (nc, nh))
    emit(phase="train_small", losses_card=lc, losses_cpu=lh,
         loss_max_abs_err=loss_err, param_max_abs_err=param_err,
         loss_tol=loss_tol, param_tol=param_tol, launches=nc)


def train(dev, card):
    """ResNet-50 v1 training as bench.py's _train_tput sets it up, through
    the port's ShardedTrainer.step_many. Returns the launch counts of the
    timed window."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.convert import init_resnet_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.resilience import numerics
    t0 = time.perf_counter()
    net = resnet50_v1(layout="NHWC", device=dev)
    init_resnet_params(net, seed=0)
    st = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9},
                        compute_dtype="bfloat16", device=dev)
    n_params = sum(v.numel() for v in st.params.values())
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(BATCH, IMG, IMG, 3).astype("float32")) \
        .to(dev)
    y = torch.from_numpy((rng.rand(BATCH) * 1000).astype("float32")).to(dev)
    warm = st.step_many(x, y, n_steps=TRAIN_STEPS).cpu().numpy()
    numerics.drain_flags()
    setup_s = time.perf_counter() - t0

    # the main path, with every launch counter at 0 just before it
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = st.step_many(x, y, n_steps=TRAIN_STEPS).cpu().numpy()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    guard = numerics.drain_flags()

    if not (np.isfinite(warm).all() and np.isfinite(losses).all()):
        fail("train: non-finite loss: warm %s, timed %s" % (warm, losses))
    if guard["skipped_steps"] or guard["anomalies"]:
        fail("train: numerics guard reports %s" % guard)
    if not losses[-1] < warm[0]:
        fail("train: loss did not fall: first %g, last %g"
             % (warm[0], losses[-1]))
    if launches["conv1x1_bn_stats"] != 36 * TRAIN_STEPS or \
            launches["fused_sgd_momentum"] != TRAIN_STEPS:
        fail("train: launches %s over %d steps, want 36 conv1x1_bn_stats "
             "and 1 fused_sgd_momentum per step" % (launches, TRAIN_STEPS))

    # where one step's time goes: host wall of one step, device profile
    t = time.perf_counter()
    st.step_many(x, y, n_steps=1).cpu()
    one_step_ms = (time.perf_counter() - t) * 1e3
    dev_us = profiled(lambda: st.step_many(x, y, n_steps=1), 1)
    step_profile = breakdown(dev_us, 1, one_step_ms, top_n=12)
    step_profile["device_ms_by_kind"] = by_kind(dev_us, 1)
    # the stride-2 subsample copies in front of the kernel (6 a forward:
    # the first block's conv0 and downsample in stages 2-4)
    acts = [torch.empty(BATCH, side, side, ch, device=dev,
                        dtype=torch.bfloat16)
            for side, ch in ((56, 256), (28, 512), (14, 1024))]
    subsample_ms = cuda_ms(lambda: [a[:, ::2, ::2, :].contiguous()
                                    for a in acts for _ in range(2)])
    del acts
    step_ms = wall / TRAIN_STEPS * 1e3
    img_s = BATCH * TRAIN_STEPS / wall
    mfu = FLOPS_PER_IMG * img_s / BF16_FLOP_S
    emit(phase="train", card=card, model="ResNet-50 v1, NHWC, seeded "
         "random weights (Uniform 0.07)", params=n_params, batch=BATCH,
         image=IMG, dtype="bf16 compute, fp32 master", steps=TRAIN_STEPS,
         img_s=img_s, step_ms=step_ms, wall_s=wall,
         mfu=mfu, mfu_basis="3 x 4.089 GFLOP/img over %g FLOP/s bf16 dense"
         % BF16_FLOP_S, peak_mem_gb=peak_gb, setup_s=setup_s,
         losses_warm=warm.tolist(), losses=losses.tolist(),
         launches=launches, numerics=guard,
         stride2_subsample_ms_per_forward=subsample_ms,
         profile_one_step=step_profile)
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
    emit(phase="build", seconds=build_s, dir=_build.build_dir())

    # phase 3: kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for T in (16, 128, 1000, 1024):
            rows.append(check_flash(ops, dev, T, dtype, gen))
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
    for r in rows:
        emit(phase="kernel", card=card, **r)
    # before the training phases: their long profiles leave the profiler
    # dropping records of later large launches
    conv_per = conv1x1_per_forward(ops, dev, gen, card)

    # phases 4, 5: the model
    small_model_check(dev)
    launches = serve(dev, card)

    # phases 6, 7: training
    train_small(dev)
    train_launches = train(dev, card)
    launches.update(fused_sgd_momentum=train_launches["fused_sgd_momentum"],
                    conv1x1_bn_stats=train_launches["conv1x1_bn_stats"])

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
                 str(torch.float32))
        kernels.append(dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1], launches=launches[name],
            max_abs_err=max(x["max_abs_err"] for x in rows
                            if x["name"] == name and
                            x["dtype"] == str(torch.float32)),
            ms=r["kernel_ms"], device_ms=r["device_ms"],
            plain_ms=r["plain_ms"],
            bound_ms=r["bound_us"] / 1e3, bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"], dtype="fp32"))
    # the train step's update: ResNet-50's 193 tensors, fp32, one launch
    r = next(r for r in rows if r["name"] == "fused_sgd_momentum" and
             r["dtype"] == str(torch.float32))
    kernels.append(dict(
        name="fused_sgd_momentum", route="cuda",
        source=sources["fused_sgd_momentum"][0],
        replaces=sources["fused_sgd_momentum"][1],
        launches=launches["fused_sgd_momentum"], max_abs_err=r["max_abs_err"],
        ms=r["kernel_ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_us"] / 1e3, bound_by=r["bound_by"],
        library_ms=r["library_ms"], shape=r["shape"], dtype="fp32",
        per="train step"))
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
        library_ms=conv_per["library_ms"], shape="ResNet-50 b128 forward, "
        "36 calls, %d shapes" % conv_per["shapes"], dtype="bf16",
        per="train forward"))
    emit(kernels=kernels)
    print(card_line(), flush=True)
    faulthandler.cancel_dump_traceback_later()
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
