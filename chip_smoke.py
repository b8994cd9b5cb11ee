#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases; any failure exits non-zero before the final line:

1. device  — needs CUDA; prints the card's name and power limit.
2. build   — compiles the kernels from mxnet_tpu_torch/csrc with nvcc
             (sm_90a) and prints the build seconds and ptxas reports.
3. kernels — holds each kernel against its plain PyTorch version on the
             card, in fp32 and bf16, at the shapes the GPT path gives it,
             and times the kernel, the plain version and one PyTorch
             library call, beside the least time the card could take.
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

It ends with a JSON line of the kernels, the card's nvidia-smi line, and
``{"ok": true, "device": {...}}``. Float32 matrix products run in full
fp32: TF32 is switched off for matmuls and cuDNN.
"""
import json
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
       ("layer_norm", torch.bfloat16): 2e-2}


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


def print_ptxas(log):
    """One line per compiled kernel from nvcc's -Xptxas -v report:
    template arguments, registers, shared memory, spills."""
    kernel = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function .*?([a-z_]+_kernel)I(.*?)EEv",
                      line)
        if m:       # Itanium-mangled template arguments, e.g. IfLi64E
            args = re.sub(r"Li(\d+)E", r"\1,", m.group(2))
            args = args.replace("13__nv_bfloat16", "bf16,")
            if args.startswith("f"):
                args = "fp32," + args[1:]
            kernel = "%s<%s>" % (m.group(1), args.strip(","))
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and kernel:
            print("ptxas %s: %s; %s" % (kernel, line.split(":", 1)[1].strip(),
                                        spills), flush=True)
            kernel = None


def percentile(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q))


def profiled(fn, n):
    """Run fn() n times under torch.profiler (device activity only);
    returns {kernel or copy name: device microseconds over the n runs}.
    Empty when the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def kernel_device_ms(fn, kernel, n=10):
    """Device milliseconds per launch of the kernel whose name contains
    `kernel`, or None when the profiler does not see it."""
    us = sum(t for k, t in profiled(fn, n).items() if kernel in k)
    return us / n / 1e3 if us else None


def breakdown(dev_us, n, host_ms):
    """Where n calls' device time went, against their host wall time."""
    device_ms = sum(dev_us.values()) / n / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
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


def main():
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
    for name in ("flash_attention", "layer_norm"):
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
    for r in rows:
        emit(phase="kernel", card=card, **r)

    # phases 4, 5: the model
    small_model_check(dev)
    launches = serve(dev, card)

    # the main path's own shapes in its serving dtype (fp32)
    main_shape = {"flash_attention": [1, 12, 1024, 64],
                  "layer_norm": [1024, 768]}
    sources = {"flash_attention": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                                   "mxnet_tpu/ops/pallas_kernels.py:109"),
               "layer_norm": ("mxnet_tpu_torch/csrc/layer_norm.cu",
                              "mxnet_tpu/ops/pallas_kernels.py:184")}
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
    emit(kernels=kernels)
    print(card_line(), flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
