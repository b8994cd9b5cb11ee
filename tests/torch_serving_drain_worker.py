"""One port ModelServer on the CPU, drained by a real SIGTERM: the child
process tests/test_torch_model_server.py runs, so no signal is ever
raised in the pytest process.

    python tests/torch_serving_drain_worker.py forward|decode

Under `handle_signals()` it puts requests in flight (each dispatch
slowed so they are still running), raises SIGTERM at itself, then checks
that every in-flight request finishes, that a new submit is refused
with `RequestRejected`, and that `drain` returns True. It prints one
JSON line and exits 0 when all of that held.
"""
import json
import os
import signal
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.serving import (DecodeEngine, InferenceEngine,  # noqa
                                     ModelServer, RequestRejected)


def forward_server():
    rng = np.random.RandomState(0)
    with mx.name.NameManager():
        h = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=3,
                                  name="fc1")
        sym = mx.sym.SoftmaxOutput(h, name="softmax")
    args = {"fc1_weight": rng.randn(3, 6).astype(np.float32),
            "fc1_bias": rng.randn(3).astype(np.float32)}
    eng = InferenceEngine.from_symbol(sym, args, {}, {"data": (6,)}, 4,
                                      name="drain_mlp", device="cpu")
    infer = eng.infer

    def slow(*a, **k):
        time.sleep(0.2)
        return infer(*a, **k)
    eng.infer = slow
    server = ModelServer(eng, num_workers=1, max_wait_ms=1.0, warmup=True)
    return server, lambda i: server.submit(
        rng.randn(1, 6).astype(np.float32))


def decode_server():
    from mxnet_tpu_torch.gluon.model_zoo import GPTDecoder
    from mxnet_tpu_torch.convert import init_gpt_params
    cfg = dict(vocab_size=48, max_seq_len=32, num_layers=1, num_heads=2,
               embed_dim=16, mlp_ratio=4)
    blk = GPTDecoder(params=init_gpt_params(
        dict(cfg, head_dim=8, mlp_hidden=64), seed=1), device="cpu", **cfg)
    eng = DecodeEngine(blk, max_slots=2, device="cpu", name="drain_gpt")
    step = eng.step

    def slow():
        time.sleep(0.02)
        return step()
    eng.step = slow
    server = ModelServer(eng, max_new_tokens=8)
    return server, lambda i: server.submit(np.array([1 + i, 2, 3]))


def main():
    kind = sys.argv[1]
    server, submit = forward_server() if kind == "forward" \
        else decode_server()
    server.start()
    with server.handle_signals():
        handles = [submit(i) for i in range(4)]
        time.sleep(0.05)
        signal.raise_signal(signal.SIGTERM)
        t0 = time.monotonic()
        while not server.draining and time.monotonic() - t0 < 5:
            time.sleep(0.01)
        try:
            submit(99)
            refused = False
        except RequestRejected:
            refused = True
        results = [h.result(timeout=60) for h in handles]
        drained = server.drain(timeout=60)
    served = sum(1 for r in results if r is not None and len(r))
    out = {"kind": kind, "draining": bool(server.draining),
           "refused": refused, "served": served, "drained": bool(drained),
           "handler_restored": signal.getsignal(signal.SIGTERM)
           == signal.SIG_DFL}
    print(json.dumps(out), flush=True)
    ok = refused and served == 4 and drained and out["handler_restored"]
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
