"""Monitor: per-op output, weight and gradient statistics during training
(counterpart of mxnet_tpu/monitor.py; reference: python/mxnet/monitor.py:33).

`Monitor.install(exe)` sets the executor's monitor callback: while a batch
is being collected (every `interval` batches, between `tic` and `toc`)
each output the executor's forward produces is passed through
`stat_func` and queued under its name; `toc` adds the executor's
arguments and gradients (``grad_<name>``) and returns
``[(batch, name, "v1,v2,...")]``. A monitored executor runs its graph op
by op with the callback (the port's analog of the reference turning op
bulking off). `Module.fit(monitor=...)` installs it and prints every
collected batch.
"""
from __future__ import annotations

import re

from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    """Monitor outputs, weights and gradients (reference: monitor.py:33).
    `stat_func` maps an NDArray to an NDArray (or a list of them); the
    default is ``norm(x) / sqrt(size)``."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                return x.norm() / (x.size ** 0.5)
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, arr):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(arr)))
        self.stat_helper = stat_helper

    def install(self, exe, monitor_all=False):
        """Install the callback on an executor (monitor.py:87)."""
        exe.set_monitor_callback(self.stat_helper, monitor_all)
        self.exes.append(exe)

    def tic(self):
        """Start collecting for this batch, every `interval` batches
        (monitor.py:96)."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End the collection; returns [(batch, name, values)]
        (monitor.py:107)."""
        if not self.activated:
            return []
        self.activated = False
        for exe in self.exes:
            for name, array in zip(exe._symbol.list_arguments(),
                                   exe.arg_arrays or []):
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
            for name, array in (exe.grad_dict or {}).items():
                if array is not None and self.re_prog.match(name):
                    self.queue.append((self.step, "grad_" + name,
                                       self.stat_func(array)))
        res = []
        queue = sorted(self.queue, key=lambda x: x[1]) if self.sort \
            else self.queue
        for n, k, v_list in queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            assert isinstance(v_list, list)
            s = ",".join(str(float(v.asscalar())
                             if isinstance(v, NDArray) else v)
                         for v in v_list)
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        """End the collection and print it (monitor.py:139)."""
        for n, k, v in self.toc():
            print("Batch: {:7d} {:30s} {:s}".format(n, k, v))
