"""Test configuration: run the whole suite on an 8-device virtual CPU mesh.

Mirrors the reference's test strategy (SURVEY.md §4): multi-device tests run
without a cluster by faking devices on one host
(xla_force_host_platform_device_count), the way the reference runs dist
kvstore tests with local worker/server processes.

Persistent compilation cache (ISSUE 11 / docs/compilation.md): cold XLA
compiles dominate the tier-1 wall-clock budget, so the session points
jax's persistent cache at a shared uid-scoped directory — the second
run of the suite (and every subprocess test inside any run, via the
exported MXTPU_COMPILE_CACHE) reloads executables instead of
recompiling them. MXTPU_COMPILE_CACHE=0 opts out; an explicit path
overrides the default.
"""
import os
import tempfile

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

_cache = os.environ.get("MXTPU_COMPILE_CACHE")
if _cache is None:
    # the framework's own default (compile/cache.py), spelled out here
    # so the EXPORTED env reaches subprocess tests too. The same 0700
    # ownership refusal applies BEFORE exporting: the env var is
    # treated as operator-explicit downstream, so exporting an
    # unverified world-writable /tmp path would launder a stranger's
    # pre-created dir (planted executables) past the guard.
    _cache = os.path.join(tempfile.gettempdir(),
                          "mxtpu_xla_cache_%d" % os.getuid())
    try:
        os.makedirs(_cache, mode=0o700, exist_ok=True)
        _st = os.lstat(_cache)
        if os.path.islink(_cache) or _st.st_uid != os.getuid() \
                or (_st.st_mode & 0o022):
            _cache = None
    except OSError:
        _cache = None
    if _cache is not None:
        os.environ["MXTPU_COMPILE_CACHE"] = _cache
elif _cache in ("", "0", "false", "False"):
    _cache = None
else:
    try:
        os.makedirs(_cache, exist_ok=True)
    except OSError:
        _cache = None

import jax

jax.config.update("jax_platforms", "cpu")
if _cache is not None:
    # through the subsystem, not raw jax config: enable_cache also
    # installs the multi-device read guard (a cache-deserialized
    # multi-device CPU executable can segfault jaxlib — see
    # compile/cache.py) before anything in the session compiles
    from mxnet_tpu.compile.cache import enable_cache

    enable_cache(_cache)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's hand-written "
        "kernels); skips with a reason where there is none")
