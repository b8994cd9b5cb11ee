"""Shared pieces of the record-pipeline parity tests
(tests/test_torch_{recordio,image,io_record,io_iters,image_det}.py).

`no_persistent_compile_cache` turns the session's JAX compile cache off
for a module (ROADMAP C4). `port_native_library` builds the port's
native record library and points both packages at it through
``MXTPU_LIBRARY_PATH`` before either loads one, so no test makes the JAX
package's ``_native.ensure_built`` run ``make -C src`` (ROADMAP C8); both
libraries are built from the same sources in ``src/``. `write_rec`
writes synthetic image records with either package's writer."""
import os

import numpy as np
import jax
from jax._src import compilation_cache
import pytest

from mxnet_tpu_torch import _native as port_native


@pytest.fixture(scope="module")
def no_persistent_compile_cache():
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


@pytest.fixture(scope="module")
def port_native_library():
    """The path of the port's library (None without a compiler), set as
    MXTPU_LIBRARY_PATH for the module."""
    lib = port_native.ensure_built()
    path = port_native._LIB_FROM if lib is not None else None
    with pytest.MonkeyPatch.context() as mp:
        if path is not None:
            mp.setenv("MXTPU_LIBRARY_PATH", path)
        yield path


def smooth_image(rng, h, w, ident):
    """A smooth RGB uint8 image with `ident` written in its top-left
    2x2 patch (channel 1) and in the mean level of channel 0."""
    base = rng.rand(4, 4, 3)
    ys = np.linspace(0, 3, h)[:, None]
    xs = np.linspace(0, 3, w)[None, :]
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    y1, x1 = np.minimum(y0 + 1, 3), np.minimum(x0 + 1, 3)
    fy, fx = (ys - y0)[..., None], (xs - x0)[..., None]
    img = (base[y0, x0] * (1 - fy) * (1 - fx) + base[y0, x1] * (1 - fy) * fx
           + base[y1, x0] * fy * (1 - fx) + base[y1, x1] * fy * fx)
    img = (img * 120 + 60).astype(np.uint8)
    img[:2, :2, 1] = ident % 256
    return img


def write_rec(recordio, path, n, h=20, w=18, seed=0, img_fmt=".jpg",
              quality=90, label_width=1, indexed=True, classes=None):
    """n image records through `recordio` (either package's module):
    record i has id i and label i (i modulo `classes` when given; a label
    vector i + k/10 at `label_width` > 1); returns the .rec path."""
    rng = np.random.RandomState(seed)
    path = str(path)
    if indexed:
        w_ = recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                        path, "w")
    else:
        w_ = recordio.MXRecordIO(path, "w")
    for i in range(n):
        img = smooth_image(rng, h, w, i)
        cls = i % classes if classes else i
        label = float(cls) if label_width == 1 else \
            [i + k / 10.0 for k in range(label_width)]
        rec = recordio.pack_img(recordio.IRHeader(0, label, i, 0), img,
                                quality=quality, img_fmt=img_fmt)
        if indexed:
            w_.write_idx(i, rec)
        else:
            w_.write(rec)
    w_.close()
    return path
