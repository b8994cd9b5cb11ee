"""Package build for mxnet_tpu (reference: the reference's Makefile +
python/setup.py split; here one setup builds both).

The native host runtime (src/engine.cc, src/recordio.cc) compiles into
libmxtpu.so via the same `make -C src` the ctypes loader uses;
`python setup.py build` (or `pip install .`) runs it through the
build_py hook so the wheel ships the shared object.
"""
import os
import subprocess

from setuptools import setup, find_packages
from setuptools.command.build_py import build_py


ROOT = os.path.dirname(os.path.abspath(__file__))


class BuildWithNative(build_py):
    def run(self):
        src = os.path.join(ROOT, "src")
        if os.path.isdir(src):
            try:
                subprocess.run(["make", "-C", src], check=True)
            except (subprocess.CalledProcessError, FileNotFoundError):
                # pure-python install still works; the ctypes loader
                # rebuilds lazily via ensure_built()
                pass
        super().run()


setup(
    name="mxnet-tpu",
    version="0.3.0",
    description="TPU-native deep learning framework with the mxnet API "
                "surface (JAX/XLA/Pallas compute, C++ host runtime)",
    packages=find_packages(include=["mxnet_tpu", "mxnet_tpu.*",
                                    "mxnet_tpu_torch*"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    cmdclass={"build_py": BuildWithNative},
    package_data={"mxnet_tpu": [], "mxnet_tpu_torch": ["csrc/*.cu",
                                                         "csrc/*.cuh"]},
)
