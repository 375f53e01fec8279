"""Packaging (parity: reference ``tools/pip_package`` + ``setup.py``).

Builds the native runtime (``native/`` → ``libmxtpu.so``) through the
standard build_ext hook so ``pip install .`` ships a working package;
the predict library (which embeds CPython) is built on demand by
``make -C native predict`` and is not part of the default wheel.
"""

import os
import subprocess

from setuptools import Command, find_packages, setup
from setuptools.command.build_py import build_py

_HERE = os.path.dirname(os.path.abspath(__file__))


class BuildNative(Command):
    description = "build the native runtime (libmxtpu.so)"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        subprocess.check_call(["make", "-C", os.path.join(_HERE, "native")])


class BuildPyWithNative(build_py):
    def run(self):
        try:
            self.run_command("build_native")
        except Exception as exc:  # native lib is optional (python fallbacks)
            print("warning: native build skipped: %s" % exc)
        super().run()


setup(
    name="mxnet-tpu",
    version="0.9.5.dev2",  # tracks the reference's v0.9.5 API surface
    description="TPU-native deep learning framework with the MXNet v0.9 "
                "API surface, rebuilt on jax/XLA/Pallas",
    packages=find_packages(include=["mxnet_tpu", "mxnet_tpu.*",
                                    "mxnet_tpu_torch", "mxnet_tpu_torch.*"]),
    package_data={"mxnet_tpu": ["../native/build/libmxtpu.so"],
                  "mxnet_tpu_torch": ["csrc/*.cu", "csrc/*.h"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    cmdclass={"build_native": BuildNative, "build_py": BuildPyWithNative},
)
