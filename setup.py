"""Build/install integration (reference: the custom ``setup.py`` that
compiles Horovod's C++ core at install time, ``setup.py:47-52,384-562``).

Builds ``libhvdcore.so`` (coordination core, response cache, wire
format, timeline, GP/EI autotuner) from ``csrc/`` with plain g++ —
no MPI/CUDA probing needed on the TPU stack — and ships it inside the
``horovod_tpu.lib`` package data.  Build-time knobs:

- ``HVD_CXX``: compiler override (default ``g++``)
- ``HVD_SKIP_NATIVE=1``: pure-Python install (the python controller is
  a full fallback; the native core also self-builds on first use via
  ``ops/native_controller.py``)
"""

import os
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py


class BuildWithNativeCore(build_py):
    def run(self):
        here = os.path.dirname(os.path.abspath(__file__))
        csrc = os.path.join(here, "csrc")
        if os.environ.get("HVD_SKIP_NATIVE") != "1" \
                and os.path.isdir(csrc):
            env = dict(os.environ)
            if "HVD_CXX" in env:
                env["CXX"] = env["HVD_CXX"]
            try:
                subprocess.run(["make", "-C", csrc], check=True, env=env)
            except (subprocess.CalledProcessError, OSError) as exc:
                # pure-Python install is fully supported: the python
                # controller is a complete fallback, and the native core
                # also self-builds on first use where a toolchain exists
                print(f"WARNING: native core build skipped ({exc}); "
                      f"installing with the pure-Python controller")
        super().run()


setup(
    name="horovod_tpu",
    version="0.1.0",
    description=("TPU-native distributed deep-learning training "
                 "framework with the Horovod capability surface"),
    packages=[
        "horovod",        # drop-in import alias (horovod.* paths)
        "horovod_tpu",
        "horovod_tpu.checkpoint",
        "horovod_tpu.common",
        "horovod_tpu.cluster",
        "horovod_tpu.elastic",
        "horovod_tpu.keras",
        "horovod_tpu.models",
        "horovod_tpu.mxnet",
        "horovod_tpu.ops",
        "horovod_tpu.ops.pallas",
        "horovod_tpu.parallel",
        "horovod_tpu.run",
        "horovod_tpu.run.service",
        "horovod_tpu.sharding",
        "horovod_tpu.spark",
        "horovod_tpu.tensorflow",
        "horovod_tpu.tools",
        "horovod_tpu.tools.fuzz",
        "horovod_tpu.tools.fuzz.targets",
        "horovod_tpu.tools.lint",
        "horovod_tpu.tools.lint.checkers",
        "horovod_tpu.tools.proto",
        "horovod_tpu.tools.proto.checkers",
        "horovod_tpu.tools.race",
        "horovod_tpu.torch",
        "horovod_tpu.utils",
        # the PyTorch/CUDA port; its kernels build from csrc/ at first use
        "horovod_tpu_torch",
        "horovod_tpu_torch.common",
        "horovod_tpu_torch.groups",
        "horovod_tpu_torch.models",
        "horovod_tpu_torch.ops",
        "horovod_tpu_torch.ops.cuda",
        "horovod_tpu_torch.parallel",
        "horovod_tpu_torch.run",
        "horovod_tpu_torch.run.service",
        "horovod_tpu_torch.sharding",
        "horovod_tpu_torch.checkpoint",
        "horovod_tpu_torch.elastic",
        "horovod_tpu_torch.utils",
        "horovod_tpu_torch.cluster",
        "horovod_tpu_torch.spark",
        "horovod_tpu_torch.tensorflow",
        "horovod_tpu_torch.keras",
        "horovod_tpu_torch.mxnet",
    ],
    package_data={"horovod_tpu": ["lib/libhvdcore.so"],
                  "horovod_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
    extras_require={
        "torch": ["torch"],
        "cuda": ["torch"],
        "tensorflow": ["tensorflow", "keras"],
    },
    entry_points={
        "console_scripts": [
            "hvdrun = horovod_tpu.run.runner:main",
            "horovodrun = horovod_tpu.run.runner:main",
            # the PyTorch/CUDA port's launcher
            "hvdrun-torch = horovod_tpu_torch.run.runner:main",
        ],
    },
    cmdclass={"build_py": BuildWithNativeCore},
)
