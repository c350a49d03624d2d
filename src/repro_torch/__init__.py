"""PyTorch + CUDA port of the DeepGEMM reproduction (``src/repro``).

The JAX package stays the reference; this package mirrors its layout
(``configs/``, ``core/``, ``kernels/``, ``models/``, ``serving/``,
``launch/``, ``obs/``) so a module's counterpart is found by path. It
imports ``torch`` and never ``jax`` or anything of ``repro``: what it needs
from the reference (constants, config values, metric schema) it keeps as
its own copy.

Every Pallas kernel on the ported path is a hand-written CUDA C++ kernel
for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use and bound with
``ctypes`` (``kernels/build.py``). Each kernel keeps a plain PyTorch
version beside it: a wrapper takes the plain version only for tensors that
lie on the CPU, and launches the kernel (or raises) for CUDA tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu``); with no card visible and no explicit CPU request they
raise (``device.resolve_device``).
"""
