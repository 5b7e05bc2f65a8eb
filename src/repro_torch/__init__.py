"""`repro_torch` — the PyTorch/CUDA port of `repro` for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: same layout, module
for module, each docstring citing its reference as
``repro.<module>:<function>``.  Plain tensor code is PyTorch; the Pallas
TPU kernels on the ported path are CUDA C++ kernels for ``sm_90a``
(``repro_torch/kernels/*/csrc``), built with ``nvcc`` at first use and
bound through ``ctypes``.  Each kernel keeps a plain PyTorch twin beside
it that CPU tensors take.

Requires torch >= 2.1 (``torch.utils._python_dispatch.TorchDispatchMode``,
``torch.Generator`` on CUDA) and numpy.
``import repro_torch`` loads neither ``jax`` nor any module of ``repro``:
the JAX-free reference modules it needs are private copies here.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device and without that explicit request they raise
(:func:`resolve_device`), never falling back to the CPU.
"""

from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
