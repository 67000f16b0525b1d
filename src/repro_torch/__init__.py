"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s module names (``core.stencil``,
``core.blocking``, ``kernels.ref``, ``kernels.engine``, ``kernels.ops``,
``apps.hotspot`` ...) so each module's counterpart is easy to find. It
imports ``torch`` and numpy only: never ``jax``, never ``repro``.

Entry points take tensors and run where the tensors live. Generators
take ``device=None``, which means the CUDA card; the CPU is used only
when the caller asks for it (the tests do). On the card, the 2D stencil
engine launches the hand-written Hopper kernel in
``kernels/csrc/stencil2d_revolving.cu``; on the CPU it runs that
kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
