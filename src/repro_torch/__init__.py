"""PyTorch + CUDA port of the ``repro`` package (the JAX reference).

The layout mirrors ``src/repro/`` module for module, so each file's
counterpart is found by name.  The port imports ``torch`` and
``numpy`` only; host-side modules it needs from the reference are
copied in (each copy names its original in its first line).

Kernel choice follows the tensor's device: a CPU tensor takes the
plain PyTorch version of a kernel, a CUDA tensor takes the hand-written
CUDA kernel (built on first use from ``kernels/csrc``) or the call
raises.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
