"""repro_torch — the PyTorch/CUDA port of ``repro``.

The storage layer (``core``, ``io``, ``obs``, ``repair``, ``data``) is this
package's own copy of the reference's, so the port needs nothing of the JAX
package.  What moved onto the GPU is the preconditioning stage of the
checkpoint: ``kernels`` holds the hand-written Hopper kernels and their
plain PyTorch versions, ``checkpoint`` drives them.

This module imports nothing heavy: the I/O engine's process-pool workers
import the package, and they must not pay for loading ``torch``.
"""
