"""repro_torch.kernels — the checkpoint's preconditioners on the GPU.

``bitshuffle``, ``byteshuffle`` and ``delta`` each wrap a hand-written
CUDA kernel (``csrc/*.cu``, built by ``_build`` at first use) and count its
launches; ``ref`` holds their plain PyTorch versions, which a wrapper runs
only for a tensor on the CPU.  ``ops`` applies a precond spec string to one
basket.
"""
