"""repro_torch.kernels — the port's hand-written GPU kernels.

``bitshuffle``, ``byteshuffle``, ``delta`` and ``zigzag`` (the
checkpoint's preconditioners) and ``qpack`` (the compressed TP reduction's int8
quantizer) each wrap a hand-written CUDA kernel (``csrc/*.cu``, built by
``_build`` at first use) and count its launches; ``ref`` holds their plain
PyTorch versions, which a wrapper runs only for a tensor on the CPU.
``ops`` applies a precond spec string to one basket and quantizes tensors
of any shape.  ``selective_scan`` wraps the Mamba layer's scan kernel; its
plain version is ``models/ssm.py``'s eager scan, and the wrapper takes CUDA
tensors alone.  ``flash_attention`` wraps the prefill's causal attention
kernel; its plain version, the kernel's order in PyTorch, is
``flash_attention.plain``, and the wrapper takes CUDA tensors alone.
"""
