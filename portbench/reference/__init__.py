"""The plain float32 reference: forward passes (``model``) and training
steps (``train``) in plain PyTorch, importing nothing of the program."""
