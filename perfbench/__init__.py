"""The benchmark of the PyTorch/CUDA port (``codetr_torch``): see README.md."""
