"""The benchmark of the PyTorch and CUDA port of PEAQ (see README.md)."""
