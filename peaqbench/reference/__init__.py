"""The benchmark's plain references: a frozen copy of the NumPy
specification with its constants and ear parameters, and a batched
float64 PyTorch version held to it."""
