"""gstpeaq_tpu_torch — PEAQ (ITU-R BS.1387-1) in PyTorch with hand-written
CUDA kernels for Hopper.

The port of the JAX package `gstpeaq_tpu`, which stays the reference.  So
far it computes the basic and the advanced version for one pair,
`gstpeaq_tpu_torch.api.peaq(ref, test, advanced=False, device="cuda")`,
and for a batch of pairs,
`gstpeaq_tpu_torch.parallel.batch.peaq_batch(refs, tests, ...)`.
The kernels are built from `csrc/` with nvcc at first use.  The port imports
nothing of the JAX package: `constants`, `earparams` and
`utils.testsignals` are its own copies of that package's framework-free
modules, and `Settings` is its own.
"""

__version__ = "0.1.0"

from .constants import DEFAULT_SETTINGS, Settings  # noqa: F401


def peaq(*args, **kwargs):
    """See gstpeaq_tpu_torch.api.peaq."""
    from . import api
    return api.peaq(*args, **kwargs)


__all__ = ["Settings", "DEFAULT_SETTINGS", "__version__", "peaq"]
