"""gstpeaq_tpu_torch — PEAQ (ITU-R BS.1387-1) in PyTorch with hand-written
CUDA kernels for Hopper.

The port of the JAX package `gstpeaq_tpu`, which stays the reference.  So
far it computes the basic and the advanced version for one pair,
`gstpeaq_tpu_torch.api.peaq(ref, test, advanced=False, device="cuda")`,
for a batch of pairs,
`gstpeaq_tpu_torch.parallel.batch.peaq_batch(refs, tests, ...)`, and for
long programs fed in pieces, the streams `PeaqStream`, `PeaqStreamAdvanced`
and `PeaqStreamPool` (parallel/stream.py), whose state
`utils.checkpoint` saves and loads.
The kernels are built from `csrc/` with nvcc at first use.  The port imports
nothing of the JAX package: `constants`, `earparams` and
`utils.testsignals` are its own copies of that package's framework-free
modules, and `Settings` is its own.
"""

__version__ = "0.1.0"

from .constants import DEFAULT_SETTINGS, Settings  # noqa: F401

_STREAMS = ("PeaqStream", "PeaqStreamAdvanced", "PeaqStreamPool")


def peaq(*args, **kwargs):
    """See gstpeaq_tpu_torch.api.peaq."""
    from . import api
    return api.peaq(*args, **kwargs)


def __getattr__(name):
    """The stream classes of parallel/stream.py, imported on first use."""
    if name in _STREAMS:
        from .parallel import stream
        return getattr(stream, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Settings", "DEFAULT_SETTINGS", "__version__", "peaq",
           *_STREAMS]
