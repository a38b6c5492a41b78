"""gstpeaq_tpu_torch — PEAQ (ITU-R BS.1387-1) in PyTorch with hand-written
CUDA kernels for Hopper.

The port of the JAX package `gstpeaq_tpu`, which stays the reference, and
it does what that package does: the basic and the advanced version for one
pair, `gstpeaq_tpu_torch.api.peaq(ref, test, advanced=False,
device="cuda")`; the command line, `python -m gstpeaq_tpu_torch REF TEST`
(cli.py, reading WAVs with utils/native.py or utils/wavio.py); the
BS.1387 conformance harness (conformance.py); a batch of pairs on one
device, `peaq_batch` (parallel/batch.py); a sweep over several devices,
`peaq_sharded`, and the cognitive model's data-parallel training,
`parallel.shard.train_cognitive_sharded` (parallel/shard.py, on top of
models/nn.py's trainable form); and long programs fed in pieces, the
streams `PeaqStream`, `PeaqStreamAdvanced` and `PeaqStreamPool`
(parallel/stream.py, a pool on one device or several), whose state
`utils.checkpoint` saves and loads.
The kernels are built from `csrc/` with nvcc at first use.  The port imports
nothing of the JAX package: `constants`, `earparams`, `conformance`'s
tables, `utils.testsignals`, `utils.wavio` and `utils.native` are its own
copies of that package's framework-free code, and `Settings` is its own.
"""

__version__ = "0.1.0"

from .constants import DEFAULT_SETTINGS, Settings  # noqa: F401

_STREAMS = ("PeaqStream", "PeaqStreamAdvanced", "PeaqStreamPool")


def peaq(*args, **kwargs):
    """See gstpeaq_tpu_torch.api.peaq."""
    from . import api
    return api.peaq(*args, **kwargs)


def peaq_batch(*args, **kwargs):
    """See gstpeaq_tpu_torch.parallel.batch.peaq_batch."""
    from .parallel import batch
    return batch.peaq_batch(*args, **kwargs)


def peaq_sharded(*args, **kwargs):
    """See gstpeaq_tpu_torch.parallel.shard.peaq_sharded."""
    from .parallel import shard
    return shard.peaq_sharded(*args, **kwargs)


def __getattr__(name):
    """The stream classes of parallel/stream.py, imported on first use."""
    if name in _STREAMS:
        from .parallel import stream
        return getattr(stream, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Settings", "DEFAULT_SETTINGS", "__version__", "peaq",
           "peaq_batch", "peaq_sharded", *_STREAMS]
