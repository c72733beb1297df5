"""Hand-written CUDA kernel backends, keyed by model config type (the port of
``neuralampmodelercore_tpu.ops.pallas``)."""


def backend_for(cfg):
    """The kernel module serving this config type. Its ``supports`` still
    decides per (T, batch) whether the kernel applies."""
    from ...models.convnet import ConvNetConfig
    from ...models.lstm import LSTMConfig
    from ...models.wavenet import WaveNetConfig

    if isinstance(cfg, WaveNetConfig):
        from . import stack

        return stack
    if isinstance(cfg, LSTMConfig):
        from . import lstm

        return lstm
    if isinstance(cfg, ConvNetConfig):
        from . import convnet

        return convnet
    raise NotImplementedError(
        f"no CUDA kernel for {type(cfg).__name__} (Linear has none in the JAX package either; ROADMAP Queue 1, "
        "the Linear item, ports it to the torch tier)"
    )
