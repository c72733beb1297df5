"""Hand-written CUDA kernel backends, keyed by model config type (the port of
``neuralampmodelercore_tpu.ops.pallas``)."""


def backend_for(cfg):
    """The kernel module serving this config type. Its ``supports`` still
    decides per (T, batch) whether the kernel applies."""
    from ...models.wavenet import WaveNetConfig

    if isinstance(cfg, WaveNetConfig):
        from . import stack

        return stack
    raise NotImplementedError(
        f"no CUDA kernel for {type(cfg).__name__} yet (ROADMAP Queue 2: K2 LSTM, K3 ConvNet)"
    )
