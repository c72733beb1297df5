"""neuralampmodelercore_tpu_torch: the PyTorch and CUDA port of
neuralampmodelercore_tpu, for NVIDIA Hopper (H100).

It loads standard ``.nam`` model files and serves them as batched
block-streaming inference, with the same semantics as the JAX package. Three
architectures are ported, each with its loader, generic tier, torch engine
tier and a fused tier that runs one hand-written CUDA kernel per block:

  - WaveNet: ops/cuda/stack.py, csrc/stack.cu;
  - LSTM: ops/cuda/lstm.py, csrc/lstm.cu;
  - ConvNet: ops/cuda/convnet.py, csrc/convnet.cu.

Linear and the meta-models raise ``NotImplementedError`` naming the ROADMAP
item that ports them.

    import neuralampmodelercore_tpu_torch as nam
    model = nam.load_model("model.nam")             # on "cuda" unless told otherwise
    engine = nam.StreamEngine(model, batch=2048, block_size=64)
    state = engine.reset()
    y, state = engine.process(x_block, state)       # x_block: (batch, 64)

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); with no card they raise, never falling back.

Precision is float32-exact, as in the JAX package (docs/deviations.md item
7): importing this package sets ``torch.backends.cudnn.allow_tf32 = False``
and checks that ``torch.backends.cuda.matmul.allow_tf32`` is False. The
package imports no JAX.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Union

import torch

torch.backends.cudnn.allow_tf32 = False
if torch.backends.cuda.matmul.allow_tf32:
    raise RuntimeError(
        "torch.backends.cuda.matmul.allow_tf32 is True: the port is float32-exact; "
        "switch TF32 matmuls off before importing it"
    )

from . import registry  # noqa: E402
from .formats import (  # noqa: E402
    ModelMetadata,
    NamData,
    UNKNOWN_EXPECTED_SAMPLE_RATE,
    parse_nam_file,
    parse_nam_json,
)
from .version import (  # noqa: E402
    EARLIEST_SUPPORTED_NAM_FILE_VERSION,
    LATEST_FULLY_SUPPORTED_NAM_FILE_VERSION,
    Supported,
    __version__,
    register_version_support_checker,
    verify_config_version,
)
from .models.base import DEFAULT_MAX_BUFFER_SIZE, Model, ScopedPrewarmOnResetDefault  # noqa: E402

# Importing the model modules registers the architectures.
from .models import convnet, lstm, wavenet  # noqa: E402,F401
from .models.engine import StreamEngine  # noqa: E402
from .ops import activations  # noqa: E402
from .ops.layers import set_matmul_precision  # noqa: E402

__all__ = [
    "load_model",
    "get_dsp",
    "get_dsp_legacy",
    "resolve_device",
    "Model",
    "StreamEngine",
    "set_matmul_precision",
    "ScopedPrewarmOnResetDefault",
    "ModelMetadata",
    "NamData",
    "activations",
    "registry",
    "__version__",
]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when a CUDA device is asked for and
    there is none: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: load_model runs on the card by default; pass device='cpu' to run on the CPU"
        )
    return dev


def _is_slimmable_wavenet(config: dict) -> bool:
    layers = config.get("layers")
    return isinstance(layers, list) and any(isinstance(lc.get("slimmable"), dict) for lc in layers)


def _load_from_data(data: NamData, device: torch.device) -> Any:
    custom = registry.get_custom_loader(data.architecture)
    if custom is not None:
        return custom(data)
    if data.architecture == "WaveNet" and _is_slimmable_wavenet(data.config):
        raise registry.not_ported("SlimmableWavenet")
    arch = registry.get_architecture(data.architecture)
    config, params = arch.build(data.config, data.weights, data.expected_sample_rate, device)
    return Model(arch, config, params, ModelMetadata.from_nam_data(data), device)


def load_model(
    source: Union[str, os.PathLike, dict, NamData],
    prewarm: Optional[bool] = None,
    return_data: bool = False,
    device=None,
):
    """Load a .nam model from a path, JSON dict or parsed NamData onto
    ``device`` (``None``: the CUDA card; raises if there is none).

    ``prewarm`` mirrors DspLoadOptions.prewarm (reference: NAM/get_dsp.h:70-78):
    if set, it overrides the thread-local prewarm-on-reset default during load,
    and the returned model keeps the previous default.
    ``return_data=True`` returns ``(model, NamData)`` (NAM/get_dsp.h:96-114).
    """
    dev = resolve_device(device)
    if isinstance(source, NamData):
        data = source
    elif isinstance(source, dict):
        data = parse_nam_json(source)
    else:
        data = parse_nam_file(source)

    if prewarm is None:
        model = _load_from_data(data, dev)
    else:
        with ScopedPrewarmOnResetDefault(prewarm) as scoped:
            model = _load_from_data(data, dev)
            model.prewarm_on_reset = scoped.previous_prewarm_on_reset
    return (model, data) if return_data else model


# The reference's name for model loading (NAM/get_dsp.h:84-114).
get_dsp = load_model


def get_dsp_legacy(dirname: Union[str, os.PathLike]):
    """Legacy directory-format loader (reference: NAM/dsp.h:360-368). The
    reference declares it but ships no definition; this raises the same loud
    error at call time."""
    raise NotImplementedError(
        f"get_dsp_legacy({os.fspath(dirname)!r}): the legacy directory model format is "
        "not supported (the reference declares this loader in NAM/dsp.h:368 but ships "
        "no implementation). Convert the model to a single-file .nam and use load_model()."
    )
