"""Architecture registry.

The port of ``neuralampmodelercore_tpu.registry`` (reference analog:
ConfigParserRegistry, NAM/model_config.h:54-123): a name -> architecture map
that ``load_model`` dispatches on, filled at import time by each architecture
module and open for external registration. An architecture is a bundle of
functions over (config, params, state) with tensors on an explicit device:

  build(config_json, weights, sample_rate, device) -> (config, params)
  init_state(config, params, batch)                -> state
  step(config, params, state, x)                   -> (y, state')

WaveNet, LSTM and ConvNet are ported. Linear and the meta-models
(SlimmableWavenet, SlimmableContainer) raise ``NotImplementedError`` naming
the ROADMAP Queue 1 item that ports them (its title, not its number).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

Config = Any
Params = Any
State = Any

# Architectures of the reference that later slices port (ROADMAP.md Queue 1).
NOT_PORTED: Dict[str, str] = {
    "Linear": "ROADMAP Queue 1, the Linear item (models/linear.py)",
    "SlimmableWavenet": "ROADMAP Queue 1, the Meta-models item (models/slimmable.py: slimmable WaveNet)",
    "SlimmableContainer": "ROADMAP Queue 1, the Meta-models item (models/container.py: SlimmableContainer)",
}


def not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f'architecture "{name}" is not ported to the PyTorch package yet: {NOT_PORTED[name]}'
    )


@dataclasses.dataclass(frozen=True)
class ArchDef:
    """Functional definition of a nestable architecture."""

    name: str
    config_cls: type
    # (config_json, weights, sample_rate, device) -> (config, params)
    build: Callable[[dict, np.ndarray, float, Any], Tuple[Config, Params]]
    # (config, params, batch) -> state
    init_state: Callable[[Config, Params, int], State]
    # (config, params, state, x[B,T,Cin]) -> (y[B,T,Cout], state')
    step: Callable[[Config, Params, State, Any], Tuple[Any, State]]
    # (config, sample_rate) -> prewarm sample count
    prewarm_samples: Callable[[Config, float], int]
    in_channels: Callable[[Config], int]
    out_channels: Callable[[Config], int]
    # Block-size-specialised engine path over ring-chunk state in the
    # (C, T, B) layout (ops/ring.py).
    # engine_prepare(config, params, T, batch) -> (eparams, state)
    engine_prepare: Optional[Callable[[Config, Params, int, int], Tuple[Params, State]]] = None
    # engine_step(config, T, eparams, state, x_ctb) -> (y_ctb, state')
    engine_step: Optional[Callable[..., Tuple[Any, State]]] = None
    # True for architectures whose state is not a function of the last
    # receptive-field inputs (LSTM): their engine prewarm runs the exact
    # sample count, with a remainder step shorter than T. A WaveNet with an
    # LSTM condition DSP stays False, as in the JAX package.
    recurrent: bool = False


def engine_fns(arch: ArchDef):
    """(prepare, step) in the (C, T, B) engine layout. Architectures without
    a specialised engine get an adapter around the generic step."""
    if arch.engine_prepare is not None and arch.engine_step is not None:
        return arch.engine_prepare, arch.engine_step

    def prepare(config, params, T, batch):
        return params, arch.init_state(config, params, batch)

    def step(config, T, eparams, state, x_ctb):
        y_btc, state = arch.step(config, eparams, state, x_ctb.permute(2, 1, 0))
        return y_btc.permute(2, 1, 0), state

    return prepare, step


_ARCHS: Dict[str, ArchDef] = {}
_BY_CONFIG_CLS: Dict[type, ArchDef] = {}
_CUSTOM_LOADERS: Dict[str, Callable[[Any], Any]] = {}


def register_architecture(arch: ArchDef) -> None:
    """(reference analog: ConfigParserHelper auto-registration,
    NAM/model_config.h:98-104)"""
    prev = _BY_CONFIG_CLS.get(arch.config_cls)
    if prev is not None and prev.name != arch.name:
        raise ValueError(
            f"config class {arch.config_cls.__name__} is already bound to "
            f'architecture "{prev.name}"; register a distinct config class'
        )
    _ARCHS[arch.name] = arch
    _BY_CONFIG_CLS[arch.config_cls] = arch


def register_custom_loader(name: str, loader: Callable[[Any], Any]) -> None:
    """Register an external architecture by a load hook (reference analog:
    factory::Helper, NAM/registry.h:20-67)."""
    _CUSTOM_LOADERS[name] = loader


def get_architecture(name: str) -> ArchDef:
    if name not in _ARCHS:
        if name in _CUSTOM_LOADERS:
            raise ValueError(
                f'"{name}" is registered as a custom loader, not a built-in '
                "architecture; load it via get_custom_loader/load_model"
            )
        if name in NOT_PORTED:
            raise not_ported(name)
        raise ValueError(f'Unrecognized architecture "{name}"')
    return _ARCHS[name]


def has_architecture(name: str) -> bool:
    """True when the name is loadable: built-in or custom loader."""
    return name in _ARCHS or name in _CUSTOM_LOADERS


def get_custom_loader(name: str) -> Optional[Callable[[Any], Any]]:
    return _CUSTOM_LOADERS.get(name)


def arch_for_config(config: Config) -> ArchDef:
    """Dispatch on a config object's type (nested condition DSPs)."""
    arch = _BY_CONFIG_CLS.get(type(config))
    if arch is None:
        raise ValueError(f"No architecture registered for config type {type(config).__name__}")
    return arch
