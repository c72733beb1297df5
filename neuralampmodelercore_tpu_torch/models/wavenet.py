"""WaveNet: stacked dilated-conv layer arrays with gating/blending, FiLM
conditioning, optional nested condition DSP and optional post-stack head.

The port of ``neuralampmodelercore_tpu.models.wavenet`` (reference:
NAM/wavenet/{model,detail,params}.{h,cpp}). Two tiers:

  - the generic step (any block length), (B, T, C) layout with halo state;
  - the engine step (fixed block size T), (C, T, B) layout with ring-chunk
    state (ops/ring.py), what ``StreamEngine(kernel="torch")`` runs.

Compute graph per layer (reference: detail::Layer::Process,
NAM/wavenet/model.cpp:166-376):

    h   = conv_pre_film(x, cond)           [optional]
    c   = DilatedConv1D(h)                  (bias always on, detail.h:45-46)
    c   = conv_post_film(c, cond)          [optional]
    m   = input_mixin(input_mixin_pre_film(cond, cond))   (no bias)
    m   = input_mixin_post_film(m, cond)   [optional]
    z   = c + m
    z   = activation_pre_film(z, cond)     [optional]
    a   = activation(z) | gated | blended   (2*bottleneck -> bottleneck)
    a   = activation_post_film(a, cond)    [optional]
    l   = layer1x1(a)                       [optional]
    l   = layer1x1_post_film(l, cond)      [ONLY in blended mode —
                                             reference quirk, model.cpp:262-270]
    hd  = head1x1(a) [+ head1x1_post_film] or a
    out_next = x + l (or x if no layer1x1)
    head_accumulator += hd
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import registry
from ..formats import WeightReader, parse_nam_json
from ..ops import activations as act
from ..ops.layers import (
    Conv1dSpec,
    Conv1x1Spec,
    FiLMSpec,
    blended_apply,
    conv1d_init_state,
    conv1d_params,
    conv1d_step,
    conv1x1_apply,
    conv1x1_params,
    film_apply,
    film_params,
    gated_apply,
)
from ..ops.ring import conv1d_w_ctb, conv1x1_ctb, conv1x1_w_ctb, ring_conv_init, ring_conv_step

# =============================================================================
# Static configuration
# =============================================================================

# Gating modes (reference: GatingMode enum, NAM/wavenet/params.h:17-22).
NONE, GATED, BLENDED = "none", "gated", "blended"

# FiLM site names, in weight-stream order
# (reference: detail::Layer::set_weights_, NAM/wavenet/model.cpp:147-163).
FILM_SITES = (
    "conv_pre_film",
    "conv_post_film",
    "input_mixin_pre_film",
    "input_mixin_post_film",
    "activation_pre_film",
    "activation_post_film",
    "layer1x1_post_film",
    "head1x1_post_film",
)


@dataclasses.dataclass(frozen=True)
class FilmSite:
    """(reference: _FiLMParams, NAM/wavenet/params.h:76-91)"""

    active: bool = False
    shift: bool = False
    groups: int = 1


@dataclasses.dataclass(frozen=True)
class LayerArrayConfig:
    """(reference: LayerArrayParams, NAM/wavenet/params.h:177-305)"""

    input_size: int
    condition_size: int
    head_size: int
    head_dilation: int
    head_kernel_size: int
    channels: int
    bottleneck: int
    kernel_sizes: Tuple[int, ...]
    dilations: Tuple[int, ...]
    activations: Tuple[act.ActivationConfig, ...]
    gating_modes: Tuple[str, ...]
    secondary_activations: Tuple[act.ActivationConfig, ...]
    head_bias: bool
    groups_input: int
    groups_input_mixin: int
    layer1x1_active: bool
    layer1x1_groups: int
    head1x1_active: bool
    head1x1_out_channels: int
    head1x1_groups: int
    films: Tuple[Tuple[str, FilmSite], ...]  # keyed by FILM_SITES name

    def film(self, site: str) -> FilmSite:
        return dict(self.films)[site]

    @property
    def num_layers(self) -> int:
        return len(self.dilations)

    @property
    def head_output_size(self) -> int:
        """Per-layer head contribution channels (reference: model.cpp:382-384)."""
        return self.head1x1_out_channels if self.head1x1_active else self.bottleneck

    def conv_out_channels(self, layer: int) -> int:
        """2*bottleneck when gated/blended (reference: detail.h:45-49)."""
        return 2 * self.bottleneck if self.gating_modes[layer] != NONE else self.bottleneck

    def receptive_field(self) -> int:
        """(reference: LayerArray::get_receptive_field, model.cpp:417-424)"""
        rf = sum(d * (k - 1) for d, k in zip(self.dilations, self.kernel_sizes))
        return rf + self.head_dilation * (self.head_kernel_size - 1)


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """Post-stack head (reference: HeadParams, NAM/wavenet/params.h:309-316)."""

    in_channels: int
    channels: int
    out_channels: int
    kernel_sizes: Tuple[int, ...]
    activation: act.ActivationConfig

    def receptive_field(self) -> int:
        """(reference: detail::Head::receptive_field, model.cpp:58-67)"""
        return 1 + sum(k - 1 for k in self.kernel_sizes)


@dataclasses.dataclass(frozen=True)
class WaveNetConfig:
    in_channels: int
    layer_arrays: Tuple[LayerArrayConfig, ...]
    head: Optional[HeadConfig]
    # Nested condition DSP config (a WaveNetConfig in this slice) or None.
    condition_config: Optional[Any]
    sample_rate: float

    @property
    def out_channels_(self) -> int:
        """(reference: wave_net_output_channels, model.cpp:540-548)"""
        if self.head is not None:
            return self.head.out_channels
        return self.layer_arrays[-1].head_size


# =============================================================================
# Per-layer / per-array specs
# =============================================================================


def layer_conv_spec(ac: LayerArrayConfig, i: int) -> Conv1dSpec:
    return Conv1dSpec(
        in_channels=ac.channels,
        out_channels=ac.conv_out_channels(i),
        kernel_size=ac.kernel_sizes[i],
        dilation=ac.dilations[i],
        bias=True,  # always (reference: detail.h:45-46)
        groups=ac.groups_input,
    )


def layer_mixin_spec(ac: LayerArrayConfig, i: int) -> Conv1x1Spec:
    return Conv1x1Spec(
        in_channels=ac.condition_size,
        out_channels=ac.conv_out_channels(i),
        bias=False,  # (reference: detail.h:47-49)
        groups=ac.groups_input_mixin,
    )


def layer_film_spec(ac: LayerArrayConfig, i: int, site: str) -> Optional[FiLMSpec]:
    """Input dims per site (reference: detail::Layer ctor, detail.h:103-154)."""
    fs = ac.film(site)
    if not fs.active:
        return None
    dims = {
        "conv_pre_film": ac.channels,
        "conv_post_film": ac.conv_out_channels(i),
        "input_mixin_pre_film": ac.condition_size,
        "input_mixin_post_film": ac.conv_out_channels(i),
        "activation_pre_film": ac.conv_out_channels(i),
        "activation_post_film": ac.bottleneck,
        "layer1x1_post_film": ac.channels,
        "head1x1_post_film": ac.head1x1_out_channels,
    }
    return FiLMSpec(condition_dim=ac.condition_size, input_dim=dims[site], shift=fs.shift, groups=fs.groups)


def layer1x1_spec(ac: LayerArrayConfig) -> Optional[Conv1x1Spec]:
    if not ac.layer1x1_active:
        return None
    return Conv1x1Spec(ac.bottleneck, ac.channels, bias=True, groups=ac.layer1x1_groups)


def head1x1_spec(ac: LayerArrayConfig) -> Optional[Conv1x1Spec]:
    if not ac.head1x1_active:
        return None
    return Conv1x1Spec(ac.bottleneck, ac.head1x1_out_channels, bias=True, groups=ac.head1x1_groups)


def rechannel_spec(ac: LayerArrayConfig) -> Conv1x1Spec:
    # (reference: model.cpp:381 — no bias)
    return Conv1x1Spec(ac.input_size, ac.channels, bias=False, groups=1)


def head_rechannel_spec(ac: LayerArrayConfig) -> Conv1dSpec:
    # (reference: model.cpp:382-383)
    return Conv1dSpec(
        in_channels=ac.head_output_size,
        out_channels=ac.head_size,
        kernel_size=ac.head_kernel_size,
        dilation=ac.head_dilation,
        bias=ac.head_bias,
        groups=1,
    )


def head_conv_specs(hc: HeadConfig) -> Tuple[Conv1dSpec, ...]:
    """Post-stack head convs: dilation 1, bias on (reference: model.cpp:21-44)."""
    specs = []
    cin = hc.in_channels
    n = len(hc.kernel_sizes)
    for i, k in enumerate(hc.kernel_sizes):
        cout = hc.out_channels if i + 1 == n else hc.channels
        specs.append(Conv1dSpec(cin, cout, kernel_size=k, dilation=1, bias=True, groups=1))
        cin = cout
    return tuple(specs)


# =============================================================================
# JSON parsing (reference: parse_config_json, NAM/wavenet/model.cpp:835-1198)
# =============================================================================


def _parse_gating_mode(s: str) -> str:
    if s not in (NONE, GATED, BLENDED):
        raise ValueError(f"Invalid gating_mode: {s}")
    return s


def _parse_film(layer_config: dict, key: str) -> FilmSite:
    """(reference: parse_film_params lambda, model.cpp:1124-1134)"""
    v = layer_config.get(key)
    if v is None or v is False:
        return FilmSite(False, False, 1)
    return FilmSite(
        active=bool(v.get("active", True)),
        shift=bool(v.get("shift", True)),
        groups=int(v.get("groups", 1)),
    )


def _parse_gating(layer_config: dict, index: int, num_layers: int):
    """gating_mode: array / single / legacy bool "gated" / default none
    (reference: model.cpp:983-1108). Returns (modes, secondary activations)."""
    if "gating_mode" in layer_config:
        gj = layer_config["gating_mode"]
        sj = layer_config.get("secondary_activation")
        if isinstance(gj, list):
            modes, secs = [], []
            for g in gj:
                mode = _parse_gating_mode(str(g))
                modes.append(mode)
                if mode == NONE:
                    secs.append(act.ActivationConfig())
                elif sj is None:
                    # Default Sigmoid for backward compatibility (model.cpp:1032-1036).
                    secs.append(act.ActivationConfig.simple("Sigmoid"))
                elif isinstance(sj, list):
                    if len(modes) > len(sj):
                        raise ValueError(
                            f"Layer array {index}: secondary_activation array size must be "
                            f"at least {len(modes)}"
                        )
                    secs.append(act.ActivationConfig.from_json(sj[len(modes) - 1]))
                else:
                    secs.append(act.ActivationConfig.from_json(sj))
            if len(modes) != num_layers:
                raise ValueError(
                    f"Layer array {index}: gating_mode array size ({len(modes)}) must match "
                    f"dilations size ({num_layers})"
                )
            if isinstance(sj, list) and len(sj) != num_layers:
                raise ValueError(
                    f"Layer array {index}: secondary_activation array size ({len(sj)}) must match "
                    f"dilations size ({num_layers})"
                )
            return tuple(modes), tuple(secs)
        mode = _parse_gating_mode(str(gj))
        if mode == NONE:
            sec = act.ActivationConfig()
        elif sj is not None:
            sec = act.ActivationConfig.from_json(sj)
        else:
            sec = act.ActivationConfig.simple("Sigmoid")
        return (mode,) * num_layers, (sec,) * num_layers
    if "gated" in layer_config:
        gated = bool(layer_config["gated"])
        sec = act.ActivationConfig.simple("Sigmoid") if gated else act.ActivationConfig()
        return (GATED if gated else NONE,) * num_layers, (sec,) * num_layers
    return (NONE,) * num_layers, (act.ActivationConfig(),) * num_layers


def _parse_layer_array(layer_config: dict, index: int) -> LayerArrayConfig:
    groups = int(layer_config.get("groups_input", 1))
    groups_input_mixin = int(layer_config.get("groups_input_mixin", 1))
    channels = int(layer_config["channels"])
    bottleneck = int(layer_config.get("bottleneck", channels))

    # layer1x1 defaults: ACTIVE, groups 1 (reference: model.cpp:864-872).
    layer1x1_active, layer1x1_groups = True, 1
    if "layer1x1" in layer_config:
        layer1x1_active = bool(layer_config["layer1x1"]["active"])
        layer1x1_groups = int(layer_config["layer1x1"]["groups"])

    input_size = int(layer_config["input_size"])
    condition_size = int(layer_config["condition_size"])

    # Head rechannel: nested "head" object or legacy head_size/head_bias
    # (reference: model.cpp:883-917).
    head_dilation, head_kernel_size = 1, 1
    hj = layer_config.get("head")
    if hj is not None:
        if not isinstance(hj, dict):
            raise ValueError(f"Layer array {index}: 'head' must be a JSON object")
        head_size = int(hj["out_channels"])
        head_dilation = int(hj.get("head_dilation", 1))
        head_kernel_size = int(hj["kernel_size"])
        head_bias = bool(hj["bias"])
    elif "head_size" in layer_config:
        head_size = int(layer_config["head_size"])
        head_bias = bool(layer_config["head_bias"])
    else:
        raise ValueError(
            f"Layer array {index}: expected 'head' object with out_channels, kernel_size, and "
            "bias, or legacy 'head_size' and 'head_bias'"
        )
    if head_kernel_size < 1:
        raise ValueError(f"Layer array {index}: head.kernel_size must be >= 1")

    dilations = tuple(int(d) for d in layer_config["dilations"])
    num_layers = len(dilations)

    # kernel_size (legacy scalar) vs kernel_sizes (reference: model.cpp:922-958).
    has_ks = "kernel_size" in layer_config
    has_kss = "kernel_sizes" in layer_config
    if has_ks and has_kss:
        raise ValueError(
            f"Layer array {index}: only one of kernel_size (int) or kernel_sizes (array) may be provided"
        )
    if has_kss:
        kernel_sizes = tuple(int(k) for k in layer_config["kernel_sizes"])
        if len(kernel_sizes) != num_layers:
            raise ValueError(
                f"Layer array {index}: kernel_sizes array size ({len(kernel_sizes)}) must match "
                f"dilations size ({num_layers})"
            )
    elif has_ks:
        kernel_sizes = (int(layer_config["kernel_size"]),) * num_layers
    else:
        raise ValueError(
            f"Layer array {index}: either kernel_size (int) or kernel_sizes (array) must be provided"
        )

    # activation: single or per-layer array (reference: model.cpp:960-981).
    aj = layer_config["activation"]
    if isinstance(aj, list):
        activations_ = tuple(act.ActivationConfig.from_json(a) for a in aj)
        if len(activations_) != num_layers:
            raise ValueError(
                f"Layer array {index}: activation array size ({len(activations_)}) must match "
                f"dilations size ({num_layers})"
            )
    else:
        activations_ = (act.ActivationConfig.from_json(aj),) * num_layers

    gating_modes, secondary = _parse_gating(layer_config, index, num_layers)

    # head1x1 defaults: inactive (reference: model.cpp:1110-1121).
    head1x1_active, head1x1_out_channels, head1x1_groups = False, channels, 1
    if "head1x1" in layer_config:
        h1 = layer_config["head1x1"]
        head1x1_active = bool(h1["active"])
        head1x1_out_channels = int(h1["out_channels"])
        head1x1_groups = int(h1["groups"])

    films = tuple((site, _parse_film(layer_config, site)) for site in FILM_SITES)

    # Validation (reference: model.cpp:1146-1151, detail.h:60-71, 80-85).
    films_d = dict(films)
    if films_d["layer1x1_post_film"].active and not layer1x1_active:
        raise ValueError(
            f"Layer array {index}: layer1x1_post_film cannot be active when layer1x1.active is false"
        )
    if not layer1x1_active and bottleneck != channels:
        raise ValueError(
            f"When layer1x1.active is false, bottleneck ({bottleneck}) must equal channels ({channels})"
        )
    if films_d["head1x1_post_film"].active and not head1x1_active:
        raise ValueError("Do not use post-head 1x1 FiLM if there is no head 1x1")

    return LayerArrayConfig(
        input_size=input_size,
        condition_size=condition_size,
        head_size=head_size,
        head_dilation=head_dilation,
        head_kernel_size=head_kernel_size,
        channels=channels,
        bottleneck=bottleneck,
        kernel_sizes=kernel_sizes,
        dilations=dilations,
        activations=activations_,
        gating_modes=gating_modes,
        secondary_activations=secondary,
        head_bias=head_bias,
        groups_input=groups,
        groups_input_mixin=groups_input_mixin,
        layer1x1_active=layer1x1_active,
        layer1x1_groups=layer1x1_groups,
        head1x1_active=head1x1_active,
        head1x1_out_channels=head1x1_out_channels,
        head1x1_groups=head1x1_groups,
        films=films,
    )


def build(config: dict, weights: np.ndarray, sample_rate: float, device):
    """Parse config JSON + consume the flat weight stream -> (config, params)
    (reference: parse_config_json model.cpp:835-1198 + WaveNet::set_weights_
    model.cpp:623-645)."""
    condition_config = None
    condition_params = None
    if config.get("condition_dsp") is not None:
        # Nested full .nam spec, built recursively (reference: model.cpp:840-852).
        sub = parse_nam_json(config["condition_dsp"])
        sub_arch = registry.get_architecture(sub.architecture)
        condition_config, condition_params = sub_arch.build(
            sub.config, sub.weights, sub.expected_sample_rate, device
        )
        if sub.expected_sample_rate != sample_rate:
            raise ValueError(
                f"Condition DSP expected sample rate ({sub.expected_sample_rate}) doesn't match "
                f"WaveNet expected sample rate ({sample_rate})"
            )

    layer_arrays = tuple(_parse_layer_array(lc, i) for i, lc in enumerate(config["layers"]))
    if not layer_arrays:
        raise ValueError("WaveNet config requires at least one layer array")

    in_channels = int(config.get("in_channels", 1))

    # Cross-array chaining validation (reference: model.cpp:604-611).
    for i in range(1, len(layer_arrays)):
        if layer_arrays[i].channels != layer_arrays[i - 1].head_size:
            raise ValueError(
                f"channels of layer {i} ({layer_arrays[i].channels}) doesn't match head_size of "
                f"preceding layer ({layer_arrays[i - 1].head_size})"
            )

    # Condition DSP channel checks (reference: model.cpp:562-571, 589-602).
    if condition_config is not None:
        sub_arch = registry.arch_for_config(condition_config)
        if sub_arch.in_channels(condition_config) != in_channels:
            raise ValueError(
                f"input channels of WaveNet ({in_channels}) don't match input channels of "
                f"condition DSP ({sub_arch.in_channels(condition_config)})"
            )
        for i, ac in enumerate(layer_arrays):
            if ac.condition_size != sub_arch.out_channels(condition_config):
                raise ValueError(
                    f"condition_size of layer {i} ({ac.condition_size}) doesn't match output "
                    f"channels of condition DSP ({sub_arch.out_channels(condition_config)})"
                )

    # Post-stack head (reference: model.cpp:1161-1195).
    head_cfg = None
    if config.get("head") is not None:
        hj = config["head"]
        implied_in = layer_arrays[-1].head_size
        if hj.get("in_channels") is not None:
            legacy_in = int(hj["in_channels"])
            if legacy_in != implied_in:
                raise ValueError(
                    f"WaveNet config: head.in_channels ({legacy_in}) must equal last layer's "
                    f"head_size ({implied_in})"
                )
        kernel_sizes = tuple(int(k) for k in hj["kernel_sizes"])
        if not kernel_sizes:
            raise ValueError("WaveNet config: head.kernel_sizes must be non-empty")
        if any(k < 1 for k in kernel_sizes):
            raise ValueError("WaveNet Head: kernel_sizes entries must be >= 1")
        head_cfg = HeadConfig(
            in_channels=implied_in,
            channels=int(hj["channels"]),
            out_channels=int(hj["out_channels"]),
            kernel_sizes=kernel_sizes,
            activation=act.ActivationConfig.from_json(hj["activation"]),
        )

    cfg = WaveNetConfig(
        in_channels=in_channels,
        layer_arrays=layer_arrays,
        head=head_cfg,
        condition_config=condition_config,
        sample_rate=float(sample_rate),
    )

    reader = WeightReader(weights)
    params = _build_params(cfg, reader, condition_params, device)
    # head_scale is the trailing weight (reference: model.cpp:632).
    params["head_scale"] = torch.tensor(reader.take_scalar(), dtype=torch.float32, device=device)
    reader.assert_exhausted()
    return cfg, params


def _build_params(cfg: WaveNetConfig, reader: WeightReader, condition_params, device) -> Dict[str, Any]:
    arrays = []
    for ac in cfg.layer_arrays:
        ap: Dict[str, Any] = {"rechannel": conv1x1_params(rechannel_spec(ac), reader, device)}
        layers = []
        for i in range(ac.num_layers):
            # Weight order (reference: Layer::set_weights_, model.cpp:135-164).
            lp: Dict[str, Any] = {
                "conv": conv1d_params(layer_conv_spec(ac, i), reader, device),
                "mixin": conv1x1_params(layer_mixin_spec(ac, i), reader, device),
            }
            l1 = layer1x1_spec(ac)
            if l1 is not None:
                lp["layer1x1"] = conv1x1_params(l1, reader, device)
            h1 = head1x1_spec(ac)
            if h1 is not None:
                lp["head1x1"] = conv1x1_params(h1, reader, device)
            for site in FILM_SITES:
                fspec = layer_film_spec(ac, i, site)
                if fspec is not None:
                    lp[site] = film_params(fspec, reader, device)
            layers.append(lp)
        ap["layers"] = layers
        ap["head_rechannel"] = conv1d_params(head_rechannel_spec(ac), reader, device)
        arrays.append(ap)
    params: Dict[str, Any] = {"arrays": arrays}
    if cfg.head is not None:
        params["head"] = [conv1d_params(s, reader, device) for s in head_conv_specs(cfg.head)]
    if condition_params is not None:
        params["condition"] = condition_params
    return params


def _device_of(params) -> torch.device:
    return params["head_scale"].device


# =============================================================================
# Generic tier: state and step
# =============================================================================


def init_state(cfg: WaveNetConfig, params, batch: int):
    device = _device_of(params)
    state: Dict[str, Any] = {"arrays": []}
    for ac in cfg.layer_arrays:
        state["arrays"].append(
            {
                "layers": [
                    conv1d_init_state(layer_conv_spec(ac, i), batch, device) for i in range(ac.num_layers)
                ],
                "head_rechannel": conv1d_init_state(head_rechannel_spec(ac), batch, device),
            }
        )
    if cfg.head is not None:
        state["head"] = [conv1d_init_state(s, batch, device) for s in head_conv_specs(cfg.head)]
    if cfg.condition_config is not None:
        sub_arch = registry.arch_for_config(cfg.condition_config)
        state["condition"] = sub_arch.init_state(cfg.condition_config, params["condition"], batch)
    return state


def _layer_step(ac: LayerArrayConfig, i: int, lp, lstate, x, cond):
    """One layer (reference: Layer::Process, model.cpp:166-376)."""
    gating = ac.gating_modes[i]

    h = x
    fs = layer_film_spec(ac, i, "conv_pre_film")
    if fs is not None:
        h = film_apply(fs, lp["conv_pre_film"], h, cond)
    c, new_lstate = conv1d_step(layer_conv_spec(ac, i), lp["conv"], lstate, h)
    fs = layer_film_spec(ac, i, "conv_post_film")
    if fs is not None:
        c = film_apply(fs, lp["conv_post_film"], c, cond)

    m_in = cond
    fs = layer_film_spec(ac, i, "input_mixin_pre_film")
    if fs is not None:
        m_in = film_apply(fs, lp["input_mixin_pre_film"], cond, cond)
    m = conv1x1_apply(layer_mixin_spec(ac, i), lp["mixin"], m_in)
    fs = layer_film_spec(ac, i, "input_mixin_post_film")
    if fs is not None:
        m = film_apply(fs, lp["input_mixin_post_film"], m, cond)

    z = c + m
    fs = layer_film_spec(ac, i, "activation_pre_film")
    if fs is not None:
        z = film_apply(fs, lp["activation_pre_film"], z, cond)

    # Activation / gating / blending (reference: model.cpp:217-271).
    if gating == NONE:
        a = act.apply(ac.activations[i], z)
    elif gating == GATED:
        a = gated_apply(ac.activations[i], ac.secondary_activations[i], z, ac.bottleneck)
    else:
        a = blended_apply(ac.activations[i], ac.secondary_activations[i], z, ac.bottleneck)

    fs = layer_film_spec(ac, i, "activation_post_film")
    if fs is not None:
        a = film_apply(fs, lp["activation_post_film"], a, cond)

    l1 = layer1x1_spec(ac)
    if l1 is not None:
        l = conv1x1_apply(l1, lp["layer1x1"], a)
        # Reference quirk: layer1x1_post_film only in blended mode
        # (model.cpp:262-270).
        fs = layer_film_spec(ac, i, "layer1x1_post_film")
        if fs is not None and gating == BLENDED:
            l = film_apply(fs, lp["layer1x1_post_film"], l, cond)
        out_next = x + l
    else:
        out_next = x

    h1 = head1x1_spec(ac)
    if h1 is not None:
        hd = conv1x1_apply(h1, lp["head1x1"], a)
        fs = layer_film_spec(ac, i, "head1x1_post_film")
        if fs is not None:
            hd = film_apply(fs, lp["head1x1_post_film"], hd, cond)
    else:
        hd = a
    return out_next, hd, new_lstate


def step(cfg: WaveNetConfig, params, state, x):
    """Generic block step (any T per call), x: (B, T, Cin) -> (y, state')
    (reference: WaveNet::process, model.cpp:744-832)."""
    new_state: Dict[str, Any] = {"arrays": []}
    if cfg.condition_config is not None:
        sub_arch = registry.arch_for_config(cfg.condition_config)
        cond, new_state["condition"] = sub_arch.step(
            cfg.condition_config, params["condition"], state["condition"], x
        )
    else:
        cond = x

    layer_out = x
    B, T = x.shape[0], x.shape[1]
    head_out = torch.zeros((B, T, cfg.layer_arrays[0].head_output_size), device=x.device)
    for ai, ac in enumerate(cfg.layer_arrays):
        ap, astate = params["arrays"][ai], state["arrays"][ai]
        h = conv1x1_apply(rechannel_spec(ac), ap["rechannel"], layer_out)
        head_acc = head_out  # zeros for the first array, carried for the rest
        new_layers = []
        for i in range(ac.num_layers):
            h, hd, ls = _layer_step(ac, i, ap["layers"][i], astate["layers"][i], h, cond)
            new_layers.append(ls)
            head_acc = head_acc + hd
        layer_out = h
        head_out, hr_state = conv1d_step(
            head_rechannel_spec(ac), ap["head_rechannel"], astate["head_rechannel"], head_acc
        )
        new_state["arrays"].append({"layers": new_layers, "head_rechannel": hr_state})

    head_scale = params["head_scale"]
    if cfg.head is None:
        return head_scale * head_out, new_state
    # Post-stack head: scale, then repeated (activation -> Conv1D)
    # (reference: model.cpp:776-805, Head::process model.cpp:69-86).
    work = head_scale * head_out
    new_head = []
    for si, spec in enumerate(head_conv_specs(cfg.head)):
        work = act.apply(cfg.head.activation, work)
        work, hs = conv1d_step(spec, params["head"][si], state["head"][si], work)
        new_head.append(hs)
    new_state["head"] = new_head
    return work, new_state


# =============================================================================
# Engine tier: fixed block size T, ring-chunk conv states, (C, T, B) layout
# =============================================================================


def _film_ctb(spec: FiLMSpec, ep, x, cond):
    """FiLM in (C, T, B) layout (reference: NAM/film.h:76-190)."""
    ss = conv1x1_ctb(spec.cond_spec, ep, cond)
    if spec.shift:
        return x * ss[: spec.input_dim] + ss[spec.input_dim :]
    return x * ss


def engine_prepare(cfg: WaveNetConfig, params, T: int, batch: int):
    """Engine-layout weights (transposed / tap-stacked) + zero ring state."""
    device = _device_of(params)
    eparams: Dict[str, Any] = {"arrays": [], "head_scale": params["head_scale"]}
    state: Dict[str, Any] = {"arrays": []}
    for ai, ac in enumerate(cfg.layer_arrays):
        ap = params["arrays"][ai]
        elayers, lstates = [], []
        for i in range(ac.num_layers):
            lp = ap["layers"][i]
            elp: Dict[str, Any] = {
                "conv": conv1d_w_ctb(layer_conv_spec(ac, i), lp["conv"]),
                "mixin": conv1x1_w_ctb(layer_mixin_spec(ac, i), lp["mixin"]),
            }
            l1 = layer1x1_spec(ac)
            if l1 is not None:
                elp["layer1x1"] = conv1x1_w_ctb(l1, lp["layer1x1"])
            h1 = head1x1_spec(ac)
            if h1 is not None:
                elp["head1x1"] = conv1x1_w_ctb(h1, lp["head1x1"])
            for site in FILM_SITES:
                fspec = layer_film_spec(ac, i, site)
                if fspec is not None:
                    elp[site] = conv1x1_w_ctb(fspec.cond_spec, lp[site])
            elayers.append(elp)
            lstates.append(ring_conv_init(layer_conv_spec(ac, i), T, batch, device))
        eparams["arrays"].append(
            {
                "rechannel": conv1x1_w_ctb(rechannel_spec(ac), ap["rechannel"]),
                "layers": elayers,
                "head_rechannel": conv1d_w_ctb(head_rechannel_spec(ac), ap["head_rechannel"]),
            }
        )
        state["arrays"].append(
            {
                "layers": lstates,
                "head_rechannel": ring_conv_init(head_rechannel_spec(ac), T, batch, device),
            }
        )
    if cfg.head is not None:
        specs = head_conv_specs(cfg.head)
        eparams["head"] = [conv1d_w_ctb(s, params["head"][si]) for si, s in enumerate(specs)]
        state["head"] = [ring_conv_init(s, T, batch, device) for s in specs]
    if cfg.condition_config is not None:
        sub_prepare, _ = registry.engine_fns(registry.arch_for_config(cfg.condition_config))
        eparams["condition"], state["condition"] = sub_prepare(
            cfg.condition_config, params["condition"], T, batch
        )
    return eparams, state


def _engine_layer_step(ac: LayerArrayConfig, i: int, T: int, elp, lstate, x, cond):
    """One layer in (C, T, B) layout; the same graph as ``_layer_step``."""
    gating = ac.gating_modes[i]
    bn = ac.bottleneck

    h = x
    fs = layer_film_spec(ac, i, "conv_pre_film")
    if fs is not None:
        h = _film_ctb(fs, elp["conv_pre_film"], h, cond)
    c, new_lstate = ring_conv_step(layer_conv_spec(ac, i), T, elp["conv"], lstate, h)
    fs = layer_film_spec(ac, i, "conv_post_film")
    if fs is not None:
        c = _film_ctb(fs, elp["conv_post_film"], c, cond)
    m_in = cond
    fs = layer_film_spec(ac, i, "input_mixin_pre_film")
    if fs is not None:
        m_in = _film_ctb(fs, elp["input_mixin_pre_film"], cond, cond)
    m = conv1x1_ctb(layer_mixin_spec(ac, i), elp["mixin"], m_in)
    fs = layer_film_spec(ac, i, "input_mixin_post_film")
    if fs is not None:
        m = _film_ctb(fs, elp["input_mixin_post_film"], m, cond)
    z = c + m
    fs = layer_film_spec(ac, i, "activation_pre_film")
    if fs is not None:
        z = _film_ctb(fs, elp["activation_pre_film"], z, cond)

    if gating == NONE:
        a = act.apply(ac.activations[i], z, channel_axis=0)
    elif gating == GATED:
        a = act.apply(ac.activations[i], z[:bn], channel_axis=0) * act.apply(
            ac.secondary_activations[i], z[bn:], channel_axis=0
        )
    else:  # BLENDED
        alpha = act.apply(ac.secondary_activations[i], z[bn:], channel_axis=0)
        a = alpha * act.apply(ac.activations[i], z[:bn], channel_axis=0) + (1.0 - alpha) * z[:bn]

    fs = layer_film_spec(ac, i, "activation_post_film")
    if fs is not None:
        a = _film_ctb(fs, elp["activation_post_film"], a, cond)

    l1 = layer1x1_spec(ac)
    if l1 is not None:
        l = conv1x1_ctb(l1, elp["layer1x1"], a)
        # Reference quirk: layer1x1_post_film only in blended mode
        # (model.cpp:262-270).
        fs = layer_film_spec(ac, i, "layer1x1_post_film")
        if fs is not None and gating == BLENDED:
            l = _film_ctb(fs, elp["layer1x1_post_film"], l, cond)
        out_next = x + l
    else:
        out_next = x

    h1 = head1x1_spec(ac)
    if h1 is not None:
        hd = conv1x1_ctb(h1, elp["head1x1"], a)
        fs = layer_film_spec(ac, i, "head1x1_post_film")
        if fs is not None:
            hd = _film_ctb(fs, elp["head1x1_post_film"], hd, cond)
    else:
        hd = a
    return out_next, hd, new_lstate


def engine_step(cfg: WaveNetConfig, T: int, eparams, state, x):
    """Block step in (C, T, B) layout with ring-chunk conv states (the analog
    of the reference's A2 ring design, NAM/wavenet/a2_fast.cpp:340-402).
    x: (in_channels, T, B) -> (y (out_channels, T, B), state'). Ring writes
    are in place, so ``state`` is consumed."""
    new_state: Dict[str, Any] = {"arrays": []}
    if cfg.condition_config is not None:
        _, sub_step = registry.engine_fns(registry.arch_for_config(cfg.condition_config))
        cond, new_state["condition"] = sub_step(
            cfg.condition_config, T, eparams["condition"], state["condition"], x
        )
    else:
        cond = x

    layer_out = x
    head_out = torch.zeros((cfg.layer_arrays[0].head_output_size, T, x.shape[2]), device=x.device)
    for ai, ac in enumerate(cfg.layer_arrays):
        eap, astate = eparams["arrays"][ai], state["arrays"][ai]
        h = conv1x1_ctb(rechannel_spec(ac), eap["rechannel"], layer_out)
        head_acc = head_out
        new_layers = []
        for i in range(ac.num_layers):
            h, hd, ls = _engine_layer_step(ac, i, T, eap["layers"][i], astate["layers"][i], h, cond)
            new_layers.append(ls)
            head_acc = head_acc + hd
        layer_out = h
        head_out, hr_state = ring_conv_step(
            head_rechannel_spec(ac), T, eap["head_rechannel"], astate["head_rechannel"], head_acc
        )
        new_state["arrays"].append({"layers": new_layers, "head_rechannel": hr_state})

    head_scale = eparams["head_scale"]
    if cfg.head is None:
        return head_scale * head_out, new_state
    work = head_scale * head_out
    new_head = []
    for si, spec in enumerate(head_conv_specs(cfg.head)):
        work = act.apply(cfg.head.activation, work, channel_axis=0)
        work, hs = ring_conv_step(spec, T, eparams["head"][si], state["head"][si], work)
        new_head.append(hs)
    new_state["head"] = new_head
    return work, new_state


# =============================================================================
# Prewarm / registration
# =============================================================================


def prewarm_samples(cfg: WaveNetConfig, sample_rate: float) -> int:
    """1 + sum of array receptive fields (+ condition prewarm, + post head RF-1)
    (reference: model.cpp:615-620)."""
    if cfg.condition_config is not None:
        sub_arch = registry.arch_for_config(cfg.condition_config)
        n = sub_arch.prewarm_samples(cfg.condition_config, sample_rate)
    else:
        n = 1
    n += sum(ac.receptive_field() for ac in cfg.layer_arrays)
    if cfg.head is not None:
        n += cfg.head.receptive_field() - 1
    return n


registry.register_architecture(
    registry.ArchDef(
        name="WaveNet",
        config_cls=WaveNetConfig,
        build=build,
        init_state=init_state,
        step=step,
        prewarm_samples=prewarm_samples,
        in_channels=lambda c: c.in_channels,
        out_channels=lambda c: c.out_channels_,
        engine_prepare=engine_prepare,
        engine_step=engine_step,
    )
)
