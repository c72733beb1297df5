"""Port loader against the JAX loader: version gate, weight-count errors,
parsed configs and parameters, on documents built by the generator with a
numpy seed (the same document goes to both packages)."""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

import neuralampmodelercore_tpu as jnam
import neuralampmodelercore_tpu_torch as tnam
from neuralampmodelercore_tpu import version as jversion
from neuralampmodelercore_tpu.tools.generate import make_nam, wavenet_preset, with_condition_dsp
from neuralampmodelercore_tpu_torch import registry as tregistry
from neuralampmodelercore_tpu_torch import version as tversion
from neuralampmodelercore_tpu_torch.convert import params_from_jax
from neuralampmodelercore_tpu_torch.tools import generate as tgenerate


def _layer(**kw):
    base = dict(input_size=1, condition_size=1, head_size=1, channels=4, kernel_size=3,
                dilations=[1, 2], activation="Tanh", gated=False, head_bias=True)
    base.update(kw)
    return base


CONFIGS = {
    "simple": wavenet_preset("simple"),
    "standard": wavenet_preset("standard"),
    "gated_bottleneck": {"layers": [_layer(channels=6, bottleneck=3, gated=True, head_size=1)], "head": None},
    "blended_head1x1": {
        "layers": [_layer(gating_mode="blended", secondary_activation="Hardtanh",
                          head1x1={"active": True, "out_channels": 3, "groups": 1})],
        "head": None,
    },
    "films_groups": {
        "layers": [_layer(channels=4, groups_input=2, layer1x1={"active": True, "groups": 2},
                          conv_pre_film={"active": True, "shift": True},
                          activation_post_film={"active": True, "shift": False})],
        "head": None,
    },
    "post_head": {
        "layers": [_layer(head_size=3)],
        "head": {"channels": 4, "out_channels": 1, "kernel_sizes": [3, 1], "activation": "ReLU"},
    },
    "condition_dsp": with_condition_dsp(
        {"layers": [_layer(channels=4)], "head": None},
        make_nam("WaveNet", wavenet_preset("simple"), seed=5),
    ),
}


@pytest.mark.parametrize(
    "v", ["0.5.0", "0.5.4", "0.7.0", "0.7.3", "0.8.0", "0.4.9", "1.0.0", "1.7.0", "abc", "0.5", "0.5.-1"]
)
def test_version_gate_matches_jax(v):
    """Same support level, and the same verdict from verify_config_version."""
    assert int(tversion.is_version_supported(v)) == int(jversion.is_version_supported(v))
    results = []
    for mod in (tversion, jversion):
        try:
            mod.verify_config_version(v)
            results.append("ok")
        except mod.VersionError as e:
            results.append(str(e))
    assert results[0] == results[1]


@pytest.mark.parametrize("delta", [-1, 1])
def test_weight_count_errors_match_jax(delta):
    doc = make_nam("WaveNet", wavenet_preset("simple"), seed=0)
    w = doc["weights"]
    doc = dict(doc, weights=w[:delta] if delta < 0 else w + [0.5])
    msgs = []
    for load in (jnam.load_model, lambda d: tnam.load_model(d, device="cpu")):
        with pytest.raises(ValueError) as e:
            load(doc)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "Weight mismatch" in msgs[1]


def test_missing_keys_and_bad_version_raise():
    doc = make_nam("WaveNet", wavenet_preset("simple"), seed=0)
    for key in ("version", "architecture", "config", "weights"):
        bad = {k: v for k, v in doc.items() if k != key}
        with pytest.raises(ValueError, match=f"missing {key}"):
            tnam.load_model(bad, device="cpu")
    with pytest.raises(tversion.VersionError):
        tnam.load_model(dict(doc, version="0.9.0"), device="cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_parsed_config_matches_jax(name):
    doc = make_nam("WaveNet", CONFIGS[name], seed=11)
    jm = jnam.load_model(doc)
    tm = tnam.load_model(doc, device="cpu")
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    assert tm.get_prewarm_samples() == jm.get_prewarm_samples()
    assert tm.num_params() == jm.num_params()


def _assert_trees_equal(a, b, path="params"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        assert isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor), path
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert torch.equal(a, b), path


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_from_jax_equal_port_params(name):
    doc = make_nam("WaveNet", CONFIGS[name], seed=12)
    jm = jnam.load_model(doc)
    tm = tnam.load_model(doc, device="cpu")
    converted = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    _assert_trees_equal(converted, tm.params)


def test_generator_copy_matches_jax_generator():
    """The port's generator gives the same document as the JAX package's."""
    for name in ("simple", "standard", "small"):
        assert tgenerate.wavenet_preset(name) == wavenet_preset(name)
    doc_j = make_nam("WaveNet", CONFIGS["post_head"], seed=3)
    doc_t = tgenerate.make_nam("WaveNet", CONFIGS["post_head"], seed=3)
    assert doc_j == doc_t
    sub = make_nam("WaveNet", wavenet_preset("simple"), seed=1)
    assert tgenerate.with_condition_dsp(wavenet_preset("standard"), sub) == with_condition_dsp(
        wavenet_preset("standard"), sub
    )
    for arch, config in (("LSTM", {"input_size": 1, "hidden_size": 16, "num_layers": 2}),
                         ("ConvNet", {"channels": 16, "dilations": [1, 2, 4], "batchnorm": True,
                                      "activation": "Tanh"})):
        assert tgenerate.make_nam(arch, config, seed=4, sample_rate=44100) == make_nam(
            arch, config, seed=4, sample_rate=44100)


def test_metadata_return_data_and_prewarm_option():
    doc = make_nam(
        "WaveNet", wavenet_preset("simple"), seed=0,
        metadata={"loudness": -12.5, "input_level_dbu": 3.0},
    )
    m, data = tnam.load_model(doc, return_data=True, device="cpu")
    jm = jnam.load_model(doc)
    assert dataclasses.asdict(m.metadata) == dataclasses.asdict(jm.metadata)
    assert data.architecture == "WaveNet" and m.get_loudness() == -12.5
    assert not m.has_output_level()
    with pytest.raises(RuntimeError):
        m.get_output_level()
    m2 = tnam.load_model(doc, prewarm=False, device="cpu")
    j2 = jnam.load_model(doc, prewarm=False)
    assert m2.prewarm_on_reset == j2.prewarm_on_reset


@pytest.mark.parametrize(
    "arch,config",
    [
        ("LSTM", {"input_size": 1, "hidden_size": 4, "num_layers": 1}),
        ("ConvNet", {"channels": 4, "dilations": [1, 2], "batchnorm": False, "activation": "Tanh"}),
    ],
)
def test_ported_architectures_load_and_match_jax(arch, config):
    """LSTM and ConvNet load, alone and as a nested condition DSP, with the
    JAX loader's config, prewarm count and bit-equal parameters."""
    doc = make_nam(arch, config, seed=0)
    nested = make_nam("WaveNet", with_condition_dsp({"layers": [_layer()], "head": None}, doc), seed=0)
    for d in (doc, nested):
        jm, tm = jnam.load_model(d), tnam.load_model(d, device="cpu")
        assert tm.architecture == jm.architecture
        assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
        assert tm.get_prewarm_samples() == jm.get_prewarm_samples()
        _assert_trees_equal(params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), "cpu"), tm.params)


@pytest.mark.parametrize("arch,config", [("Linear", {"receptive_field": 8, "bias": True})])
def test_unported_architectures_raise_with_roadmap_item(arch, config):
    doc = make_nam(arch, config, seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, the Linear item"):
        tnam.load_model(doc, device="cpu")
    # As a nested condition DSP too.
    nested = make_nam("WaveNet", with_condition_dsp({"layers": [_layer()], "head": None}, doc), seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, the Linear item"):
        tnam.load_model(nested, device="cpu")


def test_meta_models_and_legacy_loader_raise():
    cfg = wavenet_preset("simple")
    cfg["layers"][0]["slimmable"] = {"method": "slice_channels_uniform"}
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, the Meta-models item"):
        tnam.load_model({"version": "0.5.4", "architecture": "WaveNet", "config": cfg, "weights": []},
                        device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, the Meta-models item"):
        tnam.load_model({"version": "0.5.4", "architecture": "SlimmableContainer", "config": {},
                         "weights": []}, device="cpu")
    with pytest.raises(NotImplementedError, match="legacy"):
        tnam.get_dsp_legacy("some_dir")
    with pytest.raises(FileNotFoundError):
        tnam.load_model("/nonexistent/model.nam", device="cpu")
    assert tnam.get_dsp is tnam.load_model
    assert tregistry.has_architecture("WaveNet") and not tregistry.has_architecture("Linear")


@pytest.mark.parametrize("name", sorted(tregistry.NOT_PORTED))
def test_not_ported_errors_name_the_roadmap_item_by_title(name):
    """Each architecture the port still refuses is one the JAX package
    loads (Linear through its registry, the meta-models through the classes
    it exports), and the port's error names the ROADMAP Queue 1 item that
    ports it by its title, Linear or Meta-models, with no item number to go
    stale."""
    from neuralampmodelercore_tpu import registry as jregistry

    if name == "Linear":
        assert jregistry.has_architecture(name)
    else:
        assert {"SlimmableWavenet": "SlimmableWavenetModel", "SlimmableContainer": "ContainerModel"}[name] in jnam.__all__
    message = str(tregistry.not_ported(name))
    assert f"ROADMAP Queue 1, the {'Linear' if name == 'Linear' else 'Meta-models'} item" in message
    assert not re.search(r"item \d", message)
