"""Parsing of .nam model files.

The port's copy of ``neuralampmodelercore_tpu.formats``. A .nam file is a JSON
document ``{version, architecture, config, weights: [flat floats], metadata?,
sample_rate?}`` (reference: NAM/dsp.h:345-357, NAM/get_dsp.cpp:142-155). It
parses into a :class:`NamData` plus a :class:`WeightReader` that architecture
builders consume in the exact stream order the reference uses. The weight
stream stays a host numpy array: builders move each parameter to its device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

import numpy as np

from .version import verify_config_version

UNKNOWN_EXPECTED_SAMPLE_RATE = -1.0  # reference: NAM/dsp.h:30


@dataclasses.dataclass
class NamData:
    """All information needed to instantiate a model (reference ``dspData``,
    NAM/dsp.h:345-357)."""

    version: str
    architecture: str
    config: Dict[str, Any]
    metadata: Dict[str, Any]
    weights: np.ndarray  # flat float32 stream
    expected_sample_rate: float


def get_sample_rate_from_nam_json(j: dict) -> float:
    """(reference: NAM/get_dsp.cpp:280-286)"""
    return float(j.get("sample_rate", UNKNOWN_EXPECTED_SAMPLE_RATE))


def parse_nam_json(j: dict) -> NamData:
    """Parse an in-memory .nam JSON document
    (reference: populate_dsp_data, NAM/get_dsp.cpp:142-155)."""
    for key in ("version", "architecture", "config"):
        if key not in j:
            raise ValueError(f"Corrupted model file is missing {key}.")
    verify_config_version(str(j["version"]))
    if "weights" not in j:
        raise ValueError("Corrupted model file is missing weights.")
    return NamData(
        version=str(j["version"]),
        architecture=str(j["architecture"]),
        config=j["config"],
        metadata=j.get("metadata") or {},
        weights=np.asarray(j["weights"], dtype=np.float32),
        expected_sample_rate=get_sample_rate_from_nam_json(j),
    )


def parse_nam_file(path: Union[str, os.PathLike]) -> NamData:
    if not os.path.exists(path):
        raise FileNotFoundError("Config file doesn't exist!")
    with open(path, "r") as f:
        j = json.load(f)
    return parse_nam_json(j)


class WeightReader:
    """Sequential consumer of the flat weight stream (the analog of the
    reference's ``std::vector<float>::iterator&``, e.g. NAM/conv1d.cpp:10-54).
    Builders call :meth:`take` in reference order, then the model builder
    calls :meth:`assert_exhausted`."""

    def __init__(self, weights: np.ndarray):
        self._w = np.asarray(weights, dtype=np.float32).reshape(-1)
        self._pos = 0

    @property
    def position(self) -> int:
        return self._pos

    @property
    def remaining(self) -> int:
        return self._w.size - self._pos

    def take(self, n: int) -> np.ndarray:
        if n < 0:
            raise ValueError(f"WeightReader.take: negative count {n}")
        if self._pos + n > self._w.size:
            raise ValueError(
                f"Weight mismatch: model expects more weights (needed {n} more at "
                f"position {self._pos}, but only {self._w.size} were provided)."
            )
        out = self._w[self._pos : self._pos + n]
        self._pos += n
        return out

    def take_scalar(self) -> float:
        return float(self.take(1)[0])

    def assert_exhausted(self) -> None:
        """(reference: NAM/wavenet/model.cpp:633-644)"""
        if self._pos != self._w.size:
            raise ValueError(
                f"Weight mismatch: assigned {self._pos} weights, but {self._w.size} were provided."
            )


@dataclasses.dataclass
class ModelMetadata:
    """Metadata applied to a model after construction (reference: ModelMetadata
    in NAM/model_config.h + apply_metadata, NAM/get_dsp.cpp:214-260)."""

    version: str = ""
    sample_rate: float = UNKNOWN_EXPECTED_SAMPLE_RATE
    loudness: Optional[float] = None
    input_level_dbu: Optional[float] = None
    output_level_dbu: Optional[float] = None

    @staticmethod
    def from_nam_data(data: NamData) -> "ModelMetadata":
        md = data.metadata or {}

        def extract(key: str) -> Optional[float]:
            v = md.get(key)
            return float(v) if v is not None else None

        return ModelMetadata(
            version=data.version,
            sample_rate=data.expected_sample_rate,
            loudness=extract("loudness"),
            input_level_dbu=extract("input_level_dbu"),
            output_level_dbu=extract("output_level_dbu"),
        )
