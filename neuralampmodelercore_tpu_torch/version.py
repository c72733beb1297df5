"""Version gating for .nam model files.

The port's copy of ``neuralampmodelercore_tpu.version`` (the reference's
semver gate, NAM/get_dsp.cpp:19-129, NAM/get_dsp.h:58-67, NAM/version.h).

Semantics (matching CoreVersionSupportChecker, NAM/get_dsp.cpp:22-39):
  - malformed (non ``\\d+.\\d+.\\d+``) -> NO
  - below the earliest supported version -> NO
  - major or minor beyond the latest fully supported -> NO
  - patch beyond the latest fully supported -> PARTIAL (load with a warning)
  - otherwise -> YES

External code can register additional checkers; the best (max) support level
across all checkers wins, mirroring ``nam::is_version_supported``
(NAM/get_dsp.cpp:101-112).
"""

from __future__ import annotations

import enum
import re
import sys
import threading
from dataclasses import dataclass
from typing import Callable, List

__version__ = "0.1.0"

# .nam file-version window (reference: NAM/get_dsp.h:66-67).
EARLIEST_SUPPORTED_NAM_FILE_VERSION = "0.5.0"
LATEST_FULLY_SUPPORTED_NAM_FILE_VERSION = "0.7.0"

_SEMVER_RE = re.compile(r"^\d+\.\d+\.\d+$")


class Supported(enum.IntEnum):
    """Support level for a .nam file version (reference: NAM/get_dsp.h:12-17)."""

    NO = 0
    PARTIAL = 1
    YES = 2


@dataclass(frozen=True, order=True)
class Version:
    major: int
    minor: int
    patch: int

    def __str__(self) -> str:
        return f"{self.major}.{self.minor}.{self.patch}"


class VersionError(ValueError):
    """Raised when a .nam file version is unsupported."""


def parse_version(version_str: str) -> Version:
    """Parse ``major.minor.patch``; raises ValueError on malformed input
    (reference: nam::ParseVersion, NAM/get_dsp.cpp:57-91)."""
    parts = version_str.split(".")
    if len(parts) != 3:
        raise ValueError(f"Invalid version string: {version_str}")
    try:
        major, minor, patch = (int(p) for p in parts)
    except ValueError as e:
        raise ValueError(f"Invalid version string: {version_str}") from e
    if major < 0 or minor < 0 or patch < 0:
        raise ValueError(f"Negative version component: {version_str}")
    return Version(major, minor, patch)


def _core_checker(version_str: str) -> Supported:
    if not _SEMVER_RE.match(version_str):
        return Supported.NO
    parsed = parse_version(version_str)
    latest = parse_version(LATEST_FULLY_SUPPORTED_NAM_FILE_VERSION)
    earliest = parse_version(EARLIEST_SUPPORTED_NAM_FILE_VERSION)
    if parsed < earliest:
        return Supported.NO
    # The minor check is independent of major, as in the reference
    # (get_dsp.cpp:34).
    if parsed.major > latest.major or parsed.minor > latest.minor:
        return Supported.NO
    if latest < parsed:
        return Supported.PARTIAL
    return Supported.YES


VersionSupportChecker = Callable[[str], Supported]

_checkers: List[VersionSupportChecker] = [_core_checker]
_checkers_lock = threading.Lock()


def register_version_support_checker(checker: VersionSupportChecker) -> None:
    """Register an additional version checker (reference: NAM/get_dsp.cpp:93-99)."""
    if checker is None:
        raise ValueError("version support checker cannot be None")
    with _checkers_lock:
        _checkers.append(checker)


def is_version_supported(version_str: str) -> Supported:
    # Snapshot under the lock, call outside it, so a checker that re-enters
    # this module cannot deadlock on the non-reentrant lock.
    with _checkers_lock:
        checkers = list(_checkers)
    return max((c(version_str) for c in checkers), default=Supported.NO)


def verify_config_version(version_str: str) -> None:
    """Throw on NO, warn on PARTIAL (reference: NAM/get_dsp.cpp:114-129)."""
    support = is_version_supported(version_str)
    if support == Supported.NO:
        raise VersionError(f"Model config is an unsupported version {version_str}.")
    if support == Supported.PARTIAL:
        print(
            f"Model config is a partially-supported version {version_str}. "
            "Continuing with partial support.",
            file=sys.stderr,
        )
