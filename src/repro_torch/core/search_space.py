"""Hyperparameter search-space definition and encoding (paper §4.1, §5.1).

The paper's input configuration layer:
  * HPs are continuous (real), integer, or categorical.
  * Numerical HPs carry [low, high] bounds; optionally *log scaling* (§5.1),
    in which case the internal representation is uniform in log10 domain.
  * Integer HPs are optimized in the continuous relaxation and rounded.
  * Categorical HPs are one-hot encoded.

The encoded space is the unit hypercube [0, 1]^D (D >= d once categoricals are
expanded); the GP operates on the encoded space, while user-facing values flow
through ``to_unit`` / ``from_unit``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np

__all__ = [
    "Continuous",
    "Integer",
    "Categorical",
    "SearchSpace",
    "ScalingType",
]


class ScalingType:
    LINEAR = "linear"
    LOG = "log"
    REVERSE_LOG = "reverse_log"  # for HPs in (0,1) concentrated near 1 (e.g. beta2)


def _check_bounds(name: str, low: float, high: float, scaling: str) -> None:
    if not low < high:
        raise ValueError(f"{name}: low must be < high, got [{low}, {high}]")
    if scaling == ScalingType.LOG and low <= 0:
        raise ValueError(
            f"{name}: log scaling requires low > 0, got {low}. "
            "(Lesson from the paper, §6.2: linear-scaled parents may contain 0, "
            "which is invalid under log scaling in a warm-started child job.)"
        )
    if scaling == ScalingType.REVERSE_LOG and high >= 1:
        raise ValueError(f"{name}: reverse-log scaling requires high < 1")


@dataclasses.dataclass(frozen=True)
class Continuous:
    """A real-valued hyperparameter with bounds and optional log scaling."""

    name: str
    low: float
    high: float
    scaling: str = ScalingType.LINEAR

    def __post_init__(self) -> None:
        _check_bounds(self.name, self.low, self.high, self.scaling)

    # --- scalar transforms -------------------------------------------------
    def to_unit(self, value: float) -> float:
        v = float(value)
        if self.scaling == ScalingType.LOG:
            u = (math.log(v) - math.log(self.low)) / (
                math.log(self.high) - math.log(self.low)
            )
        elif self.scaling == ScalingType.REVERSE_LOG:
            # map via log(1 - v): emphasises resolution near ``high``.
            u = (math.log1p(-v) - math.log1p(-self.low)) / (
                math.log1p(-self.high) - math.log1p(-self.low)
            )
        else:
            u = (v - self.low) / (self.high - self.low)
        return min(1.0, max(0.0, u))

    def from_unit(self, u: float) -> float:
        u = min(1.0, max(0.0, float(u)))
        if self.scaling == ScalingType.LOG:
            lo, hi = math.log(self.low), math.log(self.high)
            return float(math.exp(lo + u * (hi - lo)))
        if self.scaling == ScalingType.REVERSE_LOG:
            lo, hi = math.log1p(-self.low), math.log1p(-self.high)
            return float(1.0 - math.exp(lo + u * (hi - lo)))
        return float(self.low + u * (self.high - self.low))

    @property
    def encoded_width(self) -> int:
        return 1


@dataclasses.dataclass(frozen=True)
class Integer:
    """An integer hyperparameter, handled in the continuous relaxation.

    Paper §4.1: "Integer HPs are handled by working in the continuous space and
    rounding to the nearest integer."
    """

    name: str
    low: int
    high: int
    scaling: str = ScalingType.LINEAR

    def __post_init__(self) -> None:
        _check_bounds(self.name, float(self.low), float(self.high), self.scaling)

    def to_unit(self, value: int) -> float:
        v = float(value)
        if self.scaling == ScalingType.LOG:
            u = (math.log(v) - math.log(self.low)) / (
                math.log(self.high) - math.log(self.low)
            )
        else:
            u = (v - self.low) / (self.high - self.low)
        return min(1.0, max(0.0, u))

    def from_unit(self, u: float) -> int:
        u = min(1.0, max(0.0, float(u)))
        if self.scaling == ScalingType.LOG:
            lo, hi = math.log(self.low), math.log(self.high)
            raw = math.exp(lo + u * (hi - lo))
        else:
            raw = self.low + u * (self.high - self.low)
        return int(min(self.high, max(self.low, round(raw))))

    @property
    def encoded_width(self) -> int:
        return 1


@dataclasses.dataclass(frozen=True)
class Categorical:
    """A categorical hyperparameter; one-hot encoded (paper §4.1)."""

    name: str
    choices: Tuple[Any, ...]

    def __init__(self, name: str, choices: Sequence[Any]):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "choices", tuple(choices))
        if len(self.choices) < 2:
            raise ValueError(f"{name}: need >= 2 choices")
        if len(set(map(repr, self.choices))) != len(self.choices):
            raise ValueError(f"{name}: duplicate choices")

    def to_unit(self, value: Any) -> np.ndarray:
        onehot = np.zeros(len(self.choices), dtype=np.float64)
        onehot[self.choices.index(value)] = 1.0
        return onehot

    def from_unit(self, u: np.ndarray) -> Any:
        return self.choices[int(np.argmax(np.asarray(u)))]

    @property
    def encoded_width(self) -> int:
        return len(self.choices)


Parameter = Any  # Continuous | Integer | Categorical


class SearchSpace:
    """An ordered collection of hyperparameters with vector encode/decode.

    Encoded representation: ``float64[encoded_dim]`` in the unit hypercube.
    Continuous/Integer take one dimension each (after scaling), Categorical
    takes ``len(choices)`` one-hot dimensions.
    """

    def __init__(self, parameters: Sequence[Parameter]):
        if not parameters:
            raise ValueError("SearchSpace needs at least one parameter")
        names = [p.name for p in parameters]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate parameter names: {names}")
        self.parameters: Tuple[Parameter, ...] = tuple(parameters)
        self._by_name: Dict[str, Parameter] = {p.name: p for p in self.parameters}
        offsets = []
        off = 0
        for p in self.parameters:
            offsets.append(off)
            off += p.encoded_width
        self._offsets = tuple(offsets)
        self.encoded_dim: int = off

    # ------------------------------------------------------------------ api
    def __len__(self) -> int:
        return len(self.parameters)

    def __getitem__(self, name: str) -> Parameter:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.parameters)

    def encode(self, config: Mapping[str, Any]) -> np.ndarray:
        """Dict of HP values -> unit-hypercube vector."""
        vec = np.zeros(self.encoded_dim, dtype=np.float64)
        for p, off in zip(self.parameters, self._offsets):
            if p.name not in config:
                raise KeyError(f"missing hyperparameter {p.name!r}")
            enc = p.to_unit(config[p.name])
            if isinstance(p, Categorical):
                vec[off : off + p.encoded_width] = enc
            else:
                vec[off] = enc
        return vec

    def decode(self, vec: np.ndarray) -> Dict[str, Any]:
        """Unit-hypercube vector -> dict of HP values (rounding ints, argmax cats)."""
        vec = np.asarray(vec, dtype=np.float64)
        if vec.shape != (self.encoded_dim,):
            raise ValueError(f"expected shape ({self.encoded_dim},), got {vec.shape}")
        out: Dict[str, Any] = {}
        for p, off in zip(self.parameters, self._offsets):
            if isinstance(p, Categorical):
                out[p.name] = p.from_unit(vec[off : off + p.encoded_width])
            else:
                out[p.name] = p.from_unit(vec[off])
        return out

    def encode_batch(self, configs: Sequence[Mapping[str, Any]]) -> np.ndarray:
        return np.stack([self.encode(c) for c in configs], axis=0) if configs else np.zeros(
            (0, self.encoded_dim)
        )

    def sample(self, rng: np.random.Generator, n: int = 1) -> List[Dict[str, Any]]:
        """Uniform random configurations (random search §2.1; respects scaling).

        Sampling is uniform *in the encoded space*, which makes random search
        log-uniform for log-scaled HPs — exactly the paper's semantics (§5.1:
        "unlike input warping, [log scaling] can be used not only with BO but
        also with random search").
        """
        vecs = rng.random((n, self.encoded_dim))
        return [self.decode(v) for v in vecs]

    def clip(self, vec: np.ndarray) -> np.ndarray:
        return np.clip(np.asarray(vec, dtype=np.float64), 0.0, 1.0)

    def round_trip(self, vec: np.ndarray) -> np.ndarray:
        """Project an encoded vector onto representable configs (round ints,
        snap one-hots). Used so the GP sees what will actually be evaluated."""
        return self.encode(self.decode(self.clip(vec)))

    # Structural info used by the GP --------------------------------------
    def warpable_dims(self) -> np.ndarray:
        """Boolean mask over encoded dims: True where Kumaraswamy input warping
        applies (numerical dims only — warping one-hot dims is meaningless)."""
        mask = np.zeros(self.encoded_dim, dtype=bool)
        for p, off in zip(self.parameters, self._offsets):
            if not isinstance(p, Categorical):
                mask[off] = True
        return mask

    # Wire representation (cross-process service) -------------------------
    def to_spec(self) -> List[Dict[str, Any]]:
        """JSON-safe structural description of this space — what a tuning job
        sends to a remote decision-engine replica at registration
        (``repro_torch.core.rpc.RegisterRequest.space_spec``). Round-trips through
        ``SearchSpace.from_spec`` to a space with an identical
        ``space_signature`` (and therefore identical encoding)."""
        spec: List[Dict[str, Any]] = []
        for p in self.parameters:
            if isinstance(p, Categorical):
                spec.append(
                    {"kind": "categorical", "name": p.name,
                     "choices": list(p.choices)}
                )
            else:
                spec.append(
                    {
                        "kind": "int" if isinstance(p, Integer) else "float",
                        "name": p.name,
                        "low": p.low,
                        "high": p.high,
                        "scaling": p.scaling,
                    }
                )
        return spec

    @classmethod
    def from_spec(cls, spec: Sequence[Mapping[str, Any]]) -> "SearchSpace":
        """Reconstruct a space from ``to_spec`` output (see there)."""
        params: List[Parameter] = []
        for s in spec:
            kind = s["kind"]
            if kind == "categorical":
                params.append(Categorical(s["name"], s["choices"]))
            elif kind == "int":
                params.append(
                    Integer(s["name"], int(s["low"]), int(s["high"]),
                            scaling=s.get("scaling", ScalingType.LINEAR))
                )
            elif kind == "float":
                params.append(
                    Continuous(s["name"], float(s["low"]), float(s["high"]),
                               scaling=s.get("scaling", ScalingType.LINEAR))
                )
            else:
                raise ValueError(f"unknown parameter kind {kind!r}")
        return cls(params)

    def describe(self) -> str:
        rows = []
        for p in self.parameters:
            if isinstance(p, Categorical):
                rows.append(f"  {p.name}: categorical{list(p.choices)}")
            else:
                kind = "int" if isinstance(p, Integer) else "float"
                rows.append(
                    f"  {p.name}: {kind}[{p.low}, {p.high}] scaling={p.scaling}"
                )
        return "SearchSpace(\n" + "\n".join(rows) + "\n)"

    __repr__ = describe
