# Copied in part from src/repro/runtime/controllers.py; keep the two in step.
"""Controller specs, the controller registry, and the lag-controller zoo.

One grammar everywhere (``launch.train``, ``launch.serve``,
``bench_runtime``)::

    --controller "name"
    --controller "name:key=val,key=val"

e.g. ``tv_gate:delta=0.2,mode=downweight``.  Values parse as int, float,
bool (``true``/``false``) or string; unknown controller names and
unknown option keys are hard errors (the old string-keyed factory
silently ignored stray kwargs).

Registered controllers:

=================  =====================================================
``pass_through``   admit everything (phase-locked baseline)
``max_lag``        span-aware version-age eviction
``tv_gate``        the paper's Eq. 8 trust-region gate (drop/downweight)
``tv_gate_tokenwise``  Eq. 8 per version segment of a served trajectory
``gac``            gradient cosine-alignment clip vs a fresh-anchor EMA
``stable_async``   variance-controlled truncated importance correction
``asympo``         behavior-free asymmetric advantage scaling
=================  =====================================================

The last three are registered so that their specs parse, but building
one raises: they are not ported to the PyTorch runtime yet.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional, Tuple, Union

from repro_torch.runtime.admission import (
    LagController,
    MaxLagEviction,
    PassThrough,
    TokenwiseTVGate,
    TVGatedAdmission,
)

__all__ = [
    "ControllerContext",
    "ControllerSpec",
    "available_controllers",
    "make_controller",
    "parse_controller_spec",
    "register_controller",
    "spec_from_legacy",
]


# --------------------------------------------------------------------------
# Spec grammar
# --------------------------------------------------------------------------


def _parse_value(text: str) -> Any:
    low = text.strip().lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            continue
    return text


@dataclasses.dataclass(frozen=True)
class ControllerSpec:
    """A parsed ``name:key=val,...`` controller spec (hashable)."""

    name: str
    opts: Tuple[Tuple[str, Any], ...] = ()

    @property
    def options(self) -> Dict[str, Any]:
        return dict(self.opts)

    def canonical(self) -> str:
        if not self.opts:
            return self.name
        body = ",".join(f"{k}={v}" for k, v in self.opts)
        return f"{self.name}:{body}"

    def __str__(self) -> str:  # pragma: no cover - convenience
        return self.canonical()


def parse_controller_spec(text: Union[str, ControllerSpec]) -> ControllerSpec:
    """``"tv_gate:delta=0.2,mode=downweight"`` -> :class:`ControllerSpec`."""
    if isinstance(text, ControllerSpec):
        return text
    text = text.strip()
    if not text:
        raise ValueError("empty controller spec")
    name, _, body = text.partition(":")
    name = name.strip()
    if name not in CONTROLLER_REGISTRY:
        raise ValueError(
            f"unknown controller {name!r}; available: "
            f"{', '.join(sorted(CONTROLLER_REGISTRY))}")
    opts = []
    if body.strip():
        for chunk in body.split(","):
            key, eq, val = chunk.partition("=")
            key = key.strip()
            if not key or not eq:
                raise ValueError(
                    f"bad controller option {chunk!r} in {text!r} "
                    "(expected key=value)")
            opts.append((key, _parse_value(val)))
    return ControllerSpec(name=name, opts=tuple(opts))


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ControllerContext:
    """Host-side capabilities a builder may need (closed over the
    policy store / model apply by the caller)."""

    tv_fn: Optional[Callable[[Any], float]] = None
    token_tv_fn: Optional[Callable[[Any], Any]] = None


@dataclasses.dataclass(frozen=True)
class ControllerInfo:
    name: str
    builder: Callable[[Dict[str, Any], ControllerContext], LagController]
    description: str
    paper: str = ""


CONTROLLER_REGISTRY: Dict[str, ControllerInfo] = {}


def register_controller(
    name: str, *, description: str, paper: str = ""
) -> Callable:
    def deco(builder: Callable) -> Callable:
        CONTROLLER_REGISTRY[name] = ControllerInfo(
            name=name, builder=builder, description=description, paper=paper)
        return builder
    return deco


def available_controllers() -> Dict[str, ControllerInfo]:
    return dict(CONTROLLER_REGISTRY)


def _take(options: Dict[str, Any], name: str, **defaults: Any) -> Dict[str, Any]:
    """Merge spec options over defaults; unknown keys are hard errors."""
    unknown = set(options) - set(defaults)
    if unknown:
        raise ValueError(
            f"unknown option(s) {sorted(unknown)} for controller "
            f"{name!r}; accepted: {sorted(defaults)}")
    out = dict(defaults)
    out.update(options)
    return out


def make_controller(
    spec: Union[str, ControllerSpec],
    *,
    tv_fn: Optional[Callable[[Any], float]] = None,
    token_tv_fn: Optional[Callable[[Any], Any]] = None,
) -> LagController:
    """Build a :class:`LagController` from a spec (string or parsed)."""
    spec = parse_controller_spec(spec)
    ctx = ControllerContext(tv_fn=tv_fn, token_tv_fn=token_tv_fn)
    return CONTROLLER_REGISTRY[spec.name].builder(spec.options, ctx)


_LEGACY_NAMES = ("pass_through", "max_lag", "tv_gate", "tv_gate_tokenwise")


def spec_from_legacy(
    name: str,
    *,
    max_lag: int = 4,
    delta: float = 0.2,
    mode: str = "drop",
    warn: bool = False,
) -> ControllerSpec:
    """Map the legacy ``--admission``/``--max-lag``/``--admission-mode``
    flag triple onto a :class:`ControllerSpec` (the deprecation shim)."""
    if name not in _LEGACY_NAMES:
        raise ValueError(f"unknown admission policy {name!r}")
    if name == "pass_through":
        spec = ControllerSpec("pass_through")
    elif name == "max_lag":
        spec = ControllerSpec("max_lag", (("max_lag", int(max_lag)),))
    else:
        spec = ControllerSpec(
            name, (("delta", float(delta)), ("mode", str(mode))))
    if warn:
        warnings.warn(
            f"--admission {name!r} is deprecated; use "
            f"--controller {spec.canonical()!r}",
            DeprecationWarning, stacklevel=2)
    return spec


# --------------------------------------------------------------------------
# Builders for the existing admission-only controllers
# --------------------------------------------------------------------------


@register_controller(
    "pass_through",
    description="admit everything at full weight (phase-locked baseline)")
def _build_pass_through(options, ctx):
    _take(options, "pass_through")
    return PassThrough()


@register_controller(
    "max_lag",
    description="span-aware version-age eviction (drop > max_lag, "
                "fractional weight on straddling mixtures)")
def _build_max_lag(options, ctx):
    o = _take(options, "max_lag", max_lag=4)
    return MaxLagEviction(int(o["max_lag"]))


@register_controller(
    "tv_gate",
    description="Eq. 8 trust-region gate on the sampled TV estimate",
    paper="Align and Filter (this repo's source paper)")
def _build_tv_gate(options, ctx):
    o = _take(options, "tv_gate", delta=0.2, mode="drop")
    if ctx.tv_fn is None:
        raise ValueError("tv_gate admission requires a tv_fn")
    return TVGatedAdmission(float(o["delta"]), ctx.tv_fn, mode=o["mode"])


@register_controller(
    "tv_gate_tokenwise",
    description="Eq. 8 applied per version segment of a served trajectory",
    paper="Align and Filter (this repo's source paper)")
def _build_tv_gate_tokenwise(options, ctx):
    o = _take(options, "tv_gate_tokenwise", delta=0.2, mode="downweight")
    fn = ctx.token_tv_fn or ctx.tv_fn
    if fn is None:
        raise ValueError(
            "tv_gate_tokenwise admission requires a tv_fn returning "
            "(tv_tokens, versions)")
    return TokenwiseTVGate(float(o["delta"]), fn, mode=o["mode"])


# --------------------------------------------------------------------------
# Not ported yet: GAC, Stable Asynchrony, ASymPO
# --------------------------------------------------------------------------


def _not_ported(name: str) -> Callable:
    def build(options, ctx):
        raise NotImplementedError(
            f"controller {name!r} is not ported to the PyTorch runtime yet; "
            "use the repro package for it")
    return build


for _name, _description in (
        ("gac", "cosine-alignment clip of stale gradients vs a "
                "fresh-anchor gradient EMA"),
        ("stable_async", "variance-controlled truncated importance "
                         "correction from log_beta vs current log-probs"),
        ("asympo", "behavior-free asymmetric advantage scaling (positive "
                   "side decays with lag)")):
    register_controller(_name, description=_description)(_not_ported(_name))
