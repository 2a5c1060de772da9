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

The last three implement the PAPERS.md related work and exercise the
:class:`~repro_torch.runtime.admission.LagController` hooks beyond admission:
``gac`` needs raw gradients, ``stable_async`` needs the learner's
current log-probs, ``asympo`` needs neither (usable when the producer
cannot report log_beta at all).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.runtime.admission import (
    LagController,
    MaxLagEviction,
    PassThrough,
    TokenwiseTVGate,
    TVGatedAdmission,
)
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = [
    "AsymPOController",
    "ControllerContext",
    "ControllerSpec",
    "GradientAlignmentController",
    "StableAsyncController",
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
# GAC: gradient cosine-alignment clip
# --------------------------------------------------------------------------


def _tree_dot_norms(a, b) -> Tuple[float, float, float]:
    """(a·b, ||a||, ||b||) over two trees of one structure: float32
    sums on the trees' device, one host sync for the three."""
    la, lb = tree_leaves(a), tree_leaves(b)
    flat = lambda x: x.reshape(-1).float()
    dot = torch.stack([torch.dot(flat(x), flat(y))
                       for x, y in zip(la, lb)]).sum()
    na = torch.sqrt(torch.stack([torch.dot(flat(x), flat(x))
                                 for x in la]).sum())
    nb = torch.sqrt(torch.stack([torch.dot(flat(y), flat(y))
                                 for y in lb]).sum())
    dot, na, nb = torch.stack([dot, na, nb]).tolist()
    return dot, na, nb


class GradientAlignmentController(LagController):
    """GAC: clip stale-minibatch gradients by cosine alignment with a
    fresh-anchor gradient EMA.

    Fresh minibatches (``lag <= fresh_lag``) update the anchor and pass
    through untouched.  A stale minibatch's gradient is compared to the
    anchor: cosine >= ``cos_min`` passes at full scale (and refreshes
    the anchor — an aligned stale gradient is information about the
    current objective too); below that the gradient is linearly scaled
    down to ``min_scale`` at cosine 0 and clipped to ``min_scale`` for
    negative cosines, so a stale update can reduce to (near) a no-op but
    never actively fights the fresh descent direction.

    The anchor is a tree of tensors on the gradients' device, a copy
    (never an alias of a gradient the update goes on to use).
    """

    name = "gac"
    needs_gradients = True

    def __init__(
        self,
        cos_min: float = 0.25,
        fresh_lag: int = 0,
        ema: float = 0.9,
        min_scale: float = 0.0,
    ) -> None:
        if not 0.0 <= ema < 1.0:
            raise ValueError(f"ema must be in [0, 1), got {ema}")
        self.cos_min = float(cos_min)
        self.fresh_lag = int(fresh_lag)
        self.ema = float(ema)
        self.min_scale = float(min_scale)
        self._anchor = None

    def _cosine(self, grads) -> float:
        dot, na, nb = _tree_dot_norms(grads, self._anchor)
        denom = na * nb
        return dot / denom if denom > 0 else 0.0

    def _update_anchor(self, grads) -> None:
        if self._anchor is None:
            self._anchor = tree_map(torch.clone, grads)
        else:
            e = self.ema
            self._anchor = tree_map(
                lambda a, g: e * a + (1.0 - e) * g, self._anchor, grads)

    def transform_gradients(self, item, grads):
        if self._anchor is None or item.lag <= self.fresh_lag:
            self._update_anchor(grads)
            return grads, {"gac_cos": 1.0, "gac_scale": 1.0}
        cos = self._cosine(grads)
        if cos >= self.cos_min:
            scale = 1.0
            self._update_anchor(grads)
        elif cos <= 0.0 or self.cos_min <= 0.0:
            scale = self.min_scale
        else:
            scale = self.min_scale + (1.0 - self.min_scale) * (
                cos / self.cos_min)
        if scale != 1.0:
            grads = tree_map(lambda g: g * scale, grads)
        return grads, {"gac_cos": float(cos), "gac_scale": float(scale)}


@register_controller(
    "gac",
    description="cosine-alignment clip of stale gradients vs a "
                "fresh-anchor gradient EMA",
    paper="Gradient-Alignment Control for asynchronous RL (GAC)")
def _build_gac(options, ctx):
    o = _take(options, "gac", cos_min=0.25, fresh_lag=0, ema=0.9,
              min_scale=0.0)
    return GradientAlignmentController(
        cos_min=float(o["cos_min"]), fresh_lag=int(o["fresh_lag"]),
        ema=float(o["ema"]), min_scale=float(o["min_scale"]))


# --------------------------------------------------------------------------
# Stable Asynchrony: variance-controlled truncated importance correction
# --------------------------------------------------------------------------


class StableAsyncController(LagController):
    """Per-token truncated importance weights ``min(pi/beta, c)`` with
    the truncation level ``c`` chosen per minibatch so the weight
    variance stays under ``var_max``.

    The variance of the truncated weights is monotone in ``c``, so the
    largest admissible ``c`` in ``[c_min, c_max]`` — least truncation,
    least bias — is found by bisection.  On-policy data has ratio ~1
    and passes essentially unweighted; the controller only bites when
    lag has moved the current policy away from the recorded ``log_beta``
    (which is why it declares ``needs_log_pi``).
    """

    name = "stable_async"
    needs_log_pi = True

    def __init__(
        self,
        c_max: float = 2.0,
        c_min: float = 1.0,
        var_max: float = 0.5,
        iters: int = 25,
    ) -> None:
        if c_min <= 0 or c_max < c_min:
            raise ValueError(
                f"need 0 < c_min <= c_max, got {c_min}, {c_max}")
        self.c_max = float(c_max)
        self.c_min = float(c_min)
        self.var_max = float(var_max)
        self.iters = int(iters)

    def loss_weights(self, item, *, advantages, log_beta, mask,
                     log_pi=None):
        if log_pi is None:
            raise ValueError(
                "stable_async requires current log-probs (needs_log_pi)")
        rho = np.exp(np.clip(
            np.asarray(log_pi, np.float64) - np.asarray(log_beta,
                                                        np.float64),
            -20.0, 20.0))
        valid = np.asarray(mask) > 0
        if not valid.any():
            return None

        def var_at(c: float) -> float:
            return float(np.minimum(rho, c)[valid].var())

        if var_at(self.c_max) <= self.var_max:
            c = self.c_max
        elif var_at(self.c_min) > self.var_max:
            c = self.c_min
        else:
            lo, hi = self.c_min, self.c_max
            for _ in range(self.iters):
                mid = 0.5 * (lo + hi)
                if var_at(mid) <= self.var_max:
                    lo = mid
                else:
                    hi = mid
            c = lo
        w = np.minimum(rho, c)
        item.meta["stable_async"] = {
            "c": float(c), "var": var_at(c),
            "mean_weight": float(w[valid].mean()),
        }
        return np.where(valid, w, 1.0).astype(np.float32)


@register_controller(
    "stable_async",
    description="variance-controlled truncated importance correction "
                "from log_beta vs current log-probs",
    paper="Stable Asynchronous RL (variance-controlled off-policy "
          "correction)")
def _build_stable_async(options, ctx):
    o = _take(options, "stable_async", c_max=2.0, c_min=1.0, var_max=0.5)
    return StableAsyncController(
        c_max=float(o["c_max"]), c_min=float(o["c_min"]),
        var_max=float(o["var_max"]))


# --------------------------------------------------------------------------
# ASymPO: behavior-free asymmetric advantage scaling
# --------------------------------------------------------------------------


class AsymPOController(LagController):
    """Asymmetric advantage scaling that needs *no* behavior log-probs.

    Stale positive advantages are the dangerous direction — they keep
    reinforcing actions the current policy may no longer prefer — so
    the positive side decays geometrically with lag
    (``pos_scale * pos_decay**lag``) while the negative (conservative,
    probability-lowering) side keeps a fixed ``neg_scale``.  Because
    only the item's lag and the advantage sign are consulted, this
    controller works when the producer cannot report ``log_beta`` at
    all (e.g. a fleet of inference hosts with approximate sampling).
    """

    name = "asympo"

    def __init__(
        self,
        pos_scale: float = 1.0,
        neg_scale: float = 1.0,
        pos_decay: float = 0.9,
    ) -> None:
        if not 0.0 < pos_decay <= 1.0:
            raise ValueError(f"pos_decay must be in (0, 1], got {pos_decay}")
        self.pos_scale = float(pos_scale)
        self.neg_scale = float(neg_scale)
        self.pos_decay = float(pos_decay)

    def loss_weights(self, item, *, advantages, log_beta, mask,
                     log_pi=None):
        lag = max(int(item.lag), 0)
        w_pos = self.pos_scale * (self.pos_decay ** lag)
        adv = np.asarray(advantages, np.float64).reshape(-1)
        w_seq = np.where(adv > 0.0, w_pos, self.neg_scale)
        item.meta["asympo"] = {
            "w_pos": float(w_pos), "w_neg": self.neg_scale, "lag": lag}
        n_tok = np.asarray(mask).shape[1]
        return np.repeat(
            w_seq[:, None].astype(np.float32), n_tok, axis=1)


@register_controller(
    "asympo",
    description="behavior-free asymmetric advantage scaling (positive "
                "side decays with lag)",
    paper="ASymPO: asymmetric-scale policy optimization without "
          "behavior log-probs")
def _build_asympo(options, ctx):
    o = _take(options, "asympo", pos_scale=1.0, neg_scale=1.0,
              pos_decay=0.9)
    return AsymPOController(
        pos_scale=float(o["pos_scale"]), neg_scale=float(o["neg_scale"]),
        pos_decay=float(o["pos_decay"]))
