# Copied from src/repro/runtime/admission.py; keep the two in step.
"""Lag controllers at the trajectory-queue boundary (§4.2 and beyond).

The paper applies its TV gate per minibatch inside the loss (Alg. 1 /
``core.tv_filter``).  Here the same estimator guards the *queue boundary*:
whole trajectories whose measured TV against the current policy already
exceeds delta/2 are dropped (or downweighted) before they ever reach the
learner — staleness as a queue/controller property rather than a per-loss
afterthought.

The base class is the :class:`LagController` protocol, which spans the
three decision points the related work needs:

* **consume-time admission** (``admit``): drop / downweight / pass a
  whole item before the learner sees it — the paper's Eq. 8 gate and
  plain max-lag eviction live here;
* **per-token loss weighting** (``loss_weights``): scale the advantage
  of individual tokens, optionally against the learner's *current*
  log-probs (``needs_log_pi``) — variance-controlled truncated
  importance correction (Stable Asynchrony) and behavior-free
  asymmetric scaling (ASymPO) live here;
* **gradient / learner-step feedback** (``transform_gradients`` /
  ``on_learner_step``): act on the minibatch gradient itself
  (``needs_gradients``) — gradient-alignment control (GAC) lives here.

Controllers are evaluated at *consume* time, when the learner's
version — and hence the item's true lag — is known.  Every decision
must carry a non-empty ``reason`` (the queue enforces this); reasons
feed the labelled ``queue_admission_total{controller,outcome,reason}``
counters in the metrics registry.

Construction goes through :mod:`repro_torch.runtime.controllers`
(``--controller "tv_gate:delta=0.2,mode=downweight"`` specs); the
string-keyed :func:`make_admission` factory is kept as a deprecation
shim.
"""
from __future__ import annotations

from typing import (
    Any,
    Callable,
    Dict,
    NamedTuple,
    Optional,
    Tuple,
    TYPE_CHECKING,
)

if TYPE_CHECKING:  # pragma: no cover
    import numpy as np

    from repro_torch.runtime.queue import TrajectoryItem


class AdmissionDecision(NamedTuple):
    admit: bool
    weight: float = 1.0          # importance downweight applied if admitted
    tv: Optional[float] = None   # measured TV when the policy computed one
    reason: str = ""             # mandatory; the queue rejects empty reasons


class LagController:
    """Full lag-mitigation protocol: admission + loss + gradient hooks.

    Subclasses override only the decision points they use; the defaults
    are pass-through at every hook, so an admission-only policy is still
    a complete controller.
    """

    name = "base"
    #: ``loss_weights`` wants the learner's current per-token log-probs.
    needs_log_pi = False
    #: ``transform_gradients`` must see (and may rescale) raw gradients,
    #: forcing the trainer onto the split grad/apply update path.
    needs_gradients = False

    # -- consume-time admission ---------------------------------------------

    def admit(self, item: "TrajectoryItem") -> AdmissionDecision:
        return AdmissionDecision(admit=True, reason="admit")

    # -- per-token loss weighting -------------------------------------------

    def loss_weights(
        self,
        item: "TrajectoryItem",
        *,
        advantages: "np.ndarray",       # [B] sequence-level advantages
        log_beta: "np.ndarray",         # [B, S] behavior log-probs
        mask: "np.ndarray",             # [B, S] valid-token mask
        log_pi: Optional["np.ndarray"] = None,  # [B, S] current log-probs
    ) -> Optional["np.ndarray"]:
        """Per-token multiplier [B, S] on the advantage, or None (no-op).

        ``log_pi`` is only provided when ``needs_log_pi`` is True (it
        costs a scoring forward pass).
        """
        return None

    # -- gradient / learner-step feedback -----------------------------------

    def transform_gradients(
        self, item: "TrajectoryItem", grads: Any
    ) -> Tuple[Any, Dict[str, float]]:
        """Rescale/replace the minibatch gradient pytree; returns
        (grads, info) where ``info`` is merged into the step's aux
        metrics.  Only called when ``needs_gradients`` is True."""
        return grads, {}

    def on_learner_step(
        self, item: "TrajectoryItem", aux: Dict[str, Any]
    ) -> None:
        """Observe the completed learner step (aux metrics included)."""


#: Back-compat alias — admission policies *are* (admission-only)
#: lag controllers.
AdmissionPolicy = LagController


class PassThrough(LagController):
    """Admit everything at full weight (the phase-locked baseline)."""

    name = "pass_through"

    def admit(self, item: "TrajectoryItem") -> AdmissionDecision:
        return AdmissionDecision(admit=True, reason="admit")


class MaxLagEviction(LagController):
    """Drop items older (in learner updates) than ``max_lag`` versions.

    Mixture items (backward_mixture regime, mid-swap served
    trajectories) span a *range* of behavior versions; the item's
    ``lag_oldest``/``lag_newest`` give the explicit span.  The gate is:

    * ``lag_newest > max_lag``: even the freshest token is over-age —
      drop (reason ``max_lag``);
    * ``lag_oldest <= max_lag``: everything is in-age — admit at full
      weight;
    * span straddles the cutoff: admit downweighted by the in-age
      fraction (per-snapshot when ``meta["behavior_versions"]`` is
      present, linear in the lag span otherwise; reason
      ``max_lag_span``), so a mostly-fresh mixture is no longer
      dropped for its single oldest snapshot.
    """

    name = "max_lag"
    min_weight = 1e-3

    def __init__(self, max_lag: int) -> None:
        if max_lag < 0:
            raise ValueError(f"max_lag must be >= 0, got {max_lag}")
        self.max_lag = max_lag

    def admit(self, item: "TrajectoryItem") -> AdmissionDecision:
        if item.lag_newest > self.max_lag:
            return AdmissionDecision(admit=False, reason="max_lag")
        if item.lag_oldest <= self.max_lag:
            return AdmissionDecision(admit=True, reason="admit")
        versions = item.meta.get("behavior_versions")
        ref = item.behavior_version + item.lag_oldest
        if versions:
            lags = [ref - int(v) for v in versions]
            frac = sum(1 for l in lags if l <= self.max_lag) / len(lags)
        else:
            span = item.lag_oldest - item.lag_newest + 1
            frac = (self.max_lag - item.lag_newest + 1) / span
        if not frac >= self.min_weight:
            return AdmissionDecision(admit=False, reason="max_lag")
        return AdmissionDecision(
            admit=True, weight=float(frac), reason="max_lag_span")


class TVGatedAdmission(LagController):
    """Gate on the sampled TV estimate (Eq. 8) against the current policy.

    ``tv_fn(payload) -> float`` measures the expected total variation
    between the *current* learner policy and the trajectory's behavior
    policy on the trajectory's own states/actions (the caller closes over
    the policy store and the model apply).  Items with tv <= delta/2 pass
    untouched; over-threshold items are dropped (``mode='drop'``) or
    admitted at weight (delta/2)/tv (``mode='downweight'``).
    """

    name = "tv_gate"

    # Downweighted items below this weight are dropped instead: a
    # near-zero-weight trajectory still costs a full learner step but
    # contributes nothing (tv -> inf gives weight 0 exactly, which
    # would silently train on dead data).
    min_weight = 1e-3

    def __init__(
        self,
        delta: float,
        tv_fn: Callable[[Any], float],
        mode: str = "drop",
    ) -> None:
        if mode not in ("drop", "downweight"):
            raise ValueError(f"mode must be drop|downweight, got {mode!r}")
        self.delta = float(delta)
        self.tv_fn = tv_fn
        self.mode = mode

    def admit(self, item: "TrajectoryItem") -> AdmissionDecision:
        tv = float(self.tv_fn(item.payload))
        threshold = self.delta / 2.0
        if tv <= threshold:
            return AdmissionDecision(admit=True, tv=tv, reason="admit")
        if self.mode == "downweight":
            weight = threshold / tv if tv > 0 else 0.0
            if not weight >= self.min_weight:   # catches 0.0 and nan
                return AdmissionDecision(
                    admit=False, tv=tv, reason="tv_zero_weight")
            return AdmissionDecision(
                admit=True, weight=weight, tv=tv,
                reason="tv_downweight",
            )
        return AdmissionDecision(admit=False, tv=tv, reason="tv_gate")


class TokenwiseTVGate(LagController):
    """Eq. 8 applied per *version segment* of a served trajectory.

    The continuous-batching serve engine swaps weights in-flight, so a
    single trajectory can straddle several behavior policies; its
    payload carries per-token policy versions.  Whole-trajectory gating
    averages the TV estimate over all tokens — a long fresh prefix can
    mask a badly stale tail (and vice versa).  This policy segments the
    trajectory at version boundaries, applies the paper's gate to each
    segment's own TV estimate, and admits at the token-weighted mean of
    the per-segment weights (1 for in-trust segments, (delta/2)/tv_s
    downweighted or 0 dropped for the rest).

    ``token_tv_fn(payload) -> (tv_tokens, versions)``: per-token sampled
    TV terms 0.5*|ratio_t - 1| against the current policy, and the
    per-token behavior versions (both [N]); the caller closes over the
    policy store and model apply exactly as for ``tv_gate``.  Per-segment
    decisions land in ``item.meta["tv_segments"]`` for metrics.
    """

    name = "tv_gate_tokenwise"
    min_weight = TVGatedAdmission.min_weight

    def __init__(
        self,
        delta: float,
        token_tv_fn: Callable[[Any], Any],
        mode: str = "downweight",
    ) -> None:
        if mode not in ("drop", "downweight"):
            raise ValueError(f"mode must be drop|downweight, got {mode!r}")
        self.delta = float(delta)
        self.token_tv_fn = token_tv_fn
        self.mode = mode

    def admit(self, item: "TrajectoryItem") -> AdmissionDecision:
        import numpy as np

        tv_tokens, versions = self.token_tv_fn(item.payload)
        tv_tokens = np.asarray(tv_tokens, np.float64).reshape(-1)
        versions = np.asarray(versions).reshape(-1)
        n = tv_tokens.shape[0]
        if versions.shape[0] != n:
            raise ValueError(
                f"tv/versions length mismatch: {n} vs {versions.shape[0]}")
        if n == 0:
            return AdmissionDecision(admit=True, tv=0.0, reason="admit")
        threshold = self.delta / 2.0
        # Segment boundaries where the producing policy version changes.
        cuts = [0] + (
            1 + np.flatnonzero(versions[1:] != versions[:-1])
        ).tolist() + [n]
        segments = []
        weighted_tv = 0.0
        weighted_w = 0.0
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            tv_s = float(tv_tokens[lo:hi].mean())     # Eq. 8 per segment
            if tv_s <= threshold:
                w_s = 1.0
            elif self.mode == "downweight" and tv_s > 0:
                w_s = threshold / tv_s
            else:
                w_s = 0.0
            segments.append(
                {"version": int(versions[lo]), "tokens": hi - lo,
                 "tv": tv_s, "weight": w_s})
            weighted_tv += (hi - lo) * tv_s
            weighted_w += (hi - lo) * w_s
        tv = weighted_tv / n
        weight = weighted_w / n
        item.meta["tv_segments"] = segments
        if not weight >= self.min_weight:
            return AdmissionDecision(
                admit=False, tv=tv, reason="tv_gate_tokenwise")
        reason = "tv_tokenwise_downweight" if weight < 1.0 else "admit"
        return AdmissionDecision(
            admit=True, weight=weight, tv=tv, reason=reason)


def make_admission(
    name: str,
    *,
    max_lag: int = 4,
    delta: float = 0.2,
    tv_fn: Optional[Callable[[Any], float]] = None,
    mode: str = "drop",
) -> LagController:
    """Deprecated string-keyed factory (the legacy ``--admission`` path).

    Thin shim over :func:`repro_torch.runtime.controllers.make_controller`;
    new call sites should build a :class:`ControllerSpec` instead.
    """
    import warnings

    from repro_torch.runtime.controllers import make_controller, spec_from_legacy

    warnings.warn(
        "make_admission() is deprecated; use "
        "repro_torch.runtime.controllers.make_controller(parse_controller_spec"
        "(...)) — e.g. --controller 'tv_gate:delta=0.2,mode=downweight'",
        DeprecationWarning, stacklevel=2)
    spec = spec_from_legacy(name, max_lag=max_lag, delta=delta, mode=mode)
    return make_controller(spec, tv_fn=tv_fn, token_tv_fn=tv_fn)
