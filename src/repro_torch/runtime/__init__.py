"""Asynchronous actor-learner runtime (port of ``repro.runtime`` for the
forward-lag RLVR learner): the versioned ``PolicyStore``, the
staleness-tagged ``TrajectoryQueue`` with its lag controllers, and the
``forward_n`` regime."""
from repro_torch.runtime.admission import (
    AdmissionDecision,
    AdmissionPolicy,
    LagController,
    MaxLagEviction,
    PassThrough,
    TokenwiseTVGate,
    TVGatedAdmission,
)
from repro_torch.runtime.controllers import (
    ControllerContext,
    ControllerSpec,
    available_controllers,
    make_controller,
    parse_controller_spec,
    register_controller,
    spec_from_legacy,
)
from repro_torch.runtime.policy_store import (
    PolicyStore,
    QuarantinedVersionError,
    SnapshotMeta,
    StaleVersionError,
)
from repro_torch.runtime.queue import (QueueClosed, TrajectoryItem,
                                       TrajectoryQueue)
from repro_torch.runtime.regimes import (REGIMES, ForwardNRegime, LagRegime,
                                         make_regime)

__all__ = [
    "AdmissionDecision", "AdmissionPolicy", "LagController",
    "MaxLagEviction", "PassThrough", "TokenwiseTVGate", "TVGatedAdmission",
    "ControllerContext", "ControllerSpec", "available_controllers",
    "make_controller", "parse_controller_spec", "register_controller",
    "spec_from_legacy", "PolicyStore", "QuarantinedVersionError",
    "SnapshotMeta", "StaleVersionError", "QueueClosed", "TrajectoryItem",
    "TrajectoryQueue", "REGIMES", "ForwardNRegime", "LagRegime",
    "make_regime",
]
