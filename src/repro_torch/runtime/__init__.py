"""Asynchronous actor-learner runtime (port of ``repro.runtime`` for the
RLVR and classic-RL learners): the versioned ``PolicyStore``, the
staleness-tagged ``TrajectoryQueue`` with its lag controllers, the four
lag regimes (``backward_mixture``, ``forward_n``, ``threaded``,
``threaded_engine``), the env-rollout producers and the phase-locked or
threaded ``ServeRolloutProducer``."""
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
    AsymPOController,
    ControllerContext,
    ControllerSpec,
    GradientAlignmentController,
    StableAsyncController,
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
from repro_torch.runtime.regimes import (REGIMES, BackwardMixtureRegime,
                                         EngineThreadedRegime,
                                         ForwardNRegime,
                                         FrozenRolloutProducer, LagRegime,
                                         MixtureRolloutProducer,
                                         ThreadedRegime, make_regime)
from repro_torch.runtime.serve_producer import ServeRolloutProducer

__all__ = [
    "AdmissionDecision", "AdmissionPolicy", "LagController",
    "MaxLagEviction", "PassThrough", "TokenwiseTVGate", "TVGatedAdmission",
    "AsymPOController", "ControllerContext", "ControllerSpec",
    "GradientAlignmentController", "StableAsyncController",
    "available_controllers",
    "make_controller", "parse_controller_spec", "register_controller",
    "spec_from_legacy", "PolicyStore", "QuarantinedVersionError",
    "SnapshotMeta", "StaleVersionError", "QueueClosed", "TrajectoryItem",
    "TrajectoryQueue", "REGIMES", "BackwardMixtureRegime",
    "EngineThreadedRegime", "ForwardNRegime", "FrozenRolloutProducer",
    "LagRegime", "MixtureRolloutProducer", "ThreadedRegime", "make_regime",
    "ServeRolloutProducer",
]
