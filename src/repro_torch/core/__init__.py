"""The Spot-on checkpoint coordinator, spot-instance simulation, multi-cloud
provider backends, pricing, the fleet coordinator over one shared store and
elastic re-planning onto a ``DeviceMesh`` (PyTorch port)."""

from .clock import Clock, VirtualClock, WallClock
from .coordinator import (CoordinatorStats, Signal, SpotOnCoordinator,
                          StragglerDetector)
from .cost import (AWS_M5_2XLARGE, AZURE_D8S_V3, GCP_N2_STANDARD_8,
                   TPU_V5E_CHIP, CostAccountant, PriceSheet)
from .events import (DEFAULT_NOTICE_S, PREEMPT, ScheduledEvent,
                     SimulatedMetadataService, first_preempt)
from .fleet import FleetCoordinator, FleetReport, FleetSpec
from .ledger import TimeLedger, TimeModel
from .policy import CheckpointPolicy, Mode
from .providers import (AwsProvider, AzureProvider, CloudProvider, GcpProvider,
                        PreemptNotice, PROVIDERS, get_provider)
from .spot_sim import (AutoScalingGroup, EvictionSchedule, InstancePool,
                       ManagedInstanceGroup, NoEviction, PeriodicEviction,
                       PoissonEviction, ScaleSet, SpotInstance, TraceEviction)

__all__ = [
    "AWS_M5_2XLARGE", "AZURE_D8S_V3", "AutoScalingGroup", "AwsProvider",
    "AzureProvider", "Clock", "CheckpointPolicy", "CloudProvider",
    "CoordinatorStats", "CostAccountant", "DEFAULT_NOTICE_S",
    "EvictionSchedule", "FleetCoordinator", "FleetReport", "FleetSpec",
    "GCP_N2_STANDARD_8", "GcpProvider", "InstancePool",
    "ManagedInstanceGroup", "Mode", "NoEviction", "PREEMPT", "PROVIDERS",
    "PeriodicEviction", "PoissonEviction", "PreemptNotice", "PriceSheet",
    "ScaleSet", "ScheduledEvent", "Signal", "SimulatedMetadataService",
    "SpotInstance", "SpotOnCoordinator", "StragglerDetector", "TPU_V5E_CHIP",
    "TimeLedger", "TimeModel", "TraceEviction", "VirtualClock", "WallClock",
    "first_preempt", "get_provider",
]
