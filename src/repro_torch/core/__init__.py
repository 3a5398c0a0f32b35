"""TAPAS core (port of ``repro.core``): thermal- and power-aware scheduling
for LLM inference.

The paper's primary contribution — placement (allocator), routing (router),
instance configuration (configurator) over the §2 thermal/power models —
behind the typed ``ClusterState``/``ControlPolicy`` control-plane API,
plus the step-wise discrete-time cluster simulator, scenario scripting,
fault injection and failure drills used by §5.  The physics runs as
float32 torch tensors on the simulator's device.  Not ported yet: the
fleet simulator (``core.fleet``) and the oversubscription planner
(``core.oversubscribe``).
"""
from repro_torch.core.allocator import (AllocatorState, BaselineAllocator,
                                        PlacementPolicy, TapasAllocator)
from repro_torch.core.configurator import (InstanceConfigurator,
                                           ReconfigurePolicy)
from repro_torch.core.datacenter import (Datacenter, DCConfig, HWProfile,
                                         scale_datacenter)
from repro_torch.core.power import PowerModel, row_power
from repro_torch.core.risk import (DEFAULT_RISK_KNOBS, DEFAULT_THRESHOLDS,
                                   ReconfigureThresholds, RiskKnobs,
                                   region_risk, server_risk)
from repro_torch.core.router import BaselineRouter, RoutingPolicy, TapasRouter
from repro_torch.core.scenario import (DemandSurge, FailureEvent, Scenario,
                                       VMArrival, WeatherShift)
from repro_torch.core.simulator import (BASELINE, TAPAS, ClusterSim,
                                        CompositeControlPlane, Policy,
                                        SimConfig, SimResult,
                                        build_control_policy, run_policy)
from repro_torch.core.state import (ClusterState, ConfigChange,
                                    ControlPolicy, EndpointRoute,
                                    InstanceView)
from repro_torch.core.thermal import ThermalModel, outside_temperature

__all__ = [
    "AllocatorState", "BaselineAllocator", "TapasAllocator",
    "PlacementPolicy", "InstanceConfigurator", "ReconfigurePolicy",
    "Datacenter", "DCConfig", "HWProfile", "scale_datacenter",
    "PowerModel", "row_power", "BaselineRouter", "TapasRouter",
    "RoutingPolicy", "DEFAULT_RISK_KNOBS", "DEFAULT_THRESHOLDS",
    "ReconfigureThresholds", "RiskKnobs", "region_risk", "server_risk",
    "DemandSurge", "FailureEvent", "Scenario", "VMArrival", "WeatherShift",
    "BASELINE", "TAPAS", "ClusterSim", "CompositeControlPlane", "Policy",
    "SimConfig", "SimResult", "build_control_policy", "run_policy",
    "ClusterState", "ConfigChange", "ControlPolicy", "EndpointRoute",
    "InstanceView", "ThermalModel", "outside_temperature",
]
