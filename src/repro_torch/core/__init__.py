"""TierScape control plane (numpy, host side): tiers, TCO model, telemetry,
placement policies, slot allocation, the manager, the multi-tenant budget
arbiter, the window simulator and the fleet capacity planner."""

from repro_torch.core import analytical, arbiter, capacity, codecs, hw, pools, simulator, tco, telemetry, tiers, waterfall
from repro_torch.core.arbiter import ArbiterWindowStats, BudgetArbiter, TenantSpec
from repro_torch.core.capacity import (
    CapacityPlanner,
    FleetReport,
    FrontierPoint,
    PlannerConfig,
    ServerSpec,
    get_server,
)
from repro_torch.core.manager import ManagerConfig, MigrationPlan, TierScapeManager, make_manager
from repro_torch.core.tiers import (
    BASELINE_2T,
    TierSet,
    TierSpec,
    baseline_2t_tierset,
    characterized,
    default_tierset,
    selected,
)

__all__ = [
    "analytical",
    "arbiter",
    "capacity",
    "CapacityPlanner",
    "FleetReport",
    "FrontierPoint",
    "PlannerConfig",
    "ServerSpec",
    "get_server",
    "codecs",
    "hw",
    "pools",
    "simulator",
    "tco",
    "telemetry",
    "tiers",
    "waterfall",
    "ArbiterWindowStats",
    "BudgetArbiter",
    "TenantSpec",
    "ManagerConfig",
    "MigrationPlan",
    "TierScapeManager",
    "make_manager",
    "BASELINE_2T",
    "TierSet",
    "TierSpec",
    "baseline_2t_tierset",
    "characterized",
    "default_tierset",
    "selected",
]
