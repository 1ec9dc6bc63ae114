"""TierScape control plane (numpy, host side): tiers, TCO model, telemetry,
placement policies, slot allocation and the manager."""

from repro_torch.core import analytical, codecs, hw, pools, tco, telemetry, tiers, waterfall
from repro_torch.core.manager import ManagerConfig, MigrationPlan, TierScapeManager, make_manager
