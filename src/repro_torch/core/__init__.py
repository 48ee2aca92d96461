from .policies import POLICIES
from .power import ORIN_POWER_MODES, PowerMode, PowerModePolicy, dynamic_policy

__all__ = ["POLICIES", "ORIN_POWER_MODES", "PowerMode", "PowerModePolicy", "dynamic_policy"]
