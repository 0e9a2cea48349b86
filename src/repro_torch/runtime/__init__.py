from .fault_tolerance import HeartbeatMonitor, ResourceView  # noqa: F401
from .straggler import SpeculationPolicy  # noqa: F401
