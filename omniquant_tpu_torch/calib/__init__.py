from .engine import CalibConfig, calibrate
from .act_stats import collect_act_stats
from .data import get_loaders, get_synthetic, sample_windows
