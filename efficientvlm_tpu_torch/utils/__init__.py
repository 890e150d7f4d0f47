"""Storage, process and logging helpers (port of efficientvlm_tpu/utils/)."""

from .dist import (get_rank, get_world_size, init_distributed_mode, is_main_process,
                   setup_for_distributed)
from .logger import MetricLogger, SmoothedValue
