"""Profiling, roofline accounting, quality metrics and batched transfer
(the JAX package's ``utils``)."""

import logging

from ..envconfig import env_str
from .profiling import (
    trace, Timer, ChipSpec, CHIPS, roofline, matmul_roofline, detect_chip,
    report_fraction,
)

# the port's one stdlib logger; SDNQ_TPU_LOG_LEVEL sets its level
log = logging.getLogger("sdnq_tpu_torch")
if env_str("SDNQ_TPU_LOG_LEVEL"):
    log.setLevel(env_str("SDNQ_TPU_LOG_LEVEL").upper())

__all__ = ["trace", "Timer", "ChipSpec", "CHIPS", "roofline",
           "matmul_roofline", "detect_chip", "report_fraction", "log"]
