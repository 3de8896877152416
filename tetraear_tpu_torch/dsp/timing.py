"""Timing-recovery constants (tetraear_tpu/dsp/timing.py).

The fused back half does the Oerder-Meyr timing glue itself
(dsp/backhalf.py); only the constants are shared here.
"""

TAIL = 4                       # carried samples for cubic interpolation
