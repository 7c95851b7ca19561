"""Profiling: the FLOPs profiler (ports ``deepspeed_tpu/profiling``)."""

from .flops_profiler import (FlopsProfiler, ProfileResult,  # noqa: F401
                             count_params, flops_of, get_model_profile)
