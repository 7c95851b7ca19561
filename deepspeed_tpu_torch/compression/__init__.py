"""Compression: QAT, magnitude pruning, layer reduction (ports
``deepspeed_tpu/compression``)."""

from .compress import (CompressionConfig, Compressor,  # noqa: F401
                       init_compression, redundancy_clean)
