"""Experiment monitors (ports ``deepspeed_tpu/monitor``)."""
