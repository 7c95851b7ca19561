"""Launching the port's training processes: the elastic agent."""

from .agent import (PLANNED_ROLLOUT_EXIT, AgentReport,  # noqa: F401
                    ElasticAgent, classify_exit)
