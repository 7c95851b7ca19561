"""Elastic capacity planning of the port: training batch geometry
valid across accelerator counts, and the serving fleet's replica-count
policy. Ports ``deepspeed_tpu/elasticity/``."""

from .elasticity import (
    ElasticityConfig,
    ElasticityError,
    ServingElasticityConfig,
    compute_elastic_config,
    compute_serving_replicas,
    ensure_immutable_elastic_config,
    get_compatible_gpus,
    serving_replica_candidates,
)

__all__ = ["compute_elastic_config", "ensure_immutable_elastic_config",
           "get_compatible_gpus", "ElasticityConfig", "ElasticityError",
           "ServingElasticityConfig", "compute_serving_replicas",
           "serving_replica_candidates"]
