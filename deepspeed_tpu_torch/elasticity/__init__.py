"""Elastic training (counterpart of ``deepspeed_tpu/elasticity/``): the
batch solver (``elasticity.py``) and the agent that supervises the workers
(``elastic_agent.py``)."""
from deepspeed_tpu_torch.elasticity.elasticity import (ElasticityConfig, ElasticityConfigError,
                                                       ElasticityError,
                                                       ElasticityIncompatibleWorldSize,
                                                       compute_elastic_config,
                                                       elasticity_enabled)
