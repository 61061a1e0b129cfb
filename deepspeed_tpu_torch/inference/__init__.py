from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine, init_inference

__all__ = ["DeepSpeedInferenceConfig", "InferenceEngine", "init_inference"]
