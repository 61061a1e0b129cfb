from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
    CheckpointEngine, LocalCheckpointEngine, TorchCheckpointEngine, get_checkpoint_engine)
from deepspeed_tpu_torch.runtime.checkpoint_engine.manifest import (MANIFEST_FILE, manifest_ok,
                                                                    verify_manifest,
                                                                    write_manifest)

__all__ = ["CheckpointEngine", "TorchCheckpointEngine", "LocalCheckpointEngine",
           "get_checkpoint_engine", "MANIFEST_FILE", "write_manifest", "verify_manifest",
           "manifest_ok"]
