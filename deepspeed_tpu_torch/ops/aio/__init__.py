from deepspeed_tpu_torch.ops.aio.aio_handle import AIOBuildError, AIOHandle, AsyncIOBuilder

__all__ = ["AIOBuildError", "AIOHandle", "AsyncIOBuilder"]
