"""Session backends: ``backend='cuda'`` digest session ends."""

from .cuda_backend import CudaDecoder, CudaEncoder, DigestPipeline

__all__ = ["CudaDecoder", "CudaEncoder", "DigestPipeline"]
