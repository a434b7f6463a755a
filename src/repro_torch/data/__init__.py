from .pipeline import PipelineState, TokenPipeline

__all__ = ["PipelineState", "TokenPipeline"]
