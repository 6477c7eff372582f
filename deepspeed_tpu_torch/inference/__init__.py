"""Inference engines of the PyTorch port."""

from .engine import DeepSpeedInferenceConfig, InferenceEngine, init_inference

__all__ = ["init_inference", "InferenceEngine", "DeepSpeedInferenceConfig"]
