"""Samplers (``pyabc_tpu/sampler`` counterpart): the batched device
sampler of the per-generation host loop and the containers it fills."""
from .base import (DeviceRecords, Sample, SampleFactory, Sampler,
                   exp_normalize_log_weights)
from .batched import BatchedSampler

__all__ = ["BatchedSampler", "DeviceRecords", "Sample", "SampleFactory",
           "Sampler", "exp_normalize_log_weights"]
