"""Scene batches: the TrafficBatch container and synthetic scenes."""

from cld_tpu_torch.data.batch import TrafficBatch, get_current_states
from cld_tpu_torch.data.synthetic import synthetic_batch

__all__ = ["TrafficBatch", "get_current_states", "synthetic_batch"]
