from tante_tpu_torch.data.metadata import TanteMetadata

__all__ = ["TanteMetadata"]
