"""Data pipeline (port of ``repro/data``)."""
from repro_torch.data.pipeline import DataState, SyntheticLMDataset  # noqa: F401
