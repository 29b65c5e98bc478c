from repro_torch.data.lm import SyntheticLMDataset
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.vww_synthetic import SyntheticVWW

__all__ = ["SyntheticLMDataset", "SyntheticVWW", "DataPipeline"]
