from repro_torch.data.vww_synthetic import SyntheticVWW

__all__ = ["SyntheticVWW"]
