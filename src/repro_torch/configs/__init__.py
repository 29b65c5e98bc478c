"""Model configurations of the port (the paper's P²M-VWW model)."""
