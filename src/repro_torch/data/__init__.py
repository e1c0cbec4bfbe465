from .pipeline import DataConfig, SyntheticLM
