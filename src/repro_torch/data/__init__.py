from .pipeline import DataConfig, SyntheticLM, host_shard
__all__ = ["DataConfig", "SyntheticLM", "host_shard"]
