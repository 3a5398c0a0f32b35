from repro_torch.models.sharding import ShardPlan, local_plan
from repro_torch.models.transformer import Model, build_model

__all__ = ["Model", "build_model", "ShardPlan", "local_plan"]
