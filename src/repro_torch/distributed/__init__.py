"""Distribution: logical-axis sharding rules, their mesh placements, and the
constraint scope the model code reads (torch port of ``repro.distributed``)."""
from repro_torch.distributed.constraints import axis_rules, constrain, logical_to_spec

__all__ = ["axis_rules", "constrain", "logical_to_spec"]
