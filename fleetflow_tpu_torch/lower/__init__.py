"""Lowering pass: Flow -> dense constraint tensors (the port's own copy of
``fleetflow_tpu.lower``)."""

from .tensors import (LOCAL_NODE_NAME, ProblemTensors, dependency_depths,
                      local_node, lower_stage, synthetic_problem)

__all__ = ["LOCAL_NODE_NAME", "ProblemTensors", "dependency_depths",
           "local_node", "lower_stage", "synthetic_problem"]
