"""The placement solver on PyTorch and CUDA (port of ``fleetflow_tpu.solver``).

Greedy seeding plus simulated annealing over dense constraint tensors on
the card. The package exports every name of the reference's package that
has a counterpart here; ``TorchProblem`` stands where the reference has
``DeviceProblem``. JAX's mesh axis name (``CHAIN_AXIS``), compile-arena
statistics (``staging_arena_stats``) and transfer guard
(``transfer_guard_ctx``) have none. ``anneal`` stays the submodule (its
``anneal.anneal`` is the function the reference's package exports under
that name): the port's callers import the module (ROADMAP, deliberate
differences).
"""

from .anneal import chain_states_from_assignment, prerepair_state
from .buckets import (BucketConfig, BucketInfo, bucket_config, bucket_size,
                      pad_problem_tiers, stage_problem_tiers, subsolve_tier)
from .resident import ProblemDelta, ResidentProblem
from .subsolve import (ActiveIndex, ActivePlan, SubsolveConfig, plan_active,
                       subsolve_config)
from .sharded import SVC_AXIS, anneal_sharded, pad_problem, shard_problem
from .api import SolveResult, make_chain_inits, solve
from .greedy import greedy_place, greedy_place_batched, placement_order
from .kernels import (node_loads, soft_score, total_cost, total_violations,
                      violation_stats)
from .problem import TorchProblem, prepare_problem
from .repair import RepairResult, repair, soft_score_host, verify

__all__ = ["chain_states_from_assignment", "prerepair_state",
           "BucketConfig", "BucketInfo", "bucket_config", "bucket_size",
           "pad_problem_tiers", "soft_score_host", "stage_problem_tiers",
           "subsolve_tier", "ProblemDelta", "ResidentProblem",
           "ActiveIndex", "ActivePlan", "SubsolveConfig", "plan_active",
           "subsolve_config", "SVC_AXIS", "anneal_sharded", "pad_problem",
           "shard_problem", "SolveResult", "make_chain_inits", "solve",
           "greedy_place", "greedy_place_batched", "placement_order",
           "node_loads", "soft_score", "total_cost", "total_violations",
           "violation_stats", "TorchProblem", "prepare_problem",
           "RepairResult", "repair", "verify"]
