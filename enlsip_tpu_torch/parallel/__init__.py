from .batch import (BatchResult, escalate_lanes_f64, finalize, init_batch,
                    run_batch, solve_batched)
from .hetero import FusedSuite, fuse_families, solve_suite_fused
from .multistart import (MultistartResult, perturbed_starts,
                         solve_multistart)
from .suite import FamilySpec, hs_scenario_batch, solve_suite_batched

__all__ = ["BatchResult", "escalate_lanes_f64", "finalize", "init_batch",
           "run_batch", "solve_batched", "FamilySpec", "hs_scenario_batch",
           "solve_suite_batched", "FusedSuite", "fuse_families",
           "solve_suite_fused", "MultistartResult", "perturbed_starts",
           "solve_multistart"]
