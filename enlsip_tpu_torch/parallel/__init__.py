from .batch import (BatchResult, escalate_lanes_f64, finalize, init_batch,
                    run_batch, solve_batched)
from .hetero import FusedSuite, fuse_families, solve_suite_fused
from .multistart import (MultistartResult, perturbed_starts,
                         solve_multistart)
from .rowsharded import local_functions, row_mesh, solve_rowsharded
from .sharding import (batch_mesh, global_from_process_local, local_lanes,
                       solve_batched_sharded, solve_batched_sharded_mp)
from .suite import FamilySpec, hs_scenario_batch, solve_suite_batched

__all__ = ["BatchResult", "escalate_lanes_f64", "finalize", "init_batch",
           "run_batch", "solve_batched", "FamilySpec", "hs_scenario_batch",
           "solve_suite_batched", "FusedSuite", "fuse_families",
           "solve_suite_fused", "MultistartResult", "perturbed_starts",
           "solve_multistart", "batch_mesh", "solve_batched_sharded",
           "solve_batched_sharded_mp", "global_from_process_local",
           "local_lanes", "row_mesh", "solve_rowsharded",
           "local_functions"]
