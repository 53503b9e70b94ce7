from .batch import (BatchResult, escalate_lanes_f64, finalize, init_batch,
                    run_batch, solve_batched)
from .multistart import (MultistartResult, perturbed_starts,
                         solve_multistart)

__all__ = ["BatchResult", "escalate_lanes_f64", "finalize", "init_batch",
           "run_batch", "solve_batched", "MultistartResult",
           "perturbed_starts", "solve_multistart"]
