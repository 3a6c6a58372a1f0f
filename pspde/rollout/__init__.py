from .sampling import (inside_fn, sample_boundary,
                       sample_boundary_reflected, sample_domain)
from .sde import (HJBRolloutConfig, HJBRolloutOut, StoppedRolloutConfig,
                  StoppedRolloutOut, hjb_rollout, hjb_rollout_batched_grad,
                  stopped_rollout)
