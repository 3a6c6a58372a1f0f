from .estimator_stats import loss_estimator_statistics, relative_error
from .gradient_variance import gradient_variances
from .importance_sampling import (do_importance_sampling,
                                  do_importance_sampling_Wei,
                                  make_is_runner,
                                  do_importance_sampling_me,
                                  importance_sampling)
from .plotting import (load_exp_logs, plot_control_for_DoubleWell1d,
                       plot_loss_logs, plot_loss_logs_extended,
                       plot_moving_average, plot_path_ensemble,
                       plot_solution, save_exp_logs)
from .test_error import compute_test_error
from .refine import RefinedValue, feynman_kac_refine  # noqa: F401,E402
from .picard import (picard_refine,  # noqa: F401,E402
                     picard_refine_elliptic)
from .refine import feynman_kac_refine_elliptic  # noqa: F401,E402
from .eigen_power import (eigen_power_refine,  # noqa: F401,E402
                          eigen_subspace_refine,
                          fk_semigroup_targets)
