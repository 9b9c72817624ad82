"""The hand-written CUDA kernels of the port and their launch counts.

Each wrapper sends CPU tensors to its plain PyTorch version and launches
its CUDA kernel (``pyabc_tpu_torch/csrc``) on CUDA tensors. Importing this
package builds nothing: the kernels are compiled at first launch.
"""
from .aggregate import (aggregate_accept_weight,
                        aggregate_accept_weight_plain, aggregate_finish,
                        aggregate_finish_shards_plain, aggregate_refit,
                        aggregate_refit_plain)
from .bootstrap_cv import (bootstrap_bisect_plain, bootstrap_cv,
                           bootstrap_density_plain, bootstrap_draw_plain,
                           bootstrap_fit_plain, bootstrap_local_density_plain,
                           bootstrap_local_gather_plain)
from .compact import compact_round, compact_round_plain
from .gaussian_simulate import (gaussian_simulate, gaussian_simulate_plain,
                                mean_only_simulate, mean_only_simulate_plain)
from .generation_health import generation_health, generation_health_plain
from .gp_sumstat import gp_accept, gp_accept_plain, gp_values_plain
from .grid_search import (grid_search_cv, grid_search_cv_models_plain,
                          grid_search_cv_plain)
from .gp_sumstat import transform_rows as gp_transform_rows
from .gp_sumstat import transform_rows_plain as gp_transform_rows_plain
from .kernel_accept import kernel_accept, kernel_accept_plain
from .local_cov import local_cov, local_cov_plain
from .local_factor import local_factor, local_factor_plain
from .local_logpdf import (local_logpdf, local_logpdf_models_plain,
                           local_logpdf_plain)
from .linear_bound import linear_bound, linear_bound_plain
from .linear_sumstat import (linear_accept, linear_accept_plain,
                             linear_values_plain, transform_rows,
                             transform_rows_plain)
from .lv_simulate import lv_simulate, lv_simulate_plain
from .mesh_pack import (mesh_pack, mesh_pack_plain, mesh_unpack,
                        mesh_unpack_plain)
from .mlp_fit import mlp_fit, mlp_fit_plain
from .mlp_sumstat import mlp_accept, mlp_accept_plain, mlp_values_plain
from .mlp_sumstat import transform_rows as mlp_transform_rows
from .mlp_sumstat import transform_rows_plain as mlp_transform_rows_plain
from .model_step import model_step, model_step_plain
from .moments import (moment_finish, moment_finish_plain, moment_fold,
                      moment_fold_plain)
from .network_sir import network_sir, network_sir_plain
from .mvn_fit import mvn_fit, mvn_fit_plain
from .mvn_logpdf import mvn_mixture_logpdf, mvn_mixture_logpdf_plain
from .ode_family import (ode_family_segments, ode_family_segments_plain,
                         ode_family_simulate, ode_family_simulate_plain)
from .normalize_quantile import (normalize_log_weights_plain,
                                 normalize_quantile, weighted_quantile_plain)
from .pack_fetch import cast_rows_plain, pack_fetch, pack_rows_plain
from .pnorm_accept import pnorm_accept_weight, pnorm_accept_weight_plain
from .propose import (propose, propose_local, propose_local_plain,
                      propose_plain)
from .ridge_fit import ridge_fit, ridge_fit_plain
from .proposal_drift import (proposal_drift, proposal_drift_models_plain,
                             proposal_drift_plain)
from .scale_reduce import scale_reduce, scale_reduce_plain
from .segment_round import segment_round, segment_round_plain
from .shard import shard_mask, shard_mask_plain
from .sir_simulate import sir_simulate, sir_simulate_plain
from .tau_leap import tau_leap, tau_leap_plain
from .temperature_update import temperature_update, temperature_update_plain

#: every kernel wrapper, in the order of ROADMAP queue B (K2 with K1,
#: K3-K11, K12, K13, K14's draw (K2's local mode) and density, K15, K18,
#: K16, K19, K20, K20b family (unsegmented and segmented), K20b network,
#: K21a, K21b, K22 fold and finish, K25 accept and refit, K26, K23's fit,
#: transform and K18's transformed operands, K23's MLP fit and transform,
#: the GP transform, K17, K4's Gaussian simulator, K24b's shard mask, K25's
#: sharded finish, K24e's mesh pack and unpack, K4's mean-only simulator;
#: K24a, K24c and K24d are the shard and merge modes of K6, K10 and K22)
KERNELS = (propose, mvn_mixture_logpdf, lv_simulate, pnorm_accept_weight,
           compact_round, normalize_quantile, mvn_fit, scale_reduce,
           pack_fetch, generation_health, local_cov, local_factor,
           propose_local, local_logpdf, proposal_drift, bootstrap_cv,
           segment_round,
           tau_leap, sir_simulate, ode_family_simulate, ode_family_segments,
           network_sir, kernel_accept, temperature_update, moment_fold,
           moment_finish, aggregate_accept_weight, aggregate_refit,
           model_step, ridge_fit, linear_accept, linear_bound, mlp_fit,
           mlp_accept, gp_accept, grid_search_cv, gaussian_simulate,
           shard_mask, aggregate_finish, mesh_pack, mesh_unpack,
           mean_only_simulate)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        for mode in getattr(k, "mode_launches", {}):
            k.mode_launches[mode] = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def mode_launch_counts() -> dict[str, int]:
    """Launches in a kernel's modes, keyed ``"name:mode"`` (K18's
    ``adaptive``, ``k_gt_1``, ``stochastic`` and ``aggregate``, K16's six
    entries, K25's values and value-rows modes and its sharded finish,
    K24a's shard and given-rows modes, K23's transform and values entries, linear
    and MLP, the GP transform's, and LocalTransition's: K2's and K14's K >
    1 ``models`` modes, K15's, and K12's and K13's ``models`` and
    ``bootstrap`` launches, K17's K > 1 ``models`` mode); each also counts
    in ``launch_counts``."""
    return {f"{k.name}:{mode}": n for k in KERNELS
            for mode, n in getattr(k, "mode_launches", {}).items()}


__all__ = [
    "KERNELS", "aggregate_accept_weight", "aggregate_accept_weight_plain",
    "aggregate_finish", "aggregate_finish_shards_plain",
    "aggregate_refit", "aggregate_refit_plain", "bootstrap_bisect_plain",
    "bootstrap_cv",
    "bootstrap_density_plain", "bootstrap_draw_plain", "bootstrap_fit_plain",
    "bootstrap_local_density_plain", "bootstrap_local_gather_plain",
    "cast_rows_plain", "compact_round", "compact_round_plain",
    "gaussian_simulate", "gaussian_simulate_plain",
    "generation_health", "generation_health_plain", "gp_accept",
    "gp_accept_plain", "gp_transform_rows", "gp_transform_rows_plain",
    "gp_values_plain", "grid_search_cv", "grid_search_cv_models_plain",
    "grid_search_cv_plain", "kernel_accept", "mesh_pack", "mesh_pack_plain",
    "mesh_unpack", "mesh_unpack_plain",
    "kernel_accept_plain", "launch_counts", "local_cov",
    "local_cov_plain", "local_factor", "local_factor_plain", "local_logpdf",
    "local_logpdf_models_plain", "local_logpdf_plain",
    "linear_accept", "linear_accept_plain", "linear_bound",
    "linear_bound_plain", "linear_values_plain",
    "lv_simulate", "lv_simulate_plain", "mean_only_simulate",
    "mean_only_simulate_plain", "mlp_accept", "mlp_accept_plain",
    "mlp_fit", "mlp_fit_plain", "mlp_transform_rows",
    "mlp_transform_rows_plain", "mlp_values_plain", "model_step",
    "model_step_plain", "shard_mask", "shard_mask_plain",
    "mvn_fit", "mvn_fit_plain",
    "mode_launch_counts", "moment_finish", "moment_finish_plain",
    "moment_fold", "moment_fold_plain",
    "mvn_mixture_logpdf", "mvn_mixture_logpdf_plain", "network_sir",
    "network_sir_plain",
    "normalize_log_weights_plain", "normalize_quantile",
    "ode_family_segments", "ode_family_segments_plain",
    "ode_family_simulate", "ode_family_simulate_plain", "pack_fetch",
    "pack_rows_plain", "pnorm_accept_weight", "pnorm_accept_weight_plain",
    "propose", "propose_local", "propose_local_plain", "propose_plain",
    "proposal_drift", "proposal_drift_models_plain", "proposal_drift_plain",
    "reset_launch_counts",
    "ridge_fit", "ridge_fit_plain",
    "scale_reduce",
    "scale_reduce_plain", "segment_round", "segment_round_plain",
    "sir_simulate", "sir_simulate_plain", "tau_leap", "tau_leap_plain",
    "temperature_update", "temperature_update_plain", "transform_rows",
    "transform_rows_plain", "weighted_quantile_plain",
]
