from ..core import (Aggregator, register_aggregator, register_strategy,
                    registered_aggregators, registered_strategies,
                    strategy_id)
from .client import local_gradient, local_train
from .experiment import (ExperimentResult, ExperimentSpec, LoweredScenario,
                         ScenarioSpec, TransformSpec, availability,
                         engine_option_keys, engines, label_flip, quantity,
                         register_engine, register_transform,
                         registered_transforms, run)
from .loop import FLHistory, run_fl, run_fl_host, success_rate
from .population import (default_num_blocks, derive_arrival_schedule,
                         make_async_trial_fn, make_hier_trial_fn,
                         make_population_round, staleness_weight,
                         streamed_selection, synthetic_population_plan)
from .round import (client_update_step, clustered_update_step,
                    make_fl_round, resolve_adversary, resolve_aggregator,
                    stack_global_params)
from .sharded import (exchange_bytes_per_device, make_sharded_fl_round,
                      topn_mask_from_scores)
from .sim import (GridResult, GridRun, grid_arrays, run_grid, simulate,
                  stack_case_plans)
from .workloads import (CNN_WORKLOAD, LM_WORKLOAD, MICRO_LM_CONFIG, Workload,
                        get_workload, lm_workload, materialize_rows,
                        register_workload, registered_workloads)

__all__ = ["Aggregator", "CNN_WORKLOAD", "ENGINE_STRATEGIES",
           "ExperimentResult", "ExperimentSpec", "FLHistory", "GridResult",
           "GridRun", "LM_WORKLOAD", "LoweredScenario", "MICRO_LM_CONFIG",
           "ScenarioSpec", "TransformSpec", "Workload", "availability",
           "client_update_step", "clustered_update_step",
           "default_num_blocks", "derive_arrival_schedule",
           "engine_option_keys", "engines", "exchange_bytes_per_device",
           "get_workload", "grid_arrays", "label_flip", "lm_workload",
           "local_gradient", "local_train", "make_async_trial_fn",
           "make_fl_round", "make_hier_trial_fn", "make_population_round",
           "make_sharded_fl_round", "materialize_rows", "quantity",
           "register_aggregator", "register_engine", "register_strategy",
           "register_transform", "register_workload",
           "registered_aggregators", "registered_strategies",
           "registered_transforms", "registered_workloads",
           "resolve_adversary", "resolve_aggregator", "run", "run_fl",
           "run_fl_host", "run_grid", "simulate", "stack_case_plans",
           "stack_global_params", "staleness_weight", "streamed_selection",
           "strategy_id", "success_rate", "synthetic_population_plan",
           "topn_mask_from_scores"]


def __getattr__(name: str):
    # ENGINE_STRATEGIES, as in the reference, is a live view of the
    # append-only strategy registry; prefer registered_strategies().
    if name == "ENGINE_STRATEGIES":
        return registered_strategies()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
