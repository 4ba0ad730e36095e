from .client import local_gradient, local_train
from .experiment import (ExperimentResult, ExperimentSpec, LoweredScenario,
                         ScenarioSpec, TransformSpec, availability, engines,
                         label_flip, quantity, register_engine,
                         register_transform, registered_transforms, run)
from .loop import FLHistory, run_fl, run_fl_host
from .round import (client_update_step, clustered_update_step,
                    make_fl_round, resolve_adversary, resolve_aggregator,
                    stack_global_params)
from .sim import (GridResult, GridRun, grid_arrays, run_grid, simulate,
                  stack_case_plans)
from .workloads import (CNN_WORKLOAD, Workload, get_workload,
                        register_workload, registered_workloads)

__all__ = ["CNN_WORKLOAD", "ExperimentResult", "ExperimentSpec", "FLHistory",
           "GridResult", "GridRun", "LoweredScenario", "ScenarioSpec", "TransformSpec",
           "Workload", "availability", "client_update_step",
           "clustered_update_step", "engines",
           "get_workload", "grid_arrays", "label_flip", "local_gradient",
           "local_train", "make_fl_round", "quantity", "register_engine",
           "register_transform", "register_workload",
           "registered_transforms", "registered_workloads",
           "resolve_adversary", "resolve_aggregator", "run", "run_fl",
           "run_fl_host", "run_grid", "simulate", "stack_case_plans",
           "stack_global_params"]
