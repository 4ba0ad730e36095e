from .client import local_gradient, local_train
from .loop import FLHistory, run_fl_host
from .round import client_update_step, make_fl_round, resolve_aggregator
from .workloads import (CNN_WORKLOAD, Workload, get_workload,
                        register_workload, registered_workloads)

__all__ = ["CNN_WORKLOAD", "FLHistory", "Workload", "client_update_step",
           "get_workload", "local_gradient", "local_train", "make_fl_round",
           "register_workload", "registered_workloads", "resolve_aggregator",
           "run_fl_host"]
