"""Label plans, label statistics, selection and aggregation (mirrors
``repro.core``)."""
from .aggregation import (AGGREGATORS, Aggregator, aggregator_id,
                          get_aggregator, interpolate, masked_mean,
                          register_aggregator, registered_aggregators)
from .clustering import area_index, selection_priority
from .kl import kl_divergence, kl_to_uniform, uniformity_score
from .label_stats import (coverage, empirical_pdf, histogram, label_variance,
                          label_variance_normed, rank_remap_values)
from .noniid import (CASES, MAJORITY_PER_CLIENT, MINORITY_PER_CLIENT,
                     SAMPLES_PER_CLIENT, adversary_mask, apply_availability,
                     availability_plan, bias_mix_plan, case_label_plan,
                     dirichlet_plan, flip_labels, plan_round, quantity_skew)
from .selection import (STRATEGIES, SelectionResult, get_strategy,
                        register_strategy, registered_strategies,
                        selection_budget, strategy_id, topn_mask)
