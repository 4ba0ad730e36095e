"""Label plans, label statistics, selection and aggregation (mirrors
``repro.core``)."""
from .aggregation import (AGGREGATORS, Aggregator, aggregator_id,
                          block_partial_sums, get_aggregator, interpolate,
                          krum_reduce, krum_scores, make_krum,
                          make_trimmed_mean, masked_mean, median_reduce,
                          register_aggregator, registered_aggregators,
                          trimmed_mean_reduce, two_tier_weighted_mean)
from .clustering import (area_counts, area_index, cluster_counts,
                         cluster_membership, cluster_sizes,
                         greedy_area_selection, kmeans_cluster,
                         num_areas_upper_bound, selection_priority)
from .kl import kl_divergence, kl_to_uniform, uniformity_score
from .label_stats import (coverage, empirical_pdf, histogram, label_variance,
                          label_variance_normed, merge_label_statistics,
                          partial_label_statistics, rank_remap_values)
from .noniid import (CASES, MAJORITY_PER_CLIENT, MINORITY_PER_CLIENT,
                     SAMPLES_PER_CLIENT, adversary_mask, apply_availability,
                     availability_plan, bias_mix_plan, case_label_plan,
                     dirichlet_plan, flip_labels, plan_round, quantity_skew)
from .selection import (STRATEGIES, SelectionResult, get_strategy,
                        register_strategy, registered_strategies,
                        selection_budget, strategy_id, topk_by_score,
                        topn_mask)
