"""Label plans, label statistics, selection and aggregation (mirrors
``repro.core``)."""
from .aggregation import (AGGREGATORS, BUILTIN_AGGREGATORS, Aggregator,
                          aggregator_id, all_gather_scores,
                          block_partial_sums, exchange_selected_shards,
                          fedavg_aggregate, fedsgd_aggregate,
                          gather_client_shards, get_aggregator, interpolate,
                          krum_reduce,
                          krum_scores, make_krum, make_trimmed_mean,
                          masked_mean, median_reduce, psum_aggregate,
                          psum_weighted_mean, register_aggregator,
                          registered_aggregators, trimmed_mean_reduce,
                          two_tier_weighted_mean)
from .clustering import (area_counts, area_index, cluster_counts,
                         cluster_membership, cluster_sizes,
                         greedy_area_selection, kmeans_cluster,
                         num_areas_upper_bound, selection_priority)
from .kl import kl_divergence, kl_to_uniform, uniformity_score
from .label_stats import (coverage, empirical_pdf,
                          expected_coverage_per_round, histogram,
                          label_variance, label_variance_normed,
                          merge_label_statistics, partial_label_statistics,
                          rank_remap_values)
from .noniid import (CASES, MAJORITY_PER_CLIENT, MINORITY_PER_CLIENT,
                     SAMPLES_PER_CLIENT, adversary_mask, apply_availability,
                     availability_plan, bias_mix_plan, case_label_plan,
                     dirichlet_plan, flip_labels, plan_round, quantity_skew)
from .selection import (BUILTIN_STRATEGIES, STRATEGIES, SelectionResult,
                        get_strategy, register_strategy,
                        registered_strategies, select_coverage,
                        select_entropy, select_full, select_kl,
                        select_labelwise, select_labelwise_priority,
                        select_labelwise_unnorm, select_random,
                        selection_budget, strategy_id, topk_by_score,
                        topn_mask)

__all__ = [n for n in dir() if not n.startswith("_")]
