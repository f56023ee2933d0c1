"""repro_torch.fed — federated client–server simulation with heterogeneous
budgets (port of `repro.fed`, without its mesh backend).

Per-client bit budgets R_i, partial participation, stragglers, error
feedback on params-deltas, and a per-round wire-bytes ledger equal to the
analytic audit to the byte. Clients sharing a (codec spec, client config,
data signature) run as one cohort of lanes, one kernel launch per leaf.

    from repro_torch import codecs
    from repro_torch.fed import Federation, FedConfig, ClientConfig

    codec = codecs.make("ndsc", budget=2.0, chunk=128)
    fed = Federation(loss_fn, params, shards, codec)      # on cuda
    history = fed.run(FedConfig(num_rounds=50), eval_fn=global_loss)
"""
from repro_torch.codecs import TreeCodec, available, codec_spec, make
from repro_torch.fed import budget, registry
from repro_torch.fed.budget import AdaptiveConfig, NormEMA
from repro_torch.fed.clients import (ClientConfig, ClientState, concat_stacks,
                                     data_signature, init_client_state,
                                     local_sgd, make_client_round,
                                     make_cohort_round, stack_padded,
                                     stack_trees, unstack_tree)
from repro_torch.fed.rounds import (BACKENDS, FedConfig, Federation,
                                    cohort_key, partition_cohorts)
from repro_torch.fed.server import (AGGREGATORS, SUM_MODES, ServerConfig,
                                    ServerState, aggregate, aggregate_stacked,
                                    decode_deltas, delta_norms, init_server,
                                    stacked_norms, tree_norm)

__all__ = [
    "AGGREGATORS", "AdaptiveConfig", "BACKENDS", "ClientConfig",
    "ClientState", "FedConfig", "Federation", "NormEMA", "SUM_MODES",
    "ServerConfig", "ServerState", "TreeCodec", "aggregate",
    "aggregate_stacked", "available", "budget", "codec_spec", "cohort_key",
    "concat_stacks", "data_signature", "decode_deltas", "delta_norms",
    "init_client_state", "init_server", "local_sgd", "make",
    "make_client_round", "make_cohort_round", "partition_cohorts",
    "registry", "stack_padded", "stack_trees", "stacked_norms", "tree_norm",
    "unstack_tree",
]
